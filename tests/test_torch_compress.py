"""The port's compression against the JAX package on the same inputs.

* ``kernels/ref.py``: the plain quantize, dequantize and top-k mask
  against ``repro/kernels/ref.py`` — codes, reconstructions and masks
  **exact** (levels 127 and 7, all-zero rows, ragged and empty rows).  The
  quantize oracle runs under ``jax.jit``, where XLA contracts its
  multiply-add into one fused multiply-add, as the port's kernel and its
  plain version compute it.
* ``compress.py``: ``apply_compression``, ``compress_activations``,
  ``topk_threshold``, ``compressed_stage_bytes`` and
  ``activation_wire_bytes`` against ``repro.compress`` on shared inputs
  and shared uniform draws — **exact**.  The Pallas kernels cannot run
  here (jax 0.9.0 lacks ``pltpu.TPUCompilerParams``), so the JAX ops are
  patched to their oracles for the test only; ``repro.compress`` runs
  eagerly, one rounding per op, as the port's code reads.
* Error-feedback invariants: top-k conserves the update mass exactly
  (inputs on a 2^-10 grid, so every sum is exact); a masked client keeps
  its residual bit for bit; stochastic quantization is unbiased within a
  CLT band.
* ``core/protocol.py``: ``compressed_update_bytes`` and ``CommLog``
  against the JAX package.
* The round: the selection stream is untouched by compression (masks and
  the selection generator equal with it on and off), and ``_bridge``
  round-trips ``ef_residual``.

The compressed rounds against the live JAX round are in
``tests/test_torch_round.py``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import compress as jC
from repro.config import CompressionConfig as JCompressionConfig
from repro.core import protocol as jprotocol
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import compress as C
from repro_torch.config import (CompressionConfig, ModelConfig, TrainConfig,
                                WSSLConfig)
from repro_torch.core import protocol
from repro_torch.core.round import init_state, make_round_fn
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import compress as kcomp
from repro_torch.kernels import ops, ref

SCHEMES = ["topk", "int8", "int4"]

# the JAX ops patched to their oracles; the quantizer jitted, as XLA
# compiles it inside a jitted round
ORACLES = {"quantize_stochastic": jax.jit(jref.quantize_stochastic_2d),
           "dequantize": jref.dequantize_2d,
           "topk_mask": jref.topk_mask_2d}


def _oracles():
    return mock.patch.multiple(jops, **ORACLES)


def _t(a):
    return torch.as_tensor(np.array(a))


def _quant_inputs(n, m, levels, seed, zero_row=None):
    rng = np.random.default_rng(seed)
    # magnitudes over several decades, so x * inv_step + u lands on and
    # near integer boundaries at every scale
    x = (rng.normal(size=(n, m)) * rng.choice([1e-6, 1e-3, 1.0, 30.0],
                                              size=(n, m))).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    u = rng.random(size=(n, m), dtype=np.float32)
    scale = np.abs(x).max(axis=1) if m else np.zeros(n, np.float32)
    lv = np.float32(levels)
    with np.errstate(divide="ignore"):
        inv = np.where(scale > 0, lv / scale, 0.0).astype(np.float32)
        step = np.where(scale > 0, scale / lv, 0.0).astype(np.float32)
    return x, u, inv, step


# (n, m, levels, all-zero row): ragged widths, both level counts, m = 0
KERNEL_CASES = [(3, 200_003, 127.0, 1), (3, 200_003, 7.0, None),
                (2, 1, 127.0, None), (4, 1003, 7.0, 3), (2, 0, 127.0, None),
                (1, 4096, 127.0, 0)]


@pytest.mark.parametrize("n,m,levels,zero_row", KERNEL_CASES)
def test_plain_quantize_dequantize_match_jax_oracle(n, m, levels, zero_row):
    x, u, inv, step = _quant_inputs(n, m, levels, seed=m + n, zero_row=zero_row)
    want = np.asarray(ORACLES["quantize_stochastic"](x, u, inv,
                                                     np.float32(levels)))
    got = ref.quantize_stochastic_2d(_t(x), _t(u), _t(inv), levels)
    assert got.dtype == torch.int8 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= levels if m else True
    if zero_row is not None:
        assert not got[zero_row].any()
    deq = ref.dequantize_2d(got, _t(step))
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jref.dequantize_2d(want, step)))
    # the CPU dispatch is the plain version, and launches nothing
    ops.reset_launch_counts()
    assert torch.equal(ops.quantize_stochastic(_t(x), _t(u), _t(inv), levels),
                       got)
    assert torch.equal(ops.dequantize(got, _t(step)), deq)
    assert not any(ops.launch_counts().values())


def test_single_rounding_matters():
    """Rounding the product before the add moves codes: sums planted just
    under an integer, where the product's own rounding error can push a
    separately rounded sum over it.  The plain version rounds once and
    matches the oracle on every one; rounding twice misses many."""
    rng = np.random.default_rng(5)
    inv = np.array([1.0339], np.float32)
    x = rng.uniform(0.5, 0.9, size=(1, 4096)).astype(np.float32)
    p = x.astype(np.float64) * inv.astype(np.float64)[:, None]
    u = (1.0 - p - 2.0 ** -25 - 2.0 ** -27).astype(np.float32)
    want = np.asarray(ORACLES["quantize_stochastic"](x, u, inv,
                                                     np.float32(127.0)))
    twice = np.floor((x * inv[:, None]).astype(np.float32) + u)
    got = ref.quantize_stochastic_2d(_t(x), _t(u), _t(inv), 127.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (twice != want).sum() > 1000


@pytest.mark.parametrize("n,m,zero_thresh", [(3, 200_003, False),
                                             (4, 1003, True), (2, 0, False)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_plain_topk_mask_matches_jax_oracle(n, m, zero_thresh, dtype):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(n, m)).astype(np.float32)
    x[:, ::7] = 0.0                            # zeros at a zero threshold
    t = np.abs(rng.normal(size=(n,))).astype(np.float32)
    if zero_thresh:
        t[1] = 0.0
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = _t(x).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    want = np.asarray(jref.topk_mask_2d(jx, t), np.float32)
    got = ref.topk_mask_2d(tx, _t(t))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if dtype == np.float32:
        assert torch.equal(ops.topk_mask(tx, _t(t)), got)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kcomp.quantize_stochastic_2d(x, x, torch.zeros(2), 127.0)
    with pytest.raises(ValueError, match="CUDA"):
        kcomp.dequantize_2d(x.to(torch.int8), torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        kcomp.topk_mask_2d(x, torch.zeros(2))
    with pytest.raises(ValueError, match="2-d"):
        kcomp.topk_mask_2d(torch.zeros(8), torch.zeros(2))
    with pytest.raises(ValueError, match="int8"):
        kcomp.dequantize_2d(x, torch.zeros(2))
    assert (kcomp.quantize_launches, kcomp.dequantize_launches,
            kcomp.topk_launches) == (0, 0, 0)


# ---------------------------------------------------------------------------
# compress.py against repro.compress
# ---------------------------------------------------------------------------


def _cfgs(scheme, **kw):
    return JCompressionConfig(scheme=scheme, **kw), CompressionConfig(
        scheme=scheme, **kw)


@pytest.mark.parametrize("m", [1, 7, 10, 30, 95, 150, 1000, 1023])
@pytest.mark.parametrize("rate", [0.05, 0.07, 0.3, 1.0])
def test_topk_threshold_matches_jax(m, rate):
    x = np.random.default_rng(m).normal(size=(3, m)).astype(np.float32)
    x[1, : m // 2] = x[1, 0]                  # ties
    want = np.asarray(jC.topk_threshold(jnp.asarray(x), rate))
    got = C.topk_threshold(_t(x), C.compression_params(
        CompressionConfig(scheme="topk", rate=rate)).rate)
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_count_is_fp32():
    """k = round(rate * m) in fp32: at rate 0.3 and m = 95 the fp32
    product rounds to 28.5 + and keeps 29, where float64 keeps 28."""
    assert C.topk_count(95, 0.3) == 29.0 == float(
        jC.compressed_stage_bytes({"a": jnp.zeros((1, 95))}, 1,
                                  JCompressionConfig(scheme="topk",
                                                     rate=0.3))) / 8
    assert round(0.3 * 95) == 28
    assert C.topk_count(10, 0.05) == 1.0           # 0.5 -> 0, clipped to 1


def _tree(n, rng):
    return {"w": rng.normal(size=(n, 5, 7)).astype(np.float32),
            "b": [rng.normal(size=(n, 33)).astype(np.float32)],
            "a": {"z": rng.normal(size=(n, 3, 2)).astype(np.float32),
                  "e": np.zeros((n, 0), np.float32)}}


def _torch_tree(tree):
    """numpy tree -> tensor tree, keeping the dicts' key order."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return _t(tree)


def _jax_draws(key, tree):
    """Each leaf's uniform draw as the JAX code draws it (leaf order)."""
    return [np.asarray(jax.random.uniform(
        jax.random.fold_in(key, i), (l.shape[0], l[0].size), jnp.float32))
        for i, l in enumerate(jax.tree.leaves(tree))]


@pytest.mark.parametrize("scheme,rate", [("topk", 0.05), ("topk", 0.3),
                                         ("int8", 0.05), ("int4", 0.05)])
@pytest.mark.parametrize("ef", [True, False])
def test_apply_compression_matches_jax(scheme, ef, rate):
    rng = np.random.default_rng(3)
    n = 3
    delta = _tree(n, rng)
    res = jax.tree.map(lambda a: (0.3 * a).astype(np.float32), _tree(n, rng))
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    key = jax.random.PRNGKey(9)
    jcfg, cfg = _cfgs(scheme, rate=rate, error_feedback=ef)
    with _oracles():
        jsent, jres = jC.apply_compression(
            jax.tree.map(jnp.asarray, delta),
            jax.tree.map(jnp.asarray, res) if ef else (), jnp.asarray(mask),
            key, jcfg)
    us = [_t(u) for u in _jax_draws(key, delta)]
    tdelta, tres = _torch_tree(delta), _torch_tree(res) if ef else ()
    before = [t.clone() for t in C.tree_leaves(tres)]
    sent, new_res = C.apply_compression(tdelta, tres, _t(mask), cfg,
                                        u=us if scheme != "topk" else None)
    assert list(sent) == list(delta) and list(sent["a"]) == ["z", "e"]
    for a, b in zip(C.tree_leaves(sent), jax.tree.leaves(jsent)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not a[1].any()                       # masked client sends 0
    if ef:
        for a, b, r0 in zip(C.tree_leaves(new_res), jax.tree.leaves(jres),
                            before):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert torch.equal(a[1], r0[1])          # masked client keeps e
    else:
        assert new_res == ()
    # the inputs are untouched
    for a, b in zip(C.tree_leaves(tres), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_activations_matches_jax(scheme, dtype):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    a[0, 1, 2] = 0.0                              # an all-zero row
    key = jax.random.PRNGKey(4)
    jcfg, cfg = _cfgs(scheme, rate=0.1, activations=True)
    ja = jnp.asarray(a, getattr(jnp, dtype))
    with _oracles():
        want = jC.compress_activations(ja, key, jcfg)
    u = np.asarray(jax.random.uniform(key, (30, 16), jnp.float32))
    ta = _t(a).to(getattr(torch, dtype))
    got = C.compress_activations(ta, cfg, u=_t(u) if scheme != "topk"
                                 else None)
    assert got.dtype == ta.dtype and got.shape == ta.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert C.compress_activations(ta, CompressionConfig()) is ta
    # without u, the draw comes from the generator given
    a1, a2 = (C.compress_activations(ta, cfg, generator=torch.Generator(
        ).manual_seed(3)) for _ in range(2))
    assert torch.equal(a1, a2) and a1.shape == ta.shape


@pytest.mark.parametrize("scheme", ["none"] + SCHEMES)
@pytest.mark.parametrize("rate", [0.05, 0.37])
def test_byte_counts_match_jax(scheme, rate):
    n = 4
    shapes = {"a": (n, 8, 16), "b": (n, 33), "c": (n, 0), "d": (n, 1),
              "e": (n, 3, 3, 7)}
    jstack = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    tstack = {k: torch.zeros(s) for k, s in shapes.items()}
    jcfg, cfg = _cfgs(scheme, rate=rate)
    want = float(jC.compressed_stage_bytes(jstack, n, jcfg))
    assert C.compressed_stage_bytes(tstack, cfg) == want
    per_client = {k: np.zeros(s[1:], np.float32) for k, s in shapes.items()}
    assert (protocol.compressed_update_bytes(tstack, scheme, rate, n)
            == protocol.compressed_update_bytes(per_client, scheme, rate)
            == jprotocol.compressed_update_bytes(per_client, scheme, rate)
            == want)
    for rows, d in ((1, 1), (32, 16), (256, 2048), (7, 33)):
        assert C.activation_wire_bytes(rows, d, cfg) == float(
            jC.activation_wire_bytes(rows, d, jcfg))


def test_compression_params_match_jax():
    for scheme in ["none"] + SCHEMES:
        jcfg, cfg = _cfgs(scheme, rate=0.07)
        want = jC.compression_params(jcfg)
        got = C.compression_params(cfg)
        assert got == tuple(float(v) for v in want)


def test_commlog_matches_jax():
    log, jlog = protocol.CommLog(), jprotocol.CommLog()
    for r in range(3):
        kw = dict(bytes_sync=300 + r, bytes_per_hop=(10, 20 + r),
                  bytes_update_raw=1000, bytes_update_comp=250 + r,
                  bytes_act_raw=64, bytes_act_comp=16 + r)
        log.record(r, 2, 30, 30, **kw)
        jlog.record(r, 2, 30, 30, **kw)
    assert log.rounds == [protocol.RoundComm(**vars(x)) for x in jlog.rounds]
    assert log.summary() == jlog.summary()
    assert log.summary()["update_compression_ratio"] == 1000 * 3 / 753


# ---------------------------------------------------------------------------
# error-feedback invariants
# ---------------------------------------------------------------------------


def test_topk_error_feedback_conserves_the_update_mass_exactly():
    """sum_t sent_t + e_T == sum_t delta_t, exactly: with deltas on a 2^-10
    grid every fp32 sum here is exact, so the wire plus the residual
    carry the whole update; the masked client sends 0 and keeps 0."""
    rng = np.random.default_rng(5)
    cfg = CompressionConfig(scheme="topk", rate=0.1)
    shapes = {"a": (4, 8, 16), "b": (4, 33)}
    res = C.init_ef_residual({k: torch.zeros(s) for k, s in shapes.items()})
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0])
    total_d = {k: np.zeros(s) for k, s in shapes.items()}
    total_s = {k: np.zeros(s) for k, s in shapes.items()}
    for _ in range(6):
        delta = {k: torch.as_tensor(rng.integers(-64, 65, size=s) / 1024.0,
                                    dtype=torch.float32)
                 for k, s in shapes.items()}
        sent, res = C.apply_compression(delta, res, mask, cfg)
        for k, s in shapes.items():
            on = (mask.numpy() > 0).reshape((-1,) + (1,) * (len(s) - 1))
            total_d[k] += delta[k].double().numpy() * on
            total_s[k] += sent[k].double().numpy()
    for k in shapes:
        np.testing.assert_array_equal(total_s[k] + res[k].double().numpy(),
                                      total_d[k])
        assert not total_s[k][2].any() and not res[k][2].any()
        assert res[k][0].abs().sum() > 0


def test_masked_client_keeps_its_residual():
    rng = np.random.default_rng(6)
    for scheme in SCHEMES:
        cfg = CompressionConfig(scheme=scheme, rate=0.1)
        delta = {"a": _t(rng.normal(size=(3, 64)).astype(np.float32))}
        res = {"a": _t(rng.normal(size=(3, 64)).astype(np.float32))}
        r0 = res["a"].clone()
        sent, new = C.apply_compression(
            delta, res, torch.tensor([1.0, 0.0, 1.0]), cfg,
            generator=torch.Generator().manual_seed(0))
        assert torch.equal(new["a"][1], r0[1])
        assert not sent["a"][1].any()
        assert not torch.equal(new["a"][0], r0[0])


def test_stochastic_quantization_is_unbiased():
    """E[deq(q(x))] = x over the draws: the mean over 400 draws of int4
    within 1.5 (mean) and 6 (max) standard errors step / sqrt(12 * 400)."""
    cfg = CompressionConfig(scheme="int4", error_feedback=False)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 256)),
                        dtype=torch.float32)
    gen = torch.Generator().manual_seed(11)
    trials = 400
    acc = torch.zeros((2, 256), dtype=torch.float64)
    for _ in range(trials):
        sent, _ = C.apply_compression({"a": x}, (), torch.ones(2), cfg,
                                      generator=gen)
        acc += sent["a"].double()
    step = x.abs().max().item() / 7.0
    bias = (acc / trials - x.double()).abs()
    se = step / np.sqrt(12 * trials)
    assert bias.mean().item() < 1.5 * se
    assert bias.max().item() < 6.0 * se


def test_scheme_none_is_the_identity():
    delta = {"a": torch.randn(4, 16)}
    sent, res = C.apply_compression(delta, (), torch.ones(4),
                                    CompressionConfig())
    assert sent is delta and res == ()


# ---------------------------------------------------------------------------
# the round: the selection stream, the residual, the bridge
# ---------------------------------------------------------------------------

TINY_KW = dict(name="tiny-comp", num_layers=3, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")


def _run(comp, rounds=3, validate=True):
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(num_clients=4, participation_fraction=0.5,
                   split_layers=(1, 2), compression=comp)
    t = TrainConfig(**TRAIN_KW)
    state = init_state(torch.Generator().manual_seed(0), cfg, w, t,
                       device="cpu")
    rf = make_round_fn(cfg, w, t, impl="dense")
    val = {k: torch.as_tensor(v) for k, v in lm_batch(4, 16, 64,
                                                      seed=999).items()}
    out = []
    for r in range(rounds):
        d = lm_batch(8, 16, 64, seed=r)
        batch = {k: torch.as_tensor(v).reshape(4, 2, 16) for k, v in d.items()}
        res0 = [t.clone() for t in C.tree_leaves(state.ef_residual)]
        _, m = rf(state, batch, val if validate else None)
        out.append((m, state.rng.get_state().clone(), res0))
    return state, out


@functools.lru_cache(maxsize=None)
def _uncompressed(validate):
    """The uncompressed run every scheme's case compares with, run once
    per module (``_run`` is deterministic: see
    ``test_default_draws_are_reproducible_and_differ_by_round``)."""
    return _run(CompressionConfig(), validate=validate)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compression_leaves_the_selection_stream_untouched(scheme):
    """The selection generator moves exactly as without compression.  With
    validation the importance (and so a later mask) may follow the
    compressed model; without it the importance stays uniform and every
    mask must be the uncompressed run's."""
    comp_cfg = CompressionConfig(scheme=scheme, activations=True)
    for validate in (False, True):
        _, base = _uncompressed(validate)
        state, comp = _run(comp_cfg, validate=validate)
        for (mb, gb, _), (mc, gc, _) in zip(base, comp):
            assert torch.equal(gb, gc)
            if not validate:
                assert torch.equal(mb.mask, mc.mask)
        assert torch.equal(base[0][0].mask, comp[0][0].mask)
    # the round's residuals: zero before round 0, a participant's non-zero
    # after it, a masked client's unchanged by the round that masked it
    assert all(not r.any() for r in comp[0][2])
    for r in (1, 2):
        m, _, before = comp[r]
        after = comp[r + 1][2] if r + 1 < len(comp) else C.tree_leaves(
            state.ef_residual)
        on, off = int(m.mask.argmax()), int(m.mask.argmin())
        assert m.mask[off] == 0
        assert all(torch.equal(a[off], b[off]) for a, b in zip(after, before))
        assert any(a[on].any() for a in after)
    assert float(comp[-1][0].bytes_update_comp) < float(
        comp[-1][0].bytes_update_raw)


def test_default_draws_are_reproducible_and_differ_by_round():
    a, ra = _run(CompressionConfig(scheme="int8", activations=True), rounds=2)
    b, rb = _run(CompressionConfig(scheme="int8", activations=True), rounds=2)
    for x, y in zip(C.tree_leaves(a.ef_residual), C.tree_leaves(b.ef_residual)):
        assert torch.equal(x, y)
    assert float(ra[1][0].loss) == float(rb[1][0].loss)


def test_init_state_allocates_the_residual():
    cfg = ModelConfig(**TINY_KW)
    t = TrainConfig(**TRAIN_KW)
    for comp, want in ((CompressionConfig(), False),
                       (CompressionConfig(scheme="int8"), True),
                       (CompressionConfig(scheme="topk",
                                          error_feedback=False), False)):
        state = init_state(torch.Generator().manual_seed(0), cfg,
                           WSSLConfig(num_clients=2, compression=comp), t,
                           device="cpu")
        res = C.tree_leaves(state.ef_residual)
        assert bool(res) == want
        if want:
            stack = C.tree_leaves(state.client_stack)
            assert [r.shape for r in res] == [s.shape for s in stack]
            assert all(r.dtype == torch.float32 and not r.any() for r in res)


def test_bridge_roundtrips_the_residual():
    from repro.config import ModelConfig as JModelConfig
    from repro.config import TrainConfig as JTrainConfig
    from repro.config import WSSLConfig as JWSSLConfig
    from repro.core.round import init_state as jax_init_state
    from repro_torch._bridge import state_from_jax, state_to_numpy
    jm = JModelConfig(**TINY_KW)
    w = JWSSLConfig(num_clients=2, split_layers=(1, 2),
                    compression=JCompressionConfig(scheme="int4"))
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w,
                              JTrainConfig(**TRAIN_KW))
    rng = np.random.default_rng(1)
    res = jax.tree.map(lambda l: rng.normal(size=l.shape).astype(np.float32),
                       state.ef_residual)
    np_state = jax.tree.map(np.asarray, state._replace(ef_residual=res))
    ts = state_from_jax(np_state, ModelConfig(**TINY_KW), device="cpu")
    got = state_to_numpy(ts)["ef_residual"]
    a, b = jax.tree.leaves(got), jax.tree.leaves(res)
    assert len(a) == len(b) == len(jax.tree.leaves(state.client_stack))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert [t.dtype for t in C.tree_leaves(ts.ef_residual)] == [
        torch.float32] * len(a)
    none = jax.tree.map(np.asarray, state._replace(ef_residual=()))
    ts0 = state_from_jax(none, ModelConfig(**TINY_KW), device="cpu")
    assert ts0.ef_residual == () and state_to_numpy(ts0)["ef_residual"] == ()
