"""StableLM-2-12B and Qwen2.5-32B in the port against the JAX package: the
pieces they add to the dense transformer (LayerNorm, qkv biases, MLP
biases), the whole model paths, one WSSL round, and init and bridge.

JAX initialises every bias to zero and LayerNorm's scale to one, where a
bias applied wrongly (or not at all) changes nothing.  So each test adds
seeded numpy noise to every ``bias``, ``scale``, ``bq``, ``bk``, ``bv``,
``bu`` and ``bd`` leaf on the JAX side before bridging.

Configs: ``reduced()`` of each (head_dim 64, one query head per kv head),
which hides both new attention shapes, so two more: StableLM's head_dim
160 with ``rope_fraction`` 0.25 at 8 query heads over 2 (g 4), and Qwen
at 10 over 2 (g 5); plus StableLM with ``mlp_bias`` (no config sets it).

Bands: fp32 logits atol = rtol = 1e-4 (the same ops, other summation
orders); bf16 atol = rtol = 5e-2 (both round the logits to bf16); greedy
tokens in fp32 equal.  LayerNorm alone: fp32 within 1e-6, bf16 within one
bf16 ulp.  The round: ``tests/test_torch_round.py``'s bands (masks and
byte counts exact; losses, importance rel 1e-5; stages max |diff| 2 lr,
mean 1e-7, 99.9th percentile 1e-6; moments atol 1e-6).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro_torch import _bridge
from repro_torch._bridge import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.config import TrainConfig, WSSLConfig, get_arch, reduced
from repro_torch.core.round import make_round_fn
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine
from repro_torch.tree import tree_leaves

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)
ARCHS = ("stablelm-12b", "qwen2.5-32b")
NEW_LEAVES = ("bias", "scale", "bq", "bk", "bv", "bu", "bd")
LR = 1e-3
TRAIN_KW = dict(remat=False, learning_rate=LR, warmup_steps=0,
                schedule="constant")

# name: (arch, replace() overrides of the reduced config)
CONFIGS = {
    "stablelm": ("stablelm-12b", {}),
    "qwen": ("qwen2.5-32b", {}),
    "stablelm-hd160-g4": ("stablelm-12b", dict(num_heads=8, num_kv_heads=2,
                                               head_dim=160)),
    "qwen-g5": ("qwen2.5-32b", dict(num_heads=10, num_kv_heads=2)),
    "stablelm-mlp-bias": ("stablelm-12b", dict(mlp_bias=True)),
}


def _cfgs(name, dtype="float32"):
    arch, over = CONFIGS[name]
    cfg = reduced(get_arch(arch)).replace(dtype=dtype, **over)
    jcfg = jax_reduced(jax_get_arch(arch)).replace(dtype=dtype, **over)
    return cfg, jcfg


def perturb(tree, seed, scale=0.5):
    """``tree`` (JAX arrays) with seeded normal noise added to every leaf
    named in NEW_LEAVES, so biases and norm params are away from init."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if getattr(path[-1], "key", None) in NEW_LEAVES:
            noise = rng.normal(0.0, scale, x.shape).astype(np.float32)
            return x + jnp.asarray(noise, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _setup(name, dtype="float32"):
    cfg, jcfg = _cfgs(name, dtype)
    jp = jax.jit(lambda key: jtf.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(1))
    jp = perturb(jp, seed=len(name))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, init and bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    norm = 2 * d if cfg.norm == "layernorm" else d
    layer = (d * hd * (2 * h + 2 * kv) + 3 * d * f + 2 * norm
             + (hd * (h + 2 * kv) if cfg.qkv_bias else 0))
    n = 2 * cfg.vocab_size * d + cfg.num_layers * layer + norm
    # the bf16 sizes reckoned for one 80 GB card: 24.3 GB and 65.5 GB
    if arch == "stablelm-12b":
        assert (cfg.norm, cfg.head_dim, cfg.rope_fraction, cfg.qkv_bias) == \
            ("layernorm", 160, 0.25, False)
        assert round(2 * n / 1e9, 1) == 24.3
    else:
        assert (cfg.norm, cfg.num_heads // cfg.num_kv_heads, cfg.qkv_bias) \
            == ("rmsnorm", 5, True)
        assert n == jcfg.param_count() and round(2 * n / 1e9, 1) == 65.5


@pytest.mark.parametrize("name", ["stablelm", "qwen", "stablelm-mlp-bias"])
def test_init_tree_equals_jax(name):
    """Keys, shapes and dtypes of the port's ``init_params`` (fp32, the
    training master params) are JAX's, leaf for leaf in sorted-key order;
    LayerNorm's scale starts at ones and every bias at zeros."""
    cfg, jcfg = _cfgs(name)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(jp)]
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == jpaths
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert j.dtype == jnp.float32
    for path, t in tleaves:
        key = getattr(path[-1], "key", None)
        if key == "scale":
            assert (t == (1.0 if cfg.norm == "layernorm" else 0.0)).all()
        elif key in NEW_LEAVES:
            assert not t.any(), path
    # serving init: matrices and biases in bf16, scales fp32
    bf = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.bfloat16)
    for path, t in jax.tree_util.tree_leaves_with_path(bf):
        key = getattr(path[-1], "key", None)
        assert t.dtype == (torch.float32 if key == "scale"
                           else torch.bfloat16), path


def test_sliced_draw_only_above_the_threshold(monkeypatch):
    """A stacked leaf above ``SLICED_DRAW_ELEMENTS`` is drawn layer by
    layer into the target dtype (same scale, a different stream); at or
    below it the draw is the one a seed always gave."""
    gen = lambda: torch.Generator().manual_seed(3)
    whole = layers.dense_param(gen(), (8, 6), layers=4, dtype=torch.bfloat16)
    want = (torch.randn((4, 8, 6), generator=gen()) / 8 ** 0.5).bfloat16()
    assert torch.equal(whole, want)
    # no earlier config reaches it: Gemma-3-12B's embedding is the largest
    assert 262144 * 3840 < layers.SLICED_DRAW_ELEMENTS < 40 * 5120 * 13824
    monkeypatch.setattr(layers, "SLICED_DRAW_ELEMENTS", 100)
    sliced = layers.dense_param(gen(), (8, 6), layers=4, dtype=torch.bfloat16)
    g = gen()
    want = torch.stack([(torch.randn((8, 6), generator=g) / 8 ** 0.5
                         ).bfloat16() for _ in range(4)])
    assert sliced.dtype == torch.bfloat16 and torch.equal(sliced, want)


@pytest.mark.parametrize("name", ["stablelm", "qwen", "stablelm-mlp-bias"])
def test_bridge_carries_the_new_leaves(name):
    """Biases come out in the asked dtype (the values JAX casts at use),
    scales stay fp32; a training state round-trips them exactly."""
    cfg, jcfg, _, jp = _setup(name)
    np_params = jax.tree.map(np.asarray, jp)
    bf = params_from_jax(np_params, cfg, device="cpu", dtype=torch.bfloat16)
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(bf),
                            jax.tree.leaves(np_params)):
        key = getattr(path[-1], "key", None)
        assert t.dtype == (torch.float32 if key in _bridge._FP32_LEAVES
                           else torch.bfloat16), path
        if key in NEW_LEAVES:
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(jnp.asarray(j).astype(t.dtype == torch.bfloat16
                                                 and jnp.bfloat16
                                                 or jnp.float32), np.float32))
    if name in ROUND_CASES:
        # a training state (the round test's perturbed start) round-trips
        init = _rounds(name)[0]
        back = state_to_numpy(state_from_jax(init, cfg, device="cpu"))
        for f in ("client_stack", "server_params"):
            for a, b in zip(jax.tree.leaves(back[f]),
                            jax.tree.leaves(getattr(init, f))):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    cfg, jcfg = _cfgs("stablelm", dtype)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 7, cfg.d_model)) * 3 + 1.5).astype(np.float32)
    p = {"scale": rng.normal(1.0, 0.5, cfg.d_model).astype(np.float32),
         "bias": rng.normal(0.0, 0.5, cfg.d_model).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jlayers.apply_norm(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x, jdt)).astype(jnp.float32))
    tdt = layers.torch_dtype(dtype)
    got = layers.apply_norm(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


def test_mlp_bias_matches_jax():
    cfg, jcfg = _cfgs("stablelm-mlp-bias")
    jp, _ = jlayers.mlp_init(jax.random.PRNGKey(4), jcfg)
    jp = perturb(jp, seed=4)
    assert set(jp) == {"wg", "wu", "wd", "bu", "bd"}
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    want = np.asarray(jlayers.apply_mlp(jcfg, jp, jnp.asarray(x)))
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in jp.items()}
    got = layers.apply_mlp(cfg, tp, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    # the biases are really applied: without them the output moves
    nobias = layers.apply_mlp(cfg.replace(mlp_bias=False), tp,
                              torch.as_tensor(x)).numpy()
    assert np.abs(nobias - want).max() > 1e-2


def test_project_qkv_biases_match_jax():
    cfg, jcfg = _cfgs("qwen")
    jp, _ = jattn.attention_init(jax.random.PRNGKey(5), jcfg)
    jp = perturb(jp, seed=5)
    assert {"bq", "bk", "bv"} <= set(jp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) + 3, (2, 1))
    want = jattn._project_qkv(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in jp.items()}
    got = attn._project_qkv(cfg, tp, torch.as_tensor(x), torch.as_tensor(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32)


# ---------------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_jax(name):
    cfg, jcfg, tp, jp = _setup(name)
    toks = _tokens(cfg, 2, 40, seed=2)
    want, _ = jax.jit(lambda p, t: jtf.forward(p, jcfg, t, impl="dense",
                                               remat=False))(jp, toks)
    for impl in ("dense", "kernel"):
        with torch.no_grad():      # the kernel path has no backward
            got, _ = tf.forward(tp, cfg, torch.as_tensor(toks), impl=impl,
                                remat=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("name", ["stablelm", "qwen", "stablelm-hd160-g4",
                                  "qwen-g5"])
def test_prefill_and_paged_decode_match_jax(name):
    """Prefill 37 tokens through the kernel path, then three decode steps
    against a paged cache (block 8, rows on permuted blocks) through the
    paged kernel's plain version, against JAX's prefill and decode on its
    contiguous cache (which JAX's paged cache equals bit for bit)."""
    cfg, jcfg, tp, jp = _setup(name)
    toks = _tokens(cfg, 2, 37, seed=3)
    max_len = 48
    jl, jc = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len=max_len,
                                              impl="dense"))(jp, toks)
    step = jax.jit(lambda p, t, c, pos: jtf.decode_step(p, jcfg, t, c, pos))
    tl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), impl="kernel",
                       last_only=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    # a pool of 2 x (48 / 8 + 1) blocks, the first 2 each slot's scratch
    perm = np.random.default_rng(4).permutation(np.arange(2, 14))
    eng = DecodeEngine(cfg, device="cpu")
    st = eng.new_batch_state(2, max_len, block_size=8)
    for row in range(2):
        blocks = [int(b) for b in perm[6 * row:6 * row + 6]]
        eng.admit(st, tp, toks[row], row, blocks=blocks)
    cache, table = st.cache, st.device_table()
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):
        pos = np.full((2,), 37 + t, np.int32)
        jlg, jc = step(jp, tok, jc, pos)
        tlg, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), cache,
                                torch.as_tensor(pos), table=table,
                                paged_kernel=True)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **FP32)
        tok = np.argmax(np.asarray(jlg)[:, 0], -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("name", ["stablelm", "qwen"])
def test_greedy_tokens_match_jax_engine(name):
    cfg, jcfg, tp, jp = _setup(name)
    prompts = _tokens(cfg, 2, 30, seed=5)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, prompts, 10))
    got = DecodeEngine(cfg, impl="kernel", paged_kernel=True,
                       device="cpu").generate(tp, prompts, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["stablelm", "qwen"])
def test_bf16_prefill_logits_within_the_band(name):
    cfg, jcfg, tp, jp = _setup(name, "bfloat16")
    assert tp["final_norm"]["scale"].dtype == torch.float32
    toks = _tokens(cfg, 1, 40, seed=6)
    want, _ = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, impl="dense"))(
        jp, toks)
    got, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), impl="kernel")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


# ---------------------------------------------------------------------------
# one WSSL round
# ---------------------------------------------------------------------------


ROUND_CASES = ("stablelm", "qwen")


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@functools.lru_cache(maxsize=None)
def _rounds(name):
    """One round of 4 clients at participation 0.5, cut 1, sequence 24,
    from a perturbed JAX state: the live jitted JAX round and the port's
    round on the bridged state with JAX's Gumbel draw injected."""
    cfg, jcfg = _cfgs(name)
    w = dict(num_clients=4, participation_fraction=0.5, split_layer=1)
    js = jax.jit(lambda key: jax_init_state(
        key, jcfg, JWSSLConfig(**w), JTrainConfig(**TRAIN_KW))[0])(
            jax.random.PRNGKey(0))
    js = js._replace(client_stack=perturb(js.client_stack, 7),
                     server_params=perturb(js.server_params, 8))
    init = jax.tree.map(np.asarray, js)
    _, rng_sel = jax.random.split(js.rng)
    gumbel = np.asarray(jax.random.gumbel(rng_sel, (4,)))
    d = jax_lm_batch(8, 24, jcfg.vocab_size, seed=0)
    val = jax_lm_batch(2, 24, jcfg.vocab_size, seed=999)
    rf = jax_make_round_fn(jcfg, JWSSLConfig(**w), JTrainConfig(**TRAIN_KW),
                           impl="dense", donate=True)
    js, jm = rf(js, {k: jnp.asarray(v).reshape(4, 2, 24) for k, v in d.items()},
                {k: jnp.asarray(v) for k, v in val.items()})
    jm = jax.tree.map(np.asarray, jm._asdict())
    jstate = jax.tree.map(np.asarray, js)

    state = state_from_jax(init, cfg, device="cpu")
    rf = make_round_fn(cfg, WSSLConfig(**w), TrainConfig(**TRAIN_KW),
                       impl="dense")
    td = lm_batch(8, 24, cfg.vocab_size, seed=0)
    tv = lm_batch(2, 24, cfg.vocab_size, seed=999)
    state, m = rf(state, {k: torch.as_tensor(v).reshape(4, 2, 24)
                          for k, v in td.items()},
                  {k: torch.as_tensor(v) for k, v in tv.items()},
                  gumbel=torch.tensor(gumbel))
    return init, jm, jstate, m, state_to_numpy(state)


@pytest.mark.parametrize("name", ["stablelm", "qwen"])
def test_round_matches_live_jax_round(name):
    init, jm, jstate, m, got = _rounds(name)
    np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
    for f in ("loss", "per_client_loss", "val_loss", "importance"):
        np.testing.assert_allclose(getattr(m, f).numpy(), jm[f], rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    for f in ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
              "bytes_update_raw", "bytes_update_comp"):
        np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                      err_msg=f)
    diffs = []
    for f in ("client_stack", "server_params"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        diffs += [np.abs(x - y).ravel() for x, y in zip(a, b)]
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR, diffs.max()
    assert diffs.mean() <= 1e-7, diffs.mean()
    assert np.quantile(diffs, 0.999) <= 1e-6
    for f in ("opt_client", "opt_server"):
        for k in ("m", "v"):
            for a, b in zip(_np_leaves(got[f][k]),
                            _np_leaves(getattr(getattr(jstate, f), k))):
                np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("name", ["stablelm", "qwen"])
def test_round_trains_the_new_leaves(name):
    """A selected client's biases and norm params move, as JAX's do; a
    masked client's stay exactly where they were."""
    init, jm, jstate, m, got = _rounds(name)

    def new_leaves(tree):
        return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
                jax.tree_util.tree_leaves_with_path(tree)
                if getattr(p[-1], "key", None) in NEW_LEAVES]

    before = new_leaves(init.client_stack)
    after = new_leaves(got["client_stack"])
    assert [k for k, _ in before] == [k for k, _ in after] and before
    for (key, a), (_, b) in zip(before, after):
        for i, sel in enumerate(m.mask.numpy()):
            assert np.array_equal(a[i], b[i]) == (sel == 0.0), (key, i)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_and_trains(capsys, arch):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--replicas", "1", "--slots", "2",
                       "--prompt-len", "12", "--gen", "4", "--block-size",
                       "8", "--paged-kernel", "--impl", "kernel"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--clients", "2", "--rounds", "1", "--seq-len", "16",
                       "--batch-per-client", "1"])
    out = capsys.readouterr().out
    assert out.count("loss=") == 1 and "nan" not in out
