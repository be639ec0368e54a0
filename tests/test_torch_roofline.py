"""The roofline (``roofline/analysis.py``) and the op counter
(``roofline/op_cost.py``) against the JAX package.

* ``model_flops``, ``fused_adam_bytes``, ``num_paged_layers`` and
  ``paged_attention_bytes`` equal JAX's exactly for every arch x input
  shape.
* The counter's FLOPs of reduced Gemma-2B's and OLMoE-1B-7B's prefill
  and train steps (``impl="dense"``) lie within 5% of JAX's
  ``hlo_cost.analyze_text`` of the jitted JAX step on the same config.
  Prefill agrees exactly; the train step counts one more unembedding
  product, 2 x tokens x vocab x d_model (the port's chunked
  cross-entropy recomputes its logits under a checkpoint in the
  backward, where XLA keeps the forward's).
* The counter: matmul-class FLOPs by formula, views move nothing, the
  peak of live temporaries, and a meta count equal to a CPU count of the
  same step (train, prefill on the kernel path, decode).
* Every kernel wrapper credits its cost function's (flops, bytes) in
  place of its plain version's ops, and on the meta device returns the
  plain version's shape and dtype.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import (INPUT_SHAPES, TrainConfig as JTrain,
                          WSSLConfig as JWssl, get_arch as jget_arch,
                          reduced as jreduced)
from repro.core.round import abstract_state as j_abstract_state
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.roofline import analysis as jan
from repro.roofline import hlo_cost
from repro_torch.config import (ShapeConfig, TrainConfig, WSSLConfig,
                                get_arch, list_archs, reduced)
from repro_torch.core import round as rnd
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as st
from repro_torch.models import transformer as tf
from repro_torch.roofline import analysis as an
from repro_torch.roofline import op_cost

ARCHS = list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_flop_and_byte_models_match_jax(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        pshape = ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                             shape.kind)
        assert an.model_flops(cfg, pshape) == jan.model_flops(jcfg, shape)
    for n, isz in ((cfg.param_count(), 4), (12345, 2)):
        assert an.fused_adam_bytes(n, isz) == jan.fused_adam_bytes(n, isz)
    assert an.num_paged_layers(cfg) == jan.num_paged_layers(jcfg)
    for kw in (dict(block_size=16, num_blocks=37, live_entries=300.5),
               dict(block_size=64, num_blocks=8, live_entries=17,
                    batch=8, kv_itemsize=2)):
        assert an.paged_attention_bytes(cfg, **kw) == \
            jan.paged_attention_bytes(jcfg, **kw)


def test_report_terms():
    rep = an.RooflineReport(arch="a", shape="s", mesh="1",
                            flops_per_device=989e12, bytes_per_device=6.7e12,
                            coll_bytes_per_device=450e9,
                            model_flops_global=494.5e12, chips=1)
    assert rep.t_compute == pytest.approx(1.0)
    assert rep.t_memory == pytest.approx(2.0)
    assert rep.t_collective == pytest.approx(1.0)
    assert rep.bottleneck == "memory"
    assert rep.model_flops_ratio == pytest.approx(0.5)
    assert rep.mfu_bound == pytest.approx(0.25)
    assert set(jan.RooflineReport(
        arch="a", shape="s", mesh="m", flops_per_device=1.0,
        bytes_per_device=1.0, coll_bytes_per_device=1.0,
        model_flops_global=1.0, chips=1).to_dict()) <= set(rep.to_dict())
    assert an.weighted_collective_bytes({"all-reduce": 3, "all-gather": 5}) \
        == 11
    mem = an.summarize_memory(10e9, 81e9)
    assert mem["temp_size_in_bytes"] == 71e9 and not mem["fits_80GB"]
    assert an.summarize_memory(10e9, 79e9)["fits_80GB"]
    assert an.mfu(989e12, 2.0) == pytest.approx(0.5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 7, 64, 500])
def test_attention_pairs_match_the_loop(causal, window):
    for sq, sk in ((1, 1), (5, 5), (397, 397), (64, 64), (10, 30)):
        loop = sum(min(min(i + 1, sk) if causal else sk, window or sk)
                   for i in range(sq))
        assert an.attention_pairs(sq, sk, causal, window) == loop


def test_bound_ms():
    t, by = an.bound_ms(3.35e9, 1.0, "float32")
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = an.bound_ms(1.0, 67e9, "float32")
    assert (t, by) == (pytest.approx(1.0), "operations")
    assert an.bound_ms(1.0, 989e9, "bfloat16")[0] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------


def test_matmul_flops_and_views():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 5, generator=g), torch.randn(5, 7, generator=g)
    x = torch.randn(4, 3, 5, generator=g)
    y = torch.randn(4, 5, 2, generator=g)
    w = torch.randn(6, 3, 3, generator=g, requires_grad=True)
    img = torch.randn(2, 3, 10, generator=g, requires_grad=True)
    with op_cost.OpCounter() as c:
        a @ b
        torch.addmm(torch.zeros(7), a, b)
        torch.bmm(x, y)
        torch.baddbmm(torch.zeros(4, 3, 2), x, y)
        a @ b[:, 0]
    assert c.flops == 2 * 3 * 5 * 7 * 2 + 2 * 4 * 3 * 5 * 2 * 2 + 2 * 3 * 5
    with op_cost.OpCounter() as c:
        out = torch.nn.functional.conv1d(img, w)          # (2, 6, 8)
    fwd = 2.0 * 2 * 6 * 8 * 3 * 3
    assert c.flops == fwd
    with op_cost.OpCounter() as c:
        out.sum().backward()
    assert c.flops == 2 * fwd          # input and weight gradients
    with op_cost.OpCounter() as c:
        x.view(12, 5).t()[:, 1:]
        x.transpose(0, 1)
    assert c.bytes == 0 and c.num_ops == 0


def test_peak_of_live_temporaries():
    with op_cost.OpCounter() as c:
        a = torch.zeros(1000)                     # 4000 B live
        b = a + 1                                 # 8000
        del a                                     # 4000
        d = torch.zeros(250)                      # 5000
        del b, d
        e = torch.zeros(3000)                     # 12000
        del e
    assert c.peak_temp_bytes == 12000
    assert c.live_bytes == 0


def _gemma(device, dtype=None):
    cfg = reduced(get_arch("gemma-2b"))
    if device == "meta":
        return cfg, tf.abstract_params(cfg, dtype=dtype)[0]
    return cfg, tf.init_params(cfg, torch.Generator().manual_seed(0),
                               device=device, dtype=dtype)


def _counted(fn):
    with op_cost.OpCounter() as c:
        fn()
    return c


@pytest.mark.parametrize("step", ["train_dense", "train_chunked",
                                  "prefill_kernel", "decode"])
def test_meta_count_equals_cpu_count(step):
    counts = {}
    for dev in ("cpu", "meta"):
        cfg, params = _gemma(dev)
        if step.startswith("train"):
            w, tc = WSSLConfig(num_clients=2), TrainConfig()
            state = (rnd.abstract_state(cfg, w, tc)[0] if dev == "meta"
                     else rnd.init_state(torch.Generator().manual_seed(0),
                                         cfg, w, tc, device=dev))
            tok = torch.zeros((2, 2, 64), dtype=torch.int32, device=dev)
            fn = st.make_train_step(cfg, w, tc, impl=step.split("_")[1])
            call = lambda: fn(state, {"tokens": tok, "labels": tok})
        elif step == "prefill_kernel":
            tok = torch.zeros((2, 64), dtype=torch.int32, device=dev)
            fn = st.make_prefill_step(cfg, "kernel")
            call = lambda: fn(params, {"tokens": tok})
        else:
            cache = tf.init_cache(cfg, 3, 40, device=dev)
            batch = {"tokens": torch.zeros((3, 1), dtype=torch.int32,
                                           device=dev),
                     "pos": torch.full((3,), 17, dtype=torch.int32,
                                       device=dev)}
            fn = st.make_serve_step(cfg, ShapeConfig("d", 40, 3, "decode"))
            call = lambda: fn(params, cache, batch)
        counts[dev] = _counted(call)
    cpu, meta = counts["cpu"].totals(), counts["meta"].totals()
    for key in ("flops", "bytes", "elementwise_ops", "kernels", "num_ops"):
        assert cpu[key] == meta[key], (key, cpu[key], meta[key])
    assert cpu["flops"] > 0 and cpu["bytes"] > 0
    assert set(meta["devices"]) <= {"meta", "cpu"}
    if step == "prefill_kernel":
        assert meta["kernels"]["flash_attention"]["launches"] == \
            cfg.num_layers
    if step.startswith("train"):
        assert meta["kernels"]["fused_adamw"]["launches"] > 0


def _jax_cost(fn, *args):
    return hlo_cost.analyze_text(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_counter_flops_match_hlo_cost(arch, kind):
    n, b, s = 2, 2, 64
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    if kind == "prefill":
        jp, _ = jtf.abstract_params(jcfg)
        want = _jax_cost(jsteps.make_prefill_step(jcfg, "dense"), jp,
                         {"tokens": i32(b, s)})
        params, _ = tf.abstract_params(cfg)
        tok = torch.empty((b, s), dtype=torch.int32, device="meta")
        fn = st.make_prefill_step(cfg, "dense")
        _, got = op_cost.analyze(lambda: fn(params, {"tokens": tok}))
        assert set(want) <= set(got)       # analyze_text's keys
        assert got["flops"] == want["flops"]
        return
    js, _ = j_abstract_state(jcfg, JWssl(num_clients=n), JTrain())
    want = _jax_cost(jsteps.make_train_step(jcfg, JWssl(num_clients=n),
                                            JTrain(), "dense"), js,
                     {"tokens": i32(n, b, s), "labels": i32(n, b, s)})
    w, tc = WSSLConfig(num_clients=n), TrainConfig()
    state, _ = rnd.abstract_state(cfg, w, tc)
    tok = torch.empty((n, b, s), dtype=torch.int32, device="meta")
    fn = st.make_train_step(cfg, w, tc, impl="dense")
    got = _counted(lambda: fn(state, {"tokens": tok, "labels": tok})).totals()
    assert abs(got["flops"] / want["flops"] - 1) < 0.05, (got, want)
    # the whole gap: the unembedding the chunked cross-entropy recomputes
    assert got["flops"] - want["flops"] == \
        2.0 * n * b * s * cfg.vocab_size * cfg.d_model


# ---------------------------------------------------------------------------
# The kernel wrappers' credits
# ---------------------------------------------------------------------------


def _kernel_cases(dev="cpu"):
    """name -> (the wrapper's call on ``dev``, its cost on the CPU's
    values)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g)
    q, k = r(2, 48, 4, 32), r(2, 48, 2, 32)
    nb, bs = 6, 8
    pool = r(2 * nb + 2, bs, 2, 32)
    table = torch.arange(2 * nb, dtype=torch.int32).reshape(2, nb)
    pos = torch.tensor([20, 40], dtype=torch.int32)
    ppos = torch.full((2 * nb + 2, bs), -1, dtype=torch.int32)
    for row in range(2):
        flat = torch.arange(nb * bs, dtype=torch.int32)
        flat[flat > pos[row]] = -1
        ppos[table[row]] = flat.reshape(nb, bs)
    valid, walked = an.paged_live_entries(ppos, table, pos, bs)
    x = r(2, 64, 4, 32)
    dt, a = r(2, 64, 4).abs(), -r(4).abs()
    bc = r(2, 64, 16)
    la, bb = -r(2, 64, 24).abs() * 0.1, r(2, 64, 24)
    stack, p, u = r(3, 5, 8), r(3, 40), torch.rand(3, 40, generator=g)
    codes = torch.ones(3, 40, dtype=torch.int8)
    one3, one9, w3 = torch.ones(3), torch.ones(9), torch.full((3,), 1 / 3)
    (q, k, pool, table, pos, ppos, x, dt, a, bc, la, bb, stack, p, u, codes,
     one3, w3) = (t.to(dev) for t in (q, k, pool, table, pos, ppos, x, dt,
                                      a, bc, la, bb, stack, p, u, codes,
                                      one3, w3))
    q0, p0 = q[:, 0].contiguous(), p.clone()
    m0, v0 = torch.zeros(3, 40, device=dev), torch.zeros(3, 40, device=dev)
    return {
        "flash_attention": (
            lambda: ops.flash_attention(q, k, k, window=9),
            an.flash_attention_cost(2, 4, 2, 48, 32, 4, window=9)),
        "paged_decode_attention": (
            lambda: ops.paged_decode_attention(q0, pool, pool, ppos, table,
                                               pos),
            an.paged_decode_cost(2, 4, 2, 32, 4, block_size=bs,
                                 valid=valid, walked=walked)),
        "ssd_scan": (lambda: ops.ssd_scan(x, dt, a, bc, bc, chunk=32,
                                          block_h=4),
                     an.ssd_scan_cost(2, 64, 4, 32, 16, 4, 32)),
        "rg_lru_scan": (lambda: ops.rg_lru_scan(la, bb, chunk=32,
                                                block_w=8),
                        an.rg_lru_cost(2, 64, 24, 4)),
        "weighted_average": (lambda: ops.weighted_average(stack, w3),
                             an.wavg_cost(3, 40, 4)),
        "fused_adamw": (lambda: ops.fused_adamw(p0, p, m0, v0, one3, one9),
                        an.fused_adamw_cost(120, rows=3)),
        "quantize_stochastic": (
            lambda: ops.quantize_stochastic(p, u, one3, 127.0),
            an.quantize_cost(3, 40)),
        "dequantize": (lambda: ops.dequantize(codes, one3),
                       an.dequantize_cost(3, 40)),
        "topk_mask": (lambda: ops.topk_mask(p, one3),
                      an.topk_mask_cost(3, 40)),
    }


@pytest.mark.parametrize("name", list(an.KERNEL_OP_KIND))
def test_wrappers_credit_their_cost(name):
    call, cost = _kernel_cases()[name]
    with op_cost.OpCounter() as c:
        out = call()
    assert c.num_ops == 0                    # the plain version's ops
    assert c.kernels == {name: {"launches": 1, "flops": cost.flops,
                                "bytes": cost.bytes}}
    assert c.bytes == cost.bytes
    matmul = an.KERNEL_OP_KIND[name] == "matmul"
    assert c.flops == (cost.flops if matmul else 0.0)
    assert c.elementwise_ops == (0.0 if matmul else cost.flops)
    # the meta route: the plain version's shape and dtype, nothing run
    meta_call, _ = _kernel_cases("meta")[name]
    with op_cost.OpCounter() as c:
        got = meta_call()
    assert c.num_ops == 0 and c.kernels[name]["launches"] == 1
    if out is None:                          # AdamW: in place
        assert got is None
        return
    assert got.is_meta and got.shape == out.shape and got.dtype == out.dtype


def test_flash_plain_output_is_contiguous_as_the_kernel_writes_it():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 9, 2, 16, generator=g)
    out = ops.flash_attention(q, q, q)
    assert out.is_contiguous()
    want = ref.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                               q.transpose(1, 2)).transpose(1, 2)
    assert torch.equal(out, want)
