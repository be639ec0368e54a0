"""The port's optimizers, schedules and fused-AdamW kernel dispatch against
``repro.optim`` and ``repro.kernels.ref`` on the same numpy inputs.

Bands: AdamW (masked and unmasked, against both the JAX optimizer's
unfused chain and its fused-kernel oracle ``repro.kernels.ref``) and SGD
are **exact** in fp32 against the JAX package run op by op — the port
keeps the JAX op order and computes the hypers, bias corrections
included, in fp32 with the same rounding.  The clip's global
norm is a reduction in another order: rel 1e-6.  The cosine schedule
calls ``cos``, whose fp32 result may differ by one ulp between XLA and
PyTorch: rel 2e-7; the constant and linear schedules are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.kernels import ref as jref
from repro.optim import optimizers as jopt
from repro.optim.schedule import make_schedule as jax_schedule
from repro_torch.kernels import fused_adam as fadam_mod
from repro_torch.kernels import ops, ref
from repro_torch.optim import optimizers as opt
from repro_torch.optim.schedule import make_schedule


def _tree(rng, shapes, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (3, 5, 7), "b": (3, 11), "c": (3,)}
MASK = np.array([1.0, 0.0, 1.0], np.float32)


def _jax_ref_adamw(params, grads, state, *, lr, weight_decay, mask,
                   beta1=0.9, beta2=0.95, eps=1e-8):
    """JAX ``adamw_update(use_kernel=True)`` with the Pallas kernel's
    oracle ``repro.kernels.ref.fused_adamw_2d`` in its place: the same
    hyper vector, built in the same order, over (N, M) views."""
    step = state.step + 1
    t = step.astype(jnp.float32)
    scalars = jnp.stack([jnp.asarray(x, jnp.float32) for x in
                         (lr, beta1, beta2, 1 - beta1, 1 - beta2, eps,
                          weight_decay, 1.0 - beta1 ** t, 1.0 - beta2 ** t)])
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        n = p.shape[0] if mask is not None else 1
        rows = mask if mask is not None else jnp.ones((1,), jnp.float32)
        po, mo, vo = jref.fused_adamw_2d(
            p.reshape(n, -1), grads[k].reshape(n, -1),
            state.m[k].reshape(n, -1), state.v[k].reshape(n, -1), rows,
            scalars)
        new_p[k], new_m[k], new_v[k] = (o.reshape(p.shape) for o in
                                        (po, mo, vo))
    return new_p, jopt.AdamState(step=step, m=new_m, v=new_v)


def _run_adam(masked, jax_ref, steps=3, dtype=torch.float32):
    """(JAX params, m, v) and (port params, m, v) after ``steps`` steps;
    the JAX side through its unfused optimizer chain or, with
    ``jax_ref``, through its fused-kernel oracle."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES, 0.02)
    grads = [_tree(rng, SHAPES, 1e-3) for _ in range(steps)]
    jp = {k: jnp.asarray(v).astype(_JAX_DTYPE[dtype]) for k, v in p0.items()}
    js = jopt.adamw_init(jp)
    tp = {k: torch.tensor(v).to(dtype) for k, v in p0.items()}
    ts = opt.adamw_init(tp)
    jax_update = _jax_ref_adamw if jax_ref else jopt.adamw_update
    for g in grads:
        kw = dict(lr=1e-3, weight_decay=0.01)
        jp, js = jax_update(
            jp, {k: jnp.asarray(v).astype(_JAX_DTYPE[dtype])
                 for k, v in g.items()}, js,
            mask=jnp.asarray(MASK) if masked else None, **kw)
        out, ts2 = opt.adamw_update(
            tp, {k: torch.tensor(v).to(dtype) for k, v in g.items()}, ts,
            mask=torch.tensor(MASK) if masked else None, **kw)
        assert out is tp and ts2 is ts
    return (jp, js), (tp, ts)


_JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("jax_ref", [False, True])
def test_adamw_matches_jax_exactly(masked, jax_ref):
    (jp, js), (tp, ts) = _run_adam(masked, jax_ref)
    assert int(ts.step) == int(js.step) == 3
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(ts.m[k].numpy(), np.asarray(js.m[k]))
        np.testing.assert_array_equal(ts.v[k].numpy(), np.asarray(js.v[k]))


def test_adamw_mask_freezes_unselected_rows():
    rng = np.random.default_rng(1)
    p0 = _tree(rng, SHAPES, 0.02)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.adamw_init(tp)
    for _ in range(2):
        g = {k: torch.tensor(v) for k, v in _tree(rng, SHAPES, 1e-3).items()}
        opt.adamw_update(tp, g, ts, lr=1e-3, mask=torch.tensor(MASK))
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k][1].numpy(), p0[k][1])
        assert not torch.count_nonzero(ts.m[k][1])
        assert torch.count_nonzero(ts.m[k][0])


def test_adamw_updates_in_place():
    rng = np.random.default_rng(2)
    tp = {k: torch.tensor(v) for k, v in _tree(rng, SHAPES, 0.02).items()}
    ts = opt.adamw_init(tp)
    ptrs = [t.data_ptr() for t in (*tp.values(), *ts.m.values(),
                                   *ts.v.values())]
    for _ in range(2):
        g = {k: torch.tensor(v) for k, v in _tree(rng, SHAPES, 1e-3).items()}
        opt.adamw_update(tp, g, ts, lr=1e-3)
    assert ptrs == [t.data_ptr() for t in (*tp.values(), *ts.m.values(),
                                           *ts.v.values())]


def test_adamw_bf16_params_kernel_equals_unfused():
    """bf16 params: the port's fused step equals the JAX optimizer's
    unfused chain and its kernel oracle exactly — fp32 math, p rounded
    once to bf16, fp32 moments."""
    for jax_ref in (False, True):
        (jp, js), (tp, ts) = _run_adam(True, jax_ref, dtype=torch.bfloat16)
        for k in SHAPES:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(_np32(tp[k]), _np32(jp[k]))
            np.testing.assert_array_equal(ts.m[k].numpy(), np.asarray(js.m[k]))
            np.testing.assert_array_equal(ts.v[k].numpy(), np.asarray(js.v[k]))


@pytest.mark.parametrize("step", [1, 2, 7, 100, 10_000])
def test_adam_scalars_match_jax(step):
    """The nine hypers, bias corrections included, equal the JAX package's
    fp32 values (jnp's ``beta ** t`` on an fp32 step), op by op and under
    jit."""
    s = opt.adam_scalars(step, lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8,
                         weight_decay=0.01)
    assert s.dtype == torch.float32 and s.shape == (9,)

    def jax_bc(t):
        t = jnp.asarray(t, jnp.int32).astype(jnp.float32)
        return jnp.stack([1.0 - 0.9 ** t, 1.0 - 0.95 ** t])

    want = [3e-4, 0.9, 0.95, 1 - 0.9, 1 - 0.95, 1e-8, 0.01]
    np.testing.assert_array_equal(s[:7].numpy(), np.float32(want))
    for fn in (jax_bc, jax.jit(jax_bc)):
        np.testing.assert_array_equal(s[7:].numpy(), np.asarray(fn(step)))


def test_plain_fused_adamw_matches_jax_ref():
    rng = np.random.default_rng(3)
    n, m = 4, 37
    p, g = (rng.normal(size=(n, m)).astype(np.float32) for _ in range(2))
    mm = rng.normal(size=(n, m)).astype(np.float32) * 1e-2
    vv = rng.random(size=(n, m)).astype(np.float32) * 1e-3
    mask = np.array([1, 0, 1, 1], np.float32)
    sc = opt.adam_scalars(4, lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8,
                          weight_decay=0.1)
    want = jref.fused_adamw_2d(*(jnp.asarray(a) for a in (p, g, mm, vv,
                                                          mask)),
                               jnp.asarray(sc.numpy()))
    got = ref.fused_adamw_2d(*(torch.tensor(a) for a in (p, g, mm, vv, mask)),
                             sc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and through the dispatch and its plain version, in place
    for fn in (ops.fused_adamw, ops.fused_adamw_plain):
        tp, tm, tv = (torch.tensor(a) for a in (p, mm, vv))
        fn(tp, torch.tensor(g), tm, tv, torch.tensor(mask), sc)
        for a, b in zip((tp, tm, tv), want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cols", [1, 8, 36, 37])
def test_plain_fused_adamw_in_column_slices_is_exact(monkeypatch, cols):
    """The plain version runs in column slices (bounded transients on the
    card); the update is elementwise, so any slice width gives the same
    bits as one slice, a ragged last slice and mask=None included."""
    rng = np.random.default_rng(5)
    p, g, mm = (rng.normal(size=(3, 37)).astype(np.float32)
                for _ in range(3))
    vv = rng.random(size=(3, 37)).astype(np.float32)
    sc = opt.adam_scalars(2, lr=1e-2, beta1=0.9, beta2=0.95, eps=1e-8,
                          weight_decay=0.1)
    for mask in (torch.tensor([0.0, 1.0, 1.0]), None):
        want = ref.fused_adamw_2d(*(torch.tensor(a) for a in (
            p, g, mm, vv)), mask, sc) if mask is not None else [
            t.reshape(3, 37) for t in ref.fused_adamw_2d(*(
                torch.tensor(a).reshape(1, -1) for a in (p, g, mm, vv)),
                None, sc)]
        monkeypatch.setattr(ops, "PLAIN_ADAM_COLS", cols)
        tp, tm, tv = (torch.tensor(a) for a in (p, mm, vv))
        ops.fused_adamw_plain(tp, torch.tensor(g), tm, tv, mask, sc)
        for a, b in zip((tp, tm, tv), want):
            assert torch.equal(a, b)


def test_fused_adamw_dispatch_edges():
    sc = opt.adam_scalars(1, lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8,
                          weight_decay=0.0)
    empty = torch.zeros((2, 0))
    ops.fused_adamw(empty, empty, empty.clone(), empty.clone(), None, sc)
    # the CUDA wrapper refuses host tensors before it builds anything
    p = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        fadam_mod.fused_adamw_2d(p, p, p.clone(), p.clone(), None,
                                 sc.tolist())
    with pytest.raises(ValueError, match="dtype|float32"):
        fadam_mod.fused_adamw_2d(p, p, p.double(), p.clone(), None,
                                 sc.tolist())


def test_sgd_matches_jax_and_freezes_masked_momentum():
    rng = np.random.default_rng(4)
    p0 = _tree(rng, SHAPES, 0.02)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.sgd_init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.sgd_init(tp)
    for _ in range(3):
        g = _tree(rng, SHAPES, 1e-2)
        jp, js = jopt.sgd_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                 js, lr=0.1, weight_decay=0.01,
                                 mask=jnp.asarray(MASK))
        opt.sgd_update(tp, {k: torch.tensor(v) for k, v in g.items()}, ts,
                       lr=0.1, weight_decay=0.01, mask=torch.tensor(MASK))
    assert int(ts.step) == 3
    for k in SHAPES:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(ts.mom[k].numpy(), np.asarray(js.mom[k]))
        assert not torch.count_nonzero(ts.mom[k][1])


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(5)
    g = _tree(rng, SHAPES, 0.1)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                      max_norm)
    tg = {k: torch.tensor(v) for k, v in g.items()}
    out, tn = opt.clip_by_global_norm(tg, max_norm)
    assert out is tg
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("warmup,total", [(0, 20), (10, 20), (3, 7)])
def test_schedules_match_jax(kind, warmup, total):
    js = jax_schedule(kind, 3e-4, warmup, total)
    ts = make_schedule(kind, 3e-4, warmup, total)
    got = np.array([ts(s).item() for s in range(25)], np.float32)
    want = np.array([js(jnp.int32(s)) for s in range(25)], np.float32)
    assert all(ts(s).dtype == torch.float32 for s in (0, 5))
    if kind == "cosine":
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_make_optimizer():
    assert opt.make_optimizer("adamw") == (opt.adamw_init, opt.adamw_update)
    assert opt.make_optimizer("sgd") == (opt.sgd_init, opt.sgd_update)
    with pytest.raises(ValueError):
        opt.make_optimizer("lion")
