"""The port's WSSL selection, coefficients, weighted average, aggregator
registry and training configs against ``repro.core`` / ``repro.config``
on the same numpy inputs.

Bands: selection masks are **exact** when the JAX Gumbel draw is injected;
importance and coefficients rel 1e-6 (softmax and sums in fp32, other
reduction order); the weighted average (plain and through the kernel
dispatch) atol 1e-6 at outputs of O(1) (an fp32 matrix product in
another order); bf16 one output ulp (rel 2**-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AggregationConfig as JAggregationConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.core import aggregation as jagg
from repro.core import wssl as jwssl
from repro.core.protocol import sync_round_bytes as jax_sync_bytes
from repro.core.protocol import tree_bytes as jax_tree_bytes
from repro.kernels import ref as jref
from repro_torch.config import (AggregationConfig, AsyncRoundsConfig,
                                CompressionConfig, TrainConfig,
                                WSSLConfig, get_arch)
from repro_torch.core import aggregation as agg
from repro_torch.core import wssl
from repro_torch.core.protocol import sync_round_bytes, tree_bytes
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wavg as wavg_mod

RTOL = dict(rtol=1e-6, atol=1e-7)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("with_prev", [False, True])
def test_compute_importance_matches_jax(with_prev):
    rng = np.random.default_rng(0)
    val = rng.uniform(2.0, 6.0, size=7).astype(np.float32)
    prev = rng.dirichlet(np.ones(7)).astype(np.float32) if with_prev else None
    for temp, ema in ((1.0, 0.5), (0.3, 0.9)):
        jc = JWSSLConfig(num_clients=7, importance_temp=temp,
                         importance_ema=ema)
        tc = WSSLConfig(num_clients=7, importance_temp=temp,
                        importance_ema=ema)
        want = jwssl.compute_importance(
            jnp.asarray(val), jc, None if prev is None else jnp.asarray(prev))
        got = wssl.compute_importance(_t(val), tc,
                                      None if prev is None else _t(prev))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
        np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n,frac", [(4, 0.5), (8, 0.25), (16, 0.5), (5, 0.6)])
@pytest.mark.parametrize("round_index", [0, 1, 7])
def test_selection_with_jax_gumbel_is_exact(n, frac, round_index):
    jc = JWSSLConfig(num_clients=n, participation_fraction=frac)
    tc = WSSLConfig(num_clients=n, participation_fraction=frac)
    assert tc.num_selected() == jc.num_selected()
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        w = np.random.default_rng(seed).dirichlet(np.ones(n)).astype(
            np.float32)
        want = jwssl.participation_mask(key, jnp.asarray(w), jc,
                                        jnp.int32(round_index))
        gumbel = jax.random.gumbel(key, (n,))
        got = wssl.participation_mask(_t(w), tc, torch.tensor(round_index),
                                      gumbel=_t(gumbel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        idx = wssl.weighted_sample(_t(w), tc.num_selected(),
                                   gumbel=_t(gumbel))
        jidx = jwssl.weighted_sample(key, jnp.asarray(w), jc.num_selected())
        assert sorted(idx.tolist()) == sorted(np.asarray(jidx).tolist())


def test_weighted_sample_from_generator():
    w = torch.tensor([0.7, 0.1, 0.1, 0.1])
    g = torch.Generator().manual_seed(0)
    picks = [wssl.weighted_sample(w, 1, generator=g).item()
             for _ in range(400)]
    assert 0.6 < picks.count(0) / 400 < 0.8
    noise = wssl.gumbel_noise((20000,), torch.Generator().manual_seed(1))
    assert abs(float(noise.mean()) - 0.5772) < 0.03
    with pytest.raises(ValueError, match="generator"):
        wssl.weighted_sample(w, 1)
    mask = wssl.selection_mask(torch.tensor([2, 0]), 4)
    assert mask.tolist() == [1.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("rule", ["importance", "uniform"])
def test_coefficients_match_jax(rule):
    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.ones(6)).astype(np.float32)
    jc = JWSSLConfig(num_clients=6, aggregation=rule)
    tc = WSSLConfig(num_clients=6, aggregation=rule)
    for mask in ([1, 0, 1, 1, 0, 0], [0.0, 0.5, 1, 0, 0.25, 0],
                 [0] * 6):
        m = np.asarray(mask, np.float32)
        for jf, tf_ in ((jwssl.aggregation_weights, wssl.aggregation_weights),
                        (jwssl.safe_aggregation_weights,
                         wssl.safe_aggregation_weights)):
            np.testing.assert_allclose(
                tf_(_t(w), _t(m), tc).numpy(),
                np.asarray(jf(jnp.asarray(w), jnp.asarray(m), jc)), **RTOL)


def _stack(rng, n, dtype=np.float32):
    return {"a": rng.normal(size=(n, 5, 7)).astype(dtype),
            "b": {"c": rng.normal(size=(n, 13)).astype(dtype)},
            "e": np.zeros((n, 0), dtype)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_weighted_average_matches_jax(use_kernel):
    rng = np.random.default_rng(2)
    st = _stack(rng, 4)
    coefs = rng.dirichlet(np.ones(4)).astype(np.float32)
    want = jwssl.weighted_average(jax.tree.map(jnp.asarray, st),
                                  jnp.asarray(coefs))
    got = wssl.weighted_average(jax.tree.map(_t, st), _t(coefs),
                                use_kernel=use_kernel)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_weighted_average_bf16_and_plain_kernel_version():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 41)).astype(np.float32)
    w = rng.dirichlet(np.ones(3)).astype(np.float32)
    want = jref.weighted_average_2d(jnp.asarray(x), jnp.asarray(w))
    got = ref.weighted_average_2d(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    xb = torch.tensor(x).to(torch.bfloat16)
    out = ops.weighted_average(xb, _t(w))
    assert out.dtype == torch.bfloat16
    exact = (_t(w) @ xb.float())
    np.testing.assert_allclose(out.float().numpy(), exact.numpy(),
                               rtol=2 ** -7, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        wavg_mod.weighted_average_2d(torch.tensor(x), _t(w))


@pytest.mark.parametrize("rule", ["importance", "uniform"])
@pytest.mark.parametrize("safe", [False, True])
def test_aggregate_clients_matches_jax(rule, safe):
    rng = np.random.default_rng(4)
    st = _stack(rng, 4)
    imp = rng.dirichlet(np.ones(4)).astype(np.float32)
    mask = np.array([0, 1, 1, 0], np.float32)
    jc = JWSSLConfig(num_clients=4, agg=JAggregationConfig(rule=rule))
    tc = WSSLConfig(num_clients=4, agg=AggregationConfig(rule=rule))
    want = jagg.aggregate_clients(jax.tree.map(jnp.asarray, st),
                                  jnp.asarray(imp), jnp.asarray(mask), jc,
                                  safe=safe)
    for use_kernel in (False, True):
        got = agg.aggregate_clients(jax.tree.map(_t, st), _t(imp), _t(mask),
                                    tc, safe=safe, use_kernel=use_kernel)
        for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                        jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_registry_names_and_every_rule_ported():
    assert agg.list_aggregators() == jagg.list_aggregators()
    rng = np.random.default_rng(5)
    st = jax.tree.map(_t, _stack(rng, 4))
    ones = torch.ones(4)
    for name in agg.list_aggregators():
        cfg = WSSLConfig(num_clients=4, agg=AggregationConfig(rule=name))
        out = agg.aggregate_clients(st, ones / 4, ones, cfg)
        assert [tuple(a.shape) for a in jax.tree.leaves(out)] == [
            tuple(a.shape[1:]) for a in jax.tree.leaves(st)], name
    with pytest.raises(KeyError):
        agg.get_aggregator("nope")
    p = agg.agg_params(AggregationConfig(multi_krum_m=3))
    assert p.multi_krum_m == 3.0 and p.byzantine_f == 1.0


def test_user_rule_registers_and_dispatches():
    calls = []

    @agg.register_aggregator("first_client_test")
    def _first(stacked, importance, mask, params, *, safe=False,
               use_kernel=False):
        calls.append(params)
        return jax.tree.map(lambda a: a[0], stacked)

    cfg = WSSLConfig(num_clients=2, agg=AggregationConfig(
        rule="first_client_test"))
    out = agg.aggregate_clients({"w": torch.arange(4.).reshape(2, 2)},
                                torch.ones(2), torch.ones(2), cfg)
    assert out["w"].tolist() == [0.0, 1.0] and len(calls) == 1


def test_staleness_weights_match_jax():
    s = np.array([0, 1, 2, 3, 4, 7], np.float32)
    for kind in ("constant", "polynomial", "exponential"):
        want = jwssl.staleness_weights(jnp.asarray(s), 4, kind=kind,
                                       alpha=0.5)
        got = wssl.staleness_weights(_t(s), 4, kind=kind, alpha=0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **RTOL)
        assert got[0] == 1.0 and got[4] == 0.0
    fresh = np.array([1, 0, 0, 1, 0, 0], np.float32)
    arr = np.array([0, 1, 1, 0, 1, 0], np.float32)
    np.testing.assert_allclose(
        wssl.async_contribution(_t(fresh), _t(arr), _t(s), 4).numpy(),
        np.asarray(jwssl.async_contribution(jnp.asarray(fresh),
                                            jnp.asarray(arr), jnp.asarray(s),
                                            4)), **RTOL)
    with pytest.raises(ValueError):
        wssl.staleness_weights(_t(s), 4, kind="linear")


def test_broadcast_global_in_place():
    st = {"w": torch.arange(6.).reshape(3, 2)}
    ptr = st["w"].data_ptr()
    out = wssl.broadcast_global(st, {"w": torch.tensor([7.0, 8.0])})
    assert out is st and st["w"].data_ptr() == ptr
    assert st["w"].tolist() == [[7.0, 8.0]] * 3


@pytest.mark.parametrize("arch", ["gemma-2b"])
@pytest.mark.parametrize("wkw", [{}, {"split_layer": 2},
                                 {"split_layers": (2, 5, 9)}])
def test_wssl_config_resolution_matches_jax(arch, wkw):
    jm, tm = jax_get_arch(arch), get_arch(arch)
    for layers in (2, 3, 18):
        jc = JWSSLConfig(**wkw)
        tc = WSSLConfig(**wkw)
        jmod, tmod = jm.replace(num_layers=layers), tm.replace(num_layers=layers)
        try:
            want = jc.resolve_cuts(jmod)
        except ValueError:
            with pytest.raises(ValueError):
                tc.resolve_cuts(tmod)
            continue
        assert tc.resolve_cuts(tmod) == want
        assert tc.num_selected() == jc.num_selected()


def test_training_configs_copy_jax_defaults_and_refuse_unported():
    import dataclasses
    from repro.config import CompressionConfig as JCompressionConfig
    from repro.config import TrainConfig as JTrainConfig

    def defaults(cls):
        # a nested config block compares by its fields
        return {f.name: dataclasses.asdict(f.default)
                if dataclasses.is_dataclass(f.default) else f.default
                for f in dataclasses.fields(cls) if f.name != "async_rounds"}

    for jcls, tcls in ((JWSSLConfig, WSSLConfig),
                       (JTrainConfig, TrainConfig),
                       (JAggregationConfig, AggregationConfig),
                       (JCompressionConfig, CompressionConfig)):
        assert defaults(jcls) == defaults(tcls)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 10"):
        AsyncRoundsConfig(deadline=2.0)
    for scheme in ("none", "topk", "int8", "int4"):
        got = CompressionConfig(scheme=scheme, rate=0.1, activations=True)
        want = JCompressionConfig(scheme=scheme, rate=0.1, activations=True)
        assert (got.kind, got.bits, got.enabled) == (want.kind, want.bits,
                                                     want.enabled)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        CompressionConfig(scheme="int2")
    with pytest.raises(ValueError):
        TrainConfig(optimizer="sgd", fused_adam=True)
    with pytest.raises(ValueError):
        AggregationConfig(rule="nope")
    assert not WSSLConfig().compression.enabled
    assert not WSSLConfig().async_rounds.enabled


def test_byte_accounting_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.normal(size=(2, 3)).astype(np.float32),
            "b": [np.zeros((5,), np.float32)]}
    tt = jax.tree.map(_t, tree)
    tt["c"] = torch.zeros((4, 4), dtype=torch.bfloat16)
    jt = dict(tree, c=jnp.zeros((4, 4), jnp.bfloat16))
    assert tree_bytes(tt) == jax_tree_bytes(jt) == 24 + 20 + 32
    assert float(sync_round_bytes(torch.tensor(2.0), 4, 100.0)) == float(
        jax_sync_bytes(jnp.float32(2.0), 4, 100.0)) == 600.0
