"""The port's robust aggregation rules (``core/aggregation.py``,
``core/wssl.py``'s aliases) against ``repro.core.aggregation`` on the same
numpy inputs, and the round and the paper loop under every rule and under
compressed uploads against the live JAX round and loop.

Bands:

* Every rule over masks (all on, partial, fractional, empty, one
  survivor) and dynamic knobs (f, m, trim, clip): atol 1e-6 at inputs of
  O(1) (sums and norms in PyTorch's order: measured 2.4e-7 at most).  On
  integer-valued inputs every sum is exact, and so is every rule: Krum's
  scores, its tie-break (identical clients: the lowest index) and
  Multi-Krum's stable order equal JAX's bit for bit.
* Krum on random inputs: the scores within rel 1e-5, and the chosen
  client equal to JAX's wherever the two lowest scores differ by more
  than rel 1e-4 (the Gram form cancels; its rounding is far below).
* The round under ``scaled-grad-adversary`` with each robust rule, from
  client rows offset apart (so that Krum's choice is clear, not rounding),
  against the live jitted JAX round with its draws injected: as
  ``test_torch_sim.py`` holds the round (masks and bytes exact, losses rel
  1e-5, stages within the bands scaled by the x32 update).
* The paper loop (gait, 4 clients) under each robust rule, and under int8,
  int4 and top-k uploads with JAX's compression draws injected (JAX's
  compression ops run their oracles): selections, drops and byte counts
  exact; losses, importance and accuracy within ``test_torch_paper.py``'s
  gait bands (atol 1e-5, 1e-6 and one test example; measured at most
  1.2e-7, 6.0e-8 and 0, the compressed runs included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import test_torch_sim as ts
from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import AggregationConfig as JAggregationConfig
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core import aggregation as jagg
from repro.core import wssl as jwssl
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.config import (AggregationConfig, CompressionConfig,
                                WSSLConfig)
from repro_torch.core import aggregation as agg
from repro_torch.core import wssl

ROBUST = ("trimmed_mean", "median", "krum", "multi_krum", "geometric_median",
          "norm_clip")


def _t(a):
    return torch.as_tensor(np.array(a))


def _stack(rng, n, integer=False):
    draw = ((lambda *s: rng.integers(-4, 5, size=s).astype(np.float32))
            if integer else
            (lambda *s: rng.normal(size=s).astype(np.float32)))
    return {"b": draw(n, 3, 5), "a": draw(n, 7), "w": {"z": draw(n)},
            "e": np.zeros((n, 0), np.float32)}


def _masks(rng, n):
    one = np.zeros(n, np.float32)
    one[n // 2] = 1.0
    return {"all": np.ones(n, np.float32),
            "partial": (np.arange(n) % 3 != 1).astype(np.float32),
            "fractional": np.where(rng.random(n) > 0.4, 0.3, 0.0).astype(
                np.float32) + np.eye(n, dtype=np.float32)[0] * 0.5,
            "empty": np.zeros(n, np.float32), "single": one}


PARAMS = [(0.1, 1.0, 0.0, 1.0), (0.3, 2.0, 2.0, 0.5), (0.5, 0.0, 5.0, 3.0),
          (0.0, 4.0, 1.0, 0.1)]


def _run(name, st, imp, mask, p, safe=True):
    j = jagg.get_aggregator(name).fn(jax.tree.map(jnp.asarray, st),
                                     jnp.asarray(imp), jnp.asarray(mask),
                                     jagg.AggParams(*p), safe=safe)
    t = agg.get_aggregator(name).fn(jax.tree.map(_t, st), _t(imp), _t(mask),
                                    agg.AggParams(*p), safe=safe)
    return t, j


def _leaves_equal(t, j, atol):
    tl, jl = jax.tree.leaves(t), jax.tree.leaves(j)
    assert [x.shape for x in tl] == [x.shape for x in jl]
    for a, b in zip(tl, jl):
        if atol == 0:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("name", ROBUST)
@pytest.mark.parametrize("n", [4, 5, 8])
def test_rule_matches_jax_over_masks_and_knobs(name, n):
    rng = np.random.default_rng(n)
    st = _stack(rng, n)
    imp = rng.dirichlet(np.ones(n)).astype(np.float32)
    for mask in _masks(rng, n).values():
        for p in PARAMS:
            for safe in (True, False):
                t, j = _run(name, st, imp, mask, p, safe)
                _leaves_equal(t, j, 1e-6)


@pytest.mark.parametrize("name", ROBUST)
def test_rule_exact_on_integer_inputs_with_ties(name):
    rng = np.random.default_rng(11)
    st = _stack(rng, 6, integer=True)
    # clients 1, 2 and 4 identical: Krum's scores tie among them
    for leaf in jax.tree.leaves(st):
        leaf[2] = leaf[1]
        leaf[4] = leaf[1]
    imp = np.full(6, 1 / 6, np.float32)
    for mask in _masks(rng, 6).values():
        for p in PARAMS:
            t, j = _run(name, st, imp, mask, p)
            if name in ("krum", "multi_krum", "median", "trimmed_mean"):
                _leaves_equal(t, j, 0)
            else:
                _leaves_equal(t, j, 1e-6)
    for mask in _masks(rng, 6).values():
        for f in (0.0, 1.0, 2.0, 3.0, 5.0):
            ts_ = agg.krum_scores(jax.tree.map(_t, st), _t(mask), f)
            js_ = jagg.krum_scores(jax.tree.map(jnp.asarray, st),
                                   jnp.asarray(mask), f)
            np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))


def test_krum_choice_matches_jax_where_the_gap_is_clear():
    compared = 0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(4, 10))
        st = _stack(rng, n)
        mask = (rng.random(n) > 0.2).astype(np.float32)
        f = float(rng.integers(0, 3))
        ts_ = agg.krum_scores(jax.tree.map(_t, st), _t(mask), f).numpy()
        js_ = np.asarray(jagg.krum_scores(jax.tree.map(jnp.asarray, st),
                                          jnp.asarray(mask), f))
        fin = np.isfinite(js_)
        assert (np.isfinite(ts_) == fin).all()
        np.testing.assert_allclose(ts_[fin], js_[fin], rtol=1e-5)
        low = np.sort(js_[fin])
        if len(low) > 1 and low[1] - low[0] > 1e-4 * abs(low[1]):
            compared += 1
            assert np.argmin(ts_) == np.argmin(js_)
    assert compared >= 15


def test_trim_bound_is_computed_in_fp32():
    """trim 0.7 / s 10 and friends: the fp32 product decides k, as JAX's
    traced scalars do (a float64 product can land on the other side of an
    integer)."""
    rng = np.random.default_rng(5)
    for n in (3, 7, 10, 12):
        st = _stack(rng, n)
        for trim in (0.1, 0.2, 0.3, 0.35, 0.45, 0.5):
            t, j = _run("trimmed_mean", st, np.ones(n, np.float32) / n,
                        np.ones(n, np.float32), (trim, 1.0, 0.0, 1.0))
            _leaves_equal(t, j, 1e-6)


def test_wssl_aliases_and_dispatch():
    rng = np.random.default_rng(7)
    st = _stack(rng, 5)
    mask = np.array([1, 0, 1, 1, 1], np.float32)
    imp = rng.dirichlet(np.ones(5)).astype(np.float32)
    t = wssl.trimmed_mean_average(jax.tree.map(_t, st), _t(mask), 0.25)
    j = jwssl.trimmed_mean_average(jax.tree.map(jnp.asarray, st),
                                   jnp.asarray(mask), 0.25)
    _leaves_equal(t, j, 1e-6)
    for rule in ROBUST + ("importance", "uniform"):
        cfg = WSSLConfig(num_clients=5, agg=AggregationConfig(
            rule=rule, byzantine_f=1, trim_fraction=0.2))
        jcfg = JWSSLConfig(num_clients=5, agg=JAggregationConfig(
            rule=rule, byzantine_f=1, trim_fraction=0.2))
        t = wssl.aggregate_clients(jax.tree.map(_t, st), _t(imp), _t(mask),
                                   cfg, safe=True)
        j = jwssl.aggregate_clients(jax.tree.map(jnp.asarray, st),
                                    jnp.asarray(imp), jnp.asarray(mask),
                                    jcfg, safe=True)
        _leaves_equal(t, j, 1e-6)
    # the legacy ``aggregation`` string names the rule too
    cfg = WSSLConfig(num_clients=5, aggregation="trimmed_mean",
                     trim_fraction=0.2)
    jcfg = JWSSLConfig(num_clients=5, aggregation="trimmed_mean",
                       trim_fraction=0.2)
    _leaves_equal(agg.aggregate_clients(jax.tree.map(_t, st), _t(imp),
                                        _t(mask), cfg),
                  jagg.aggregate_clients(jax.tree.map(jnp.asarray, st),
                                         jnp.asarray(imp), jnp.asarray(mask),
                                         jcfg), 1e-6)


def test_registry_flags_equal_jax():
    for name in jagg.list_aggregators():
        t, j = agg.get_aggregator(name), jagg.get_aggregator(name)
        assert (t.weighted, t.decomposes) == (j.weighted, j.decomposes), name
    p = agg.agg_params(AggregationConfig(trim_fraction=0.1, multi_krum_m=3,
                                         clip_factor=0.3))
    jp = jagg.agg_params(JAggregationConfig(trim_fraction=0.1,
                                            multi_krum_m=3, clip_factor=0.3))
    assert tuple(p) == tuple(float(v) for v in jp)


def test_krum_returns_a_copy():
    """The sync writes the aggregate into the stack it came from."""
    st = {"w": torch.arange(12.).reshape(4, 3)}
    out = agg.krum_average(st, torch.ones(4), 1.0)
    assert out["w"].data_ptr() != st["w"].data_ptr()
    wssl.broadcast_global(st, out)
    assert all(torch.equal(st["w"][i], st["w"][0]) for i in range(4))


# ---------------------------------------------------------------------------
# The round and the paper loop under every rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ROBUST)
def test_round_under_robust_rule_matches_live_jax(rule):
    # clients start a round on one stage, and AdamW's first step moves
    # every coordinate by +-lr: the honest clients' distances then differ
    # below the Gram form's resolution (JAX's three honest Krum scores
    # tied at 0.0227, the port's 0.0226 / 0.0223), so the choice would be
    # rounding.  Offset rows (N(0, 0.01^2) a coordinate) make it clear.
    ts.check_against_jax("single", "scaled-grad-adversary", rule=rule,
                         spread=0.01)


@pytest.mark.parametrize("rule", ROBUST)
def test_paper_loop_under_robust_rule_matches_live_jax(rule):
    h, jh, n_test = ts.run_paper_pair(
        "scaled-grad-adversary",
        wkw=(("agg", AggregationConfig(rule=rule)),),
        jwkw=(("agg", JAggregationConfig(rule=rule)),))
    ts.check_paper(h, jh, n_test)


def _jax_comp_uniform(seed):
    key = jax.random.PRNGKey(7919 * seed + 3)

    def u(r, leaf, shape):
        k = jax.random.fold_in(jax.random.fold_in(key, r), leaf)
        return _t(jax.random.uniform(k, shape, jnp.float32))
    return u


@pytest.mark.parametrize("scheme", ["int8", "int4", "topk"])
def test_paper_loop_compressed_matches_live_jax(scheme):
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d,
                             topk_mask=jax_ref.topk_mask_2d):
        h, jh, n_test = ts.run_paper_pair(
            "sign-flip-adversary",
            wkw=(("compression", CompressionConfig(scheme=scheme)),
                 ("agg", AggregationConfig(rule="krum"))),
            jwkw=(("compression", JCompressionConfig(scheme=scheme)),
                  ("agg", JAggregationConfig(rule="krum"))),
            tkw=(("comp_uniform", _jax_comp_uniform(0)),))
    ts.check_paper(h, jh, n_test)
    assert h["comm"]["update_comp_MB"] < h["comm"]["update_raw_MB"]
