"""The paper loop under a finite async deadline (``core/paper_loop.py``),
against the live JAX loop.

The gait FFN and data of ``tests/test_async.py``'s paper-loop case
(``make_gait_like(n=1200)``, 4 clients partitioned for the scenario, 4
rounds x 4 local steps, lr 2e-3), JAX's initial params and Gumbel draws
injected, under ``async-stragglers`` (clients 2 and 3 at 8x):

* deadline 4: the stragglers park their full local update and land it one
  round late (staleness 1), then park again;
* deadline 1: they would land at staleness 7 >= 4, so they are evicted at
  admission and resynced;
* deadline 4 with one buffer slot, participation 0.75, a busy / slow
  selection penalty and int8 uploads with error feedback: the overflow is
  evicted, the penalty steers the draw, and a parked delta crosses the
  wire the round it lands.

The history's async columns (``arrived``, ``buffered``, ``evicted``,
``mean_staleness``), the selections, participation and every byte count
(the eviction resync inside ``bytes_sync``, the ``CommLog`` summary) are
exact; losses, importance and accuracy within the gait bands of
``tests/test_torch_paper.py`` (test and validation losses atol 1e-5,
importance atol 1e-6, accuracy within one test example, the bands
``tests/test_torch_robust.py`` holds compressed uploads to as well).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.configs import wssl_paper as jcfgs
from repro.core import paper_loop as jpl
from repro.data import partition as jpart
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch import sim
from repro_torch.config import (AsyncRoundsConfig, CompressionConfig,
                                WSSLConfig)
from repro_torch.configs import wssl_paper as cfgs
from repro_torch.core import paper_loop as pl
from repro_torch.data import pipeline

CLIENTS, ROUNDS, STEPS, LR = 4, 4, 4, 2e-3

# name -> (async keywords, other WSSLConfig keywords)
RUNS = {
    "arrive": (dict(deadline=4.0, max_staleness=4), {}),
    "evict": (dict(deadline=1.0, max_staleness=4), {}),
    "overflow-int8": (dict(deadline=4.0, max_staleness=4, buffer_size=1),
                      dict(participation_fraction=0.75,
                           select_staleness_beta=1.0, scheme="int8")),
}


@functools.lru_cache(maxsize=None)
def _data():
    data = jsyn.make_gait_like(n=1200, seed=0)
    split = lambda lo, hi: {k: v[lo:hi] for k, v in data.items()}
    tr, val, test = split(0, 800), split(800, 1000), split(1000, 1200)
    parts = jpart.partition_for_scenario(
        tr["y"], CLIENTS, jsim.get_scenario("async-stragglers"), seed=0)
    loaders = lambda mod: [mod.ClientLoader({"x": tr["x"], "y": tr["y"]}, p,
                                            64, seed=i)
                           for i, p in enumerate(parts)]
    return val, test, loaders


def _cfg(mod, name):
    akw, wkw = RUNS[name]
    wkw = dict(wkw)
    scheme = wkw.pop("scheme", "none")
    wkw.setdefault("participation_fraction", 1.0)
    return mod.WSSLConfig(num_clients=CLIENTS,
                          compression=mod.CompressionConfig(scheme=scheme),
                          async_rounds=mod.AsyncRoundsConfig(**akw), **wkw)


class _Mods:
    jax = type("J", (), dict(WSSLConfig=JWSSLConfig,
                             CompressionConfig=JCompressionConfig,
                             AsyncRoundsConfig=JAsyncRoundsConfig))
    torch = type("T", (), dict(WSSLConfig=WSSLConfig,
                               CompressionConfig=CompressionConfig,
                               AsyncRoundsConfig=AsyncRoundsConfig))


@functools.lru_cache(maxsize=None)
def run_pair(name):
    """(the port's history, JAX's history, the test-set size)."""
    val, test, loaders = _data()
    jad = jpl.gait_adapter(jcfgs.GaitConfig())
    rng, sub = jax.random.split(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jad.init_split(sub))
    gumbels = []
    for _ in range(ROUNDS):
        rng, sub = jax.random.split(rng)
        gumbels.append(torch.tensor(np.asarray(
            jax.random.gumbel(sub, (CLIENTS,)))))
    common = dict(rounds=ROUNDS, local_steps=STEPS, lr=LR, seed=0)
    # the JAX ops run their oracles (the Pallas kernels cannot run here)
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d):
        jh = jpl.train_wssl(jad, loaders(jpipe), val, test,
                            _cfg(_Mods.jax, name),
                            scenario=jsim.get_scenario("async-stragglers"),
                            **common)
    h = pl.train_wssl(pl.gait_adapter(cfgs.GaitConfig()), loaders(pipeline),
                      val, test, _cfg(_Mods.torch, name),
                      scenario=sim.get_scenario("async-stragglers"),
                      device="cpu", init=init, gumbels=gumbels,
                      comp_uniform=_jax_comp_uniform(), **common)
    return h, jh, len(test["y"])


def _jax_comp_uniform():
    """The compressed upload's stochastic-rounding draws as the JAX loop
    makes them at seed 0: ``uniform(fold_in(fold_in(PRNGKey(7919 * seed +
    3), r), leaf), (N, m))``."""
    base = jax.random.PRNGKey(3)

    def draw(r, leaf, shape):
        k = jax.random.fold_in(jax.random.fold_in(base, r), leaf)
        return torch.as_tensor(np.array(jax.random.uniform(k, shape,
                                                           jnp.float32)))
    return draw


EXACT = ("round", "selected", "dropped", "participation", "bytes_up",
         "bytes_sync", "bytes_up_total", "bytes_sync_total", "scenario",
         "comm", "arrived", "buffered", "evicted", "mean_staleness")


@pytest.mark.parametrize("name", list(RUNS))
def test_paper_loop_async_matches_live_jax(name):
    h, jh, n_test = run_pair(name)
    for k in EXACT:
        assert h[k] == jh[k], k
    for k in ("test_loss", "val_loss"):
        np.testing.assert_allclose(h[k], jh[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(h["importance"], jh["importance"], rtol=0,
                               atol=1e-6)
    acc = np.abs(np.asarray(h["test_acc"]) - np.asarray(jh["test_acc"]))
    assert np.all(acc * n_test <= 1 + 1e-3), acc
    assert all(np.isfinite(h["train_loss"]))


def test_paper_loop_async_buffers_and_arrives():
    """``tests/test_async.py``'s assertions on the port's history: at
    deadline 4 the stragglers park in round 0 and land at staleness 1 in
    round 1; at deadline 1 they are evicted every round and resynced."""
    h, _, _ = run_pair("arrive")
    assert h["buffered"][0] == [2, 3] and h["arrived"][0] == []
    assert h["arrived"][1] == [2, 3] and h["mean_staleness"][1] == 1.0
    assert h["selected"][1] == [0, 1]          # busy clients take no work
    assert sum(h["evicted"]) == 0
    assert h["comm"]["stale_arrivals"] >= 2
    assert h["comm"]["mean_staleness"] == 1.0
    h1, _, _ = run_pair("evict")
    assert h1["evicted"] == [2] * ROUNDS
    assert all(a == [] for a in h1["arrived"])
    stage = h1["bytes_sync"][0] // (2 + CLIENTS + 2)
    assert h1["bytes_sync"][0] == (2 + CLIENTS) * stage + 2 * stage


def test_paper_loop_async_overflow_evicts():
    """One buffer slot: of the two late stragglers one parks and the other
    is evicted; the penalty keeps the busy client out of the next draw."""
    h, _, _ = run_pair("overflow-int8")
    assert h["buffered"][0] == [2] and h["evicted"][0] == 1
    assert h["arrived"][1] == [2] and 2 not in h["selected"][1]
