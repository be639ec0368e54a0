"""The client axis of the port's sharded rounds on the host: the
two-level aggregation tree, the byte model, the leaf rule, sharding a
state and merging it back, and the process group (gloo ranks on the CPU).

* ``aggregation.tree_aggregate`` against JAX's for every registered rule
  at S 2 and 4 (1e-6: the robust rules sum in PyTorch's order), and
  against the port's flat ``aggregate_clients``: 1e-6 for the decomposable
  rules, exact for the all_gather fallback; ``rule_decomposes`` equal to
  JAX's for every rule.
* ``protocol.hierarchical_sync_bytes`` equal to JAX's on both branches.
* ``sharding.round_state_specs`` equal, leaf for leaf, to JAX's
  ``round_state_specs`` on a three-stage ``WSSLState`` with error-feedback
  residuals and on an ``AsyncState``; ``shard_state`` then
  ``merge_shards`` gives the state back bit for bit (generator too) at S
  1, 2 and 4; ``init_shard_state`` equals ``shard_state(init_state)``.
* N % S != 0 raises ``ValueError`` (``test_uneven_clients_rejected``'s
  wording).
* ``shard_aggregate_clients`` at S 2 on gloo ranks against JAX's under
  ``jax.vmap(axis_name=...)``, every rule, 1e-6.
* ``spawn_client_shards``: a rank's exception re-raises in the caller, a
  run past its timeout raises ``TimeoutError``, and the CPU default
  backend is gloo.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

import _jax_shards as js
import _torch_shards as ts
from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import AggregationConfig as JAggregationConfig
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core import aggregation as jagg
from repro.core.protocol import hierarchical_sync_bytes as jax_hier_bytes
from repro.core.round import init_state as jax_init_state
from repro_torch import sharding
from repro_torch._bridge import state_from_jax
from repro_torch.config import (AggregationConfig, CompressionConfig,
                                ModelConfig, TrainConfig, WSSLConfig)
from repro_torch.core import aggregation
from repro_torch.core.async_round import init_async_state
from repro_torch.core.protocol import hierarchical_sync_bytes
from repro_torch.core.round import init_state
from repro_torch.launch.mesh import (ClientGroup, default_backend,
                                     make_client_group, spawn_client_shards)
from repro_torch.tree import tree_leaves

RULES = aggregation.list_aggregators()
N = 8


def _stack(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32)}


def _vectors():
    rng = np.random.default_rng(7)
    imp = rng.dirichlet(np.ones(N)).astype(np.float32)
    mask = np.asarray([1, 0, 1, 1, 0, 1, 1, 0], np.float32)
    return imp, mask


def _cfgs(rule):
    return (JWSSLConfig(num_clients=N, agg=JAggregationConfig(
        rule=rule, byzantine_f=1)),
            WSSLConfig(num_clients=N, agg=AggregationConfig(
                rule=rule, byzantine_f=1)))


def test_registries_agree():
    assert RULES == jagg.list_aggregators()
    for rule in RULES:
        jw, w = _cfgs(rule)
        assert aggregation.rule_decomposes(w) == jagg.rule_decomposes(jw)
    assert [r for r in RULES if aggregation.get_aggregator(r).decomposes] \
        == ["importance", "uniform"]


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("shards", [2, 4])
def test_tree_aggregate_matches_jax_and_the_flat_rule(rule, shards):
    jw, w = _cfgs(rule)
    stacked = _stack()
    imp, mask = _vectors()
    t = {k: torch.as_tensor(v) for k, v in stacked.items()}
    got = aggregation.tree_aggregate(t, torch.as_tensor(imp),
                                     torch.as_tensor(mask), w,
                                     num_shards=shards)
    want = jagg.tree_aggregate({k: jnp.asarray(v) for k, v in stacked.items()},
                               jnp.asarray(imp), jnp.asarray(mask), jw,
                               num_shards=shards)
    flat = aggregation.aggregate_clients(t, torch.as_tensor(imp),
                                         torch.as_tensor(mask), w)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)
        if aggregation.rule_decomposes(w):
            np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                       atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(got[k].numpy(), flat[k].numpy())


@pytest.mark.parametrize("decomposes", [True, False])
def test_hierarchical_sync_bytes_match_jax(decomposes):
    for sel, n, s, stage in ((4.0, 8, 2, 1234.0), (7.0, 64, 4, 98304.0),
                             (0.0, 16, 8, 3.5e6)):
        got = hierarchical_sync_bytes(
            torch.tensor(sel, dtype=torch.float32), n, s,
            torch.tensor(stage, dtype=torch.float32), decomposes)
        want = jax_hier_bytes(jnp.float32(sel), n, s, jnp.float32(stage),
                              decomposes)
        for g, x in zip(got, want):
            assert g.dtype == torch.float32
            assert float(g) == float(x)
    cross, intra = hierarchical_sync_bytes(4.0, 8, 2, 10.0, True)
    assert (cross, intra) == (40.0, 40.0)
    assert hierarchical_sync_bytes(4.0, 8, 2, 10.0, False) == (60.0, 40.0)


# ---------------------------------------------------------------------------
# the leaf rule, shard_state / merge_shards
# ---------------------------------------------------------------------------

TINY3 = dict(name="tiny-shard3", num_layers=3, d_model=32, num_heads=2,
             num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
             param_dtype="float32")
W_KW = dict(num_clients=N, split_layers=(1, 2), hop_replicas=2)


def _states():
    jm, jw = JModelConfig(**TINY3), JWSSLConfig(
        compression=JCompressionConfig(scheme="int8"), **W_KW)
    jt = JTrainConfig()
    jstate, _ = jax_init_state(jax.random.PRNGKey(0), jm, jw, jt)
    cfg = ModelConfig(**TINY3)
    state = state_from_jax(ts.jax_namespace(jax.tree.map(np.asarray, jstate)),
                           cfg, device="cpu")
    return (jm, jw, jt), jstate, state


def _port_marks(tree):
    """A spec tree's markers in the JAX leaf order (optimizer states as
    step, then moments)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [m for f in dataclasses.fields(tree)
                for m in _port_marks(getattr(tree, f.name))]
    if isinstance(tree, tuple) and tree and dataclasses.is_dataclass(tree[0]):
        return [m for t in tree for m in _port_marks(t)]
    return tree_leaves(tree)


def _jax_marks(axes):
    return [sharding.CLIENT if a == 0 else sharding.REPLICATED
            for a in jax.tree.flatten(axes, is_leaf=lambda x: x is None)[0]]


def test_leaf_rule_matches_jax_round_state_specs():
    (jm, jw, jt), _, state = _states()
    assert tree_leaves(state.ef_residual)           # error feedback is on
    assert len(state.edge_stages) == 1
    axes = js.state_in_axes(jm, jw, jt)
    specs = sharding.round_state_specs(state)
    for f in ("client_stack", "server_params", "edge_stages", "opt_client",
              "opt_server", "opt_edge", "importance", "round_index", "rng",
              "ef_residual"):
        want = _jax_marks(getattr(axes, f))
        got = _port_marks(getattr(specs, f))
        assert got == want, f
    assert set(_port_marks(specs.client_stack)) == {sharding.CLIENT}
    aspecs = sharding.round_state_specs(init_async_state(state))
    a_axes = js.async_in_axes(axes)
    for f in ("pending", "staleness", "buffer"):
        assert _port_marks(getattr(aspecs, f)) == _jax_marks(
            getattr(a_axes, f)), f


def _same(a, b):
    la, lb = sharding.tree_leaves_state(a), sharding.tree_leaves_state(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert x.initial_seed() == y.initial_seed()
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_then_merge_round_trips(shards):
    _, _, state = _states()
    astate = init_async_state(state)
    for leaf in tree_leaves(astate.buffer):
        leaf.normal_()
    astate.pending[3] = 2
    parts = [sharding.shard_state(state, shards, i) for i in range(shards)]
    aparts = [sharding.shard_state(astate, shards, i) for i in range(shards)]
    for i, (p, a) in enumerate(zip(parts, aparts)):
        rows = tree_leaves(p.client_stack)[0].shape[0]
        assert rows == N // shards
        assert p.importance.shape == (N,) and a.pending.shape == (N,)
        assert torch.equal(tree_leaves(p.client_stack)[0],
                           tree_leaves(state.client_stack)[0][
                               i * rows:(i + 1) * rows])
        # every shard's generator is a copy at the whole state's point of
        # its stream
        assert p.rng is not state.rng
        assert torch.equal(p.rng.get_state(), state.rng.get_state())
    # copies: the whole state survives what a shard does in place
    before = tree_leaves(state.client_stack)[0].clone()
    tree_leaves(parts[0].client_stack)[0].zero_()
    assert torch.equal(tree_leaves(state.client_stack)[0], before)
    _same(sharding.merge_shards([sharding.shard_state(state, shards, i)
                                 for i in range(shards)]), state)
    _same(sharding.merge_shards(aparts), astate)
    batch = {"tokens": torch.arange(N * 6).reshape(N, 2, 3)}
    got = torch.cat([sharding.shard_batch(batch, shards, i)["tokens"]
                     for i in range(shards)])
    assert torch.equal(got, batch["tokens"])


def test_init_shard_state_is_shard_state_of_init_state():
    cfg = ModelConfig(**TINY3)
    w = WSSLConfig(compression=CompressionConfig(scheme="int8"), **W_KW)
    t = TrainConfig()
    whole = init_state(torch.Generator().manual_seed(3), cfg, w, t,
                       device="cpu")
    for i in range(4):
        got = sharding.init_shard_state(torch.Generator().manual_seed(3),
                                        cfg, w, t, 4, i, device="cpu")
        _same(got, sharding.shard_state(whole, 4, i))


def test_uneven_clients_rejected():
    _, _, state = _states()
    with pytest.raises(ValueError, match="divide evenly"):
        sharding.shard_state(state, 3, 0)
    with pytest.raises(ValueError, match="divide evenly"):
        sharding.shard_batch({"tokens": torch.zeros(6, 2)}, 4, 1)
    from repro_torch.core.async_round import make_sharded_async_round_fn
    group = ClientGroup(group=None, num_shards=3, index=0, backend="gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_async_round_fn(ModelConfig(**TINY3), WSSLConfig(
            **W_KW), TrainConfig(), group)


# ---------------------------------------------------------------------------
# gloo ranks
# ---------------------------------------------------------------------------


def test_shard_aggregate_clients_on_gloo_ranks_matches_jax_vmap():
    stacked = _stack(seed=5)
    imp, mask = _vectors()
    ranks = spawn_client_shards(ts.aggregate_rules, 2, stacked, imp, mask,
                                RULES, device="cpu", timeout=60.0, threads=1)
    split = {k: jnp.asarray(v).reshape((2, N // 2) + v.shape[1:])
             for k, v in stacked.items()}
    for rule in RULES:
        jw, _ = _cfgs(rule)
        fn = jax.jit(jax.vmap(
            lambda st, i, m, jw=jw: jagg.shard_aggregate_clients(
                st, i, m, jw, axis_name="d",
                shard_index=jax.lax.axis_index("d"), num_shards=2),
            in_axes=(0, None, None), axis_name="d"))
        want = fn(split, jnp.asarray(imp), jnp.asarray(mask))
        for k in stacked:
            for r in ranks:
                np.testing.assert_allclose(r[rule][k], np.asarray(want[k][0]),
                                           atol=1e-6, rtol=0,
                                           err_msg=f"{rule} {k}")
            np.testing.assert_array_equal(ranks[0][rule][k], ranks[1][rule][k])


def test_spawn_reraises_a_rank_exception_and_times_out():
    assert default_backend("cpu", 2) == "gloo"
    with pytest.raises(ProcessRaisedException, match="rank 1 failed"):
        spawn_client_shards(ts.fail_on_rank, 2, 1, device="cpu",
                            timeout=30.0, threads=1)
    with pytest.raises(TimeoutError, match="still running"):
        spawn_client_shards(ts.sleep_past, 2, 120.0, device="cpu",
                            timeout=8.0, threads=1)
    with pytest.raises(RuntimeError, match="no process group"):
        make_client_group(2)
