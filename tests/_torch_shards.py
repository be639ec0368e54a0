"""What one rank of the sharded-round tests runs.

``tests/test_torch_sharded_*.py`` spawn gloo ranks on the CPU through
``repro_torch.launch.mesh.spawn_client_shards``; a spawned rank unpickles
its function from this module, which imports no JAX (the test modules
do), so a rank starts in the time it takes to import torch.

A case is a dict:

* ``cfg``: the port's ``(ModelConfig, WSSLConfig, TrainConfig)``;
* ``impl``: the training attention path;
* ``init``: the JAX initial state as nested namespaces of numpy arrays
  (``jax_namespace``), which ``_bridge.state_from_jax`` reads;
* ``rounds``: one dict a round: ``batch`` (numpy (N, ...)), ``gumbel``
  (N,), and optionally ``comp`` (leaf -> the (S, N/S, m) JAX update
  compression draws: each rank takes its shard's) and ``dropout`` (N,);
* ``val``: the validation batch (numpy); ``scenario``: the port's
  ``ScenarioParams`` or None; ``async_p``: the port's ``AsyncParams``,
  or None for the sync round;
* ``sync_too``: also run the sync round from the same state and draws
  (the async round at deadline inf against it, bit for bit).

A rank returns, for each run, every round's metrics and its final state
(``_bridge.state_to_numpy``, this shard's rows), the async state too.
"""

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch import sim
from repro_torch._bridge import (async_state_to_numpy, state_from_jax,
                                 state_to_numpy)
from repro_torch.core.async_round import (init_async_state,
                                          make_sharded_async_round_fn)
from repro_torch.core.round import TAG_UPDATE, make_sharded_round_fn


def jax_namespace(tree):
    """A JAX state (NamedTuples of arrays) as namespaces of numpy arrays:
    what ``state_from_jax`` reads, and what a rank can unpickle without
    JAX."""
    if hasattr(tree, "_fields"):
        return SimpleNamespace(**{f: jax_namespace(getattr(tree, f))
                                  for f in tree._fields})
    if isinstance(tree, dict):
        return {k: jax_namespace(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_namespace(v) for v in tree)
    return np.asarray(tree)


def metrics_numpy(m):
    """A RoundMetrics (or AsyncRoundMetrics) as a dict of numpy values."""
    out = {}
    for f in m._fields:
        v = getattr(m, f)
        if hasattr(v, "_fields"):
            out[f] = metrics_numpy(v)
        elif torch.is_tensor(v):
            out[f] = v.detach().cpu().numpy()
        else:
            out[f] = np.asarray(v, np.float64)
    return out


def _uniform(comp, index):
    """The injected compression draws of shard ``index``."""
    if comp is None:
        return None

    def draw(tag, leaf, shape):
        assert tag == TAG_UPDATE, tag
        u = comp[leaf][index]
        assert tuple(u.shape) == tuple(shape), (leaf, u.shape, shape)
        return torch.as_tensor(u)
    return draw


def _draws(rd, index):
    dropout = rd.get("dropout")
    return dict(gumbel=torch.as_tensor(rd["gumbel"]),
                comp_uniform=_uniform(rd.get("comp"), index),
                fault_draws=None if dropout is None else sim.FaultDraws(
                    dropout=torch.as_tensor(dropout)))


def _run(case, group, device, sync):
    cfg, w, t = case["cfg"]
    val = {k: torch.as_tensor(v, device=device)
           for k, v in case["val"].items()}
    whole = state_from_jax(case["init"], cfg, device=device)
    if sync:
        rf = make_sharded_round_fn(cfg, w, t, group, impl=case["impl"])
        state = rf.place_state(whole)
        astate = None
    else:
        rf = make_sharded_async_round_fn(cfg, w, t, group, impl=case["impl"])
        state = rf.place_state(whole)
        astate = rf.place_astate(init_async_state(whole))
    del whole
    metrics, astates = [], []
    for rd in case["rounds"]:
        batch = rf.place_batch({k: torch.as_tensor(v, device=device)
                                for k, v in rd["batch"].items()})
        kw = _draws(rd, group.index)
        if sync:
            _, m = rf(state, batch, val, case["scenario"], **kw)
        else:
            _, _, m = rf(state, astate, batch, val, case["scenario"],
                         case["async_p"], **kw)
            astates.append(async_state_to_numpy(astate))
        metrics.append(metrics_numpy(m))
    return {"metrics": metrics, "state": state_to_numpy(state),
            "astates": astates}


def run_case(group, device, case):
    """One rank of a case: the sync or the async round, and with
    ``sync_too`` the sync round beside the async one."""
    out = {"index": group.index, "num_shards": group.num_shards,
           "backend": group.backend}
    out["run"] = _run(case, group, device, sync=case["async_p"] is None)
    if case.get("sync_too"):
        out["sync"] = _run(case, group, device, sync=True)
    return out


def run_cases(group, device, cases):
    """:func:`run_case` for each case in turn, in the same ranks."""
    return [run_case(group, device, case) for case in cases]


def aggregate_rules(group, device, stacked, importance, mask, rules):
    """``shard_aggregate_clients`` of each rule on this rank's rows of
    ``stacked`` (numpy leaves (N, ...)): rule -> the global stage
    (numpy)."""
    from repro_torch import sharding
    from repro_torch.config import AggregationConfig, WSSLConfig
    from repro_torch.core import aggregation
    n = next(iter(stacked.values())).shape[0]
    local = sharding.shard_batch({k: torch.as_tensor(v, device=device)
                                  for k, v in stacked.items()},
                                 group.num_shards, group.index)
    out = {}
    for rule in rules:
        cfg = WSSLConfig(num_clients=n, agg=AggregationConfig(
            rule=rule, byzantine_f=1))
        got = aggregation.shard_aggregate_clients(
            local, torch.as_tensor(importance, device=device),
            torch.as_tensor(mask, device=device), cfg, group=group.group,
            shard_index=group.index, num_shards=group.num_shards)
        out[rule] = {k: v.cpu().numpy() for k, v in got.items()}
    return out


def fail_on_rank(group, device, rank):
    """Raise on one rank; the others return."""
    if group.index == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    return group.index


def sleep_past(group, device, seconds):
    import time
    time.sleep(seconds)
