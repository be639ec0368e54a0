"""Paper-scale WSSL training loop: the paper's own experiment.

The twin of ``repro/core/paper_loop.py``.  It drives the paper's models
(the gait FFN, ResNet-18) through Algorithm 1 and Algorithm 2 over
communication rounds, against numpy data loaders — the experiment grid of
§V (2..10 clients x 20 rounds) — and the centralized baseline it is
compared with.  Selection and bookkeeping run on the host; each local step
is the two-phase split step of ``core/split.py`` followed by AdamW on both
stages, through ``kernels/ops.fused_adamw`` (the fused masked-AdamW CUDA
kernel on the card with ``mask=None``, one always-on row a leaf; its plain
version on the CPU).

What differs from the JAX loop, and why:

* Parameters and optimizer state are updated **in place**; the sync copies
  the aggregate into every client's tree.
* The random draws are explicit: the initial ``(client, server)`` params
  (``init=``) and each round's Gumbel selection noise (``gumbels=``) can be
  injected, so a test can feed the JAX values; without them both come from
  one ``torch.Generator`` seeded with ``seed`` on the device.  The loaders
  draw from their own numpy generators, as in JAX.
* On the card the loop computes in true fp32, as the JAX reference does:
  TF32 is switched off for cuDNN convolutions and cuBLAS matmuls inside the
  loop and restored after it.

Ported for the clean, synchronous, uncompressed loop only.  Raising
``NotImplementedError`` that names the ROADMAP item rather than running
something else: a scenario with faults or skew (item 8), compressed
uploads (item 5b) and a robust aggregation rule (item 8); a finite async
deadline (item 10) is refused by ``AsyncRoundsConfig`` itself.
"""

from __future__ import annotations

import contextlib
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.config import Scenario, WSSLConfig
from repro_torch.core import aggregation, protocol, wssl
from repro_torch.core.split import split_grads
from repro_torch.data.pipeline import ClientLoader
from repro_torch.models import paper_models as pm
from repro_torch.models.layers import resolve_device
from repro_torch.optim import adamw_init, adamw_update

Params = Any


class ModelAdapter(NamedTuple):
    """Uniform interface over the paper's two model families."""
    name: str
    init_split: Callable[[torch.Generator], Tuple[Params, Params]]
    client_apply: Callable[[Params, torch.Tensor], torch.Tensor]
    server_apply: Callable[[Params, torch.Tensor], torch.Tensor]
    loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    predict: Callable[[torch.Tensor], torch.Tensor]


def gait_adapter(cfg) -> ModelAdapter:
    return ModelAdapter(
        name="gait-ffn",
        init_split=lambda gen: pm.gait_split_params(cfg, pm.gait_init(gen,
                                                                      cfg)),
        client_apply=lambda cp, x: pm.gait_client_apply(cfg, cp, x),
        server_apply=lambda sp, a: pm.gait_server_apply(cfg, sp, a),
        loss=pm.gait_loss,
        predict=lambda logit: (logit > 0).to(torch.int32),
    )


def resnet_adapter(cfg) -> ModelAdapter:
    return ModelAdapter(
        name="resnet",
        init_split=lambda gen: pm.resnet_init_split(gen, cfg),
        client_apply=lambda cp, x: pm.resnet_client_apply(cfg, cp, x),
        server_apply=lambda sp, a: pm.resnet_server_apply(cfg, sp, a),
        loss=pm.softmax_loss,
        predict=lambda logits: torch.argmax(logits, dim=-1).to(torch.int32),
    )


@contextlib.contextmanager
def true_fp32():
    """No TF32 in cuDNN convolutions or cuBLAS matmuls inside the block;
    the previous settings are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Inner steps
# ---------------------------------------------------------------------------


def _make_split_step(adapter: ModelAdapter, lr: float):
    """One split forward/backward and an AdamW step (weight decay 1e-4) of
    both stages, in place; returns the loss."""
    def step(client_params, server_params, opt_c, opt_s, x, y):
        res = split_grads(lambda cp: adapter.client_apply(cp, x),
                          lambda sp, a: adapter.loss(
                              adapter.server_apply(sp, a), y),
                          client_params, server_params)
        adamw_update(client_params, res.grads_client, opt_c, lr=lr,
                     weight_decay=1e-4)
        adamw_update(server_params, res.grads_server, opt_s, lr=lr,
                     weight_decay=1e-4)
        return res.loss

    return step


def _make_eval(adapter: ModelAdapter):
    @torch.no_grad()
    def evaluate(client_params, server_params, x, y):
        logits = adapter.server_apply(server_params,
                                      adapter.client_apply(client_params, x))
        loss = adapter.loss(logits, y)
        acc = (adapter.predict(logits) == y).float().mean()
        return loss, acc

    return evaluate


def _copy(tree: Params) -> Params:
    return tree_map(lambda t: t.detach().clone(), tree)


def _initial(adapter: ModelAdapter, init, gen: torch.Generator
             ) -> Tuple[Params, Params]:
    """The injected ``(client, server)`` params (numpy leaves, as the JAX
    values come), copied onto the device in fp32, or a fresh draw from
    ``gen``."""
    if init is None:
        return adapter.init_split(gen)
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        gen.device), tuple(init))


def _on(data: Dict[str, np.ndarray], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    return (torch.as_tensor(data["x"], device=device),
            torch.as_tensor(data["y"], device=device))


def _check_ported(wssl_cfg: WSSLConfig, scenario: Optional[Scenario]) -> None:
    """Refuse, before anything moves, what the port does not run yet."""
    if scenario is not None and not scenario.is_clean():
        raise NotImplementedError(
            f"the paper loop's scenario {scenario.name!r} is not ported yet "
            f"(ROADMAP Queue 1, item 8: sim/faults.py, then item 5b)")
    if wssl_cfg.compression.enabled:
        raise NotImplementedError(
            "compressed uploads in the paper loop are not ported yet "
            "(ROADMAP Queue 1, item 5b)")
    aggregation.resolve(wssl_cfg)


# ---------------------------------------------------------------------------
# WSSL training (Algorithms 1 + 2 at paper scale)
# ---------------------------------------------------------------------------


@true_fp32()
def train_wssl(adapter: ModelAdapter,
               loaders: List[ClientLoader],
               val: Dict[str, np.ndarray],
               test: Dict[str, np.ndarray],
               wssl_cfg: WSSLConfig,
               rounds: int = 20,
               local_steps: int = 10,
               lr: float = 1e-3,
               seed: int = 0,
               scenario: Optional[Scenario] = None,
               fused_adam: bool = False, *,
               device="cuda",
               init: Optional[Tuple[Params, Params]] = None,
               gumbels: Optional[Sequence[torch.Tensor]] = None
               ) -> Dict[str, Any]:
    """WSSL over ``rounds`` rounds; returns the JAX loop's history.
    ``fused_adam`` is accepted for parity with the JAX loop: AdamW always
    takes the fused kernel on the card.  ``init`` (numpy leaves) replaces
    the initial ``(client, server)`` params and ``gumbels[r]`` (N,) round
    r's selection noise.  Beyond the JAX keys, the history holds each round's
    mean local-step loss (``train_loss``) and wall time (``round_s``, up to
    the host's read of the test accuracy, which waits for the device), and
    the final ``(client, server)`` params (``params``)."""
    _check_ported(wssl_cfg, scenario)
    n = wssl_cfg.num_clients
    if len(loaders) != n:
        raise ValueError(f"{len(loaders)} loaders for {n} clients")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    client0, server = _initial(adapter, init, gen)
    clients = [_copy(client0) for _ in range(n)]
    opt_clients = [adamw_init(c) for c in clients]
    opt_server = adamw_init(server)
    step = _make_split_step(adapter, lr)
    evaluate = _make_eval(adapter)
    sc = scenario if scenario is not None else Scenario()

    importance = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    participation = np.zeros(n)
    history: Dict[str, Any] = {"round": [], "test_acc": [], "test_loss": [],
                               "train_loss": [], "val_loss": [], "selected": [], "dropped": [],
                               "importance": [], "bytes_up": [],
                               "bytes_sync": [], "scenario": sc.name,
                               "arrived": [], "buffered": [], "evicted": [],
                               "mean_staleness": [], "round_s": []}
    xv, yv = _on(val, dev)
    xt, yt = _on(test, dev)

    # cut-activation bytes per example (up) + the same for the returned
    # gradient
    with torch.no_grad():
        probe = adapter.client_apply(client0, xv[:1])
    act_bytes_per_example = probe[0].numel() * probe.element_size()
    del probe
    client_stage_bytes = protocol.tree_bytes(client0)
    comm = protocol.CommLog()

    for r in range(rounds):
        t0 = time.perf_counter()
        # ---- Algorithm 1: selection (round-0 rule lives in wssl) ------
        # the clean synchronous loop has no slow or busy client, so no
        # staleness penalty (JAX's is 0 for everyone here)
        idx, _ = wssl.select_clients(
            importance, wssl_cfg, r, generator=gen,
            gumbel=None if gumbels is None else gumbels[r])
        sel = sorted(int(i) for i in idx.tolist())
        participation[sel] += 1

        # ---- Algorithm 2: local split training ------------------------
        round_bytes, losses = 0, []
        for i in sel:
            for _ in range(local_steps):
                x, y = _on(loaders[i].next_batch(), dev)
                losses.append(step(clients[i], server, opt_clients[i],
                                   opt_server, x, y))
                round_bytes += act_bytes_per_example * x.shape[0] * 2
        uploads = len(sel)
        update_raw = uploads * client_stage_bytes
        sync_bytes = protocol.sync_round_bytes(uploads, n,
                                               client_stage_bytes)
        comm.record(r, len(sel), bytes_up=round_bytes // 2,
                    bytes_down=round_bytes // 2, bytes_sync=sync_bytes,
                    bytes_per_hop=(round_bytes // 2,),
                    bytes_update_raw=update_raw,
                    bytes_update_comp=update_raw)

        # ---- validation -> importance ----------------------------------
        val_losses = torch.stack([evaluate(clients[i], server, xv, yv)[0]
                                  for i in range(n)])
        importance = wssl.compute_importance(val_losses, wssl_cfg,
                                             prev=importance)

        # ---- weighted aggregation + sync --------------------------------
        contrib = torch.zeros((n,), dtype=torch.float32, device=dev)
        contrib[sel] = 1.0
        with torch.no_grad():
            stacked = tree_map(lambda *xs: torch.stack(xs), *clients)
            global_client = aggregation.aggregate_clients(
                stacked, importance, contrib, wssl_cfg, safe=True)
            del stacked
            for c in clients:
                for a, g in zip(tree_leaves(c), tree_leaves(global_client)):
                    a.copy_(g)

        # ---- evaluation of the global model ------------------------------
        tl, ta = evaluate(global_client, server, xt, yt)
        history["round"].append(r)
        history["test_acc"].append(float(ta))
        history["test_loss"].append(float(tl))
        history["train_loss"].append(torch.stack(losses).mean().item()
                                     if losses else float("nan"))
        history["val_loss"].append(val_losses.tolist())
        history["selected"].append(sel)
        history["dropped"].append([])
        history["importance"].append(importance.tolist())
        history["bytes_up"].append(round_bytes)
        history["bytes_sync"].append(sync_bytes)
        history["arrived"].append([])
        history["buffered"].append([])
        history["evicted"].append(0)
        history["mean_staleness"].append(0.0)
        history["round_s"].append(time.perf_counter() - t0)

    history["participation"] = participation.tolist()
    history["bytes_up_total"] = sum(history["bytes_up"])
    history["bytes_sync_total"] = sum(history["bytes_sync"])
    history["comm"] = comm.summary()
    history["final_acc"] = history["test_acc"][-1]
    history["best_acc"] = max(history["test_acc"])
    history["params"] = (clients[0], server)
    return history


# ---------------------------------------------------------------------------
# Centralized baseline (§V-B)
# ---------------------------------------------------------------------------


@true_fp32()
def train_centralized(adapter: ModelAdapter,
                      loader: ClientLoader,
                      test: Dict[str, np.ndarray],
                      rounds: int = 20,
                      steps_per_round: int = 10,
                      lr: float = 1e-3,
                      seed: int = 0, *,
                      device="cuda",
                      init: Optional[Tuple[Params, Params]] = None
                      ) -> Dict[str, Any]:
    """Same model, all data on one server, no selection — the paper's
    baseline.  ``init`` (numpy leaves) replaces the initial ``(client,
    server)`` params;
    the history also holds each round's wall time (``round_s``) and the
    final params (``params``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    client, server = _initial(adapter, init, gen)
    opt_c, opt_s = adamw_init(client), adamw_init(server)
    step = _make_split_step(adapter, lr)
    evaluate = _make_eval(adapter)
    xt, yt = _on(test, dev)

    history: Dict[str, Any] = {"round": [], "test_acc": [], "test_loss": [],
                               "round_s": []}
    for r in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps_per_round):
            x, y = _on(loader.next_batch(), dev)
            step(client, server, opt_c, opt_s, x, y)
        tl, ta = evaluate(client, server, xt, yt)
        history["round"].append(r)
        history["test_acc"].append(float(ta))
        history["test_loss"].append(float(tl))
        history["round_s"].append(time.perf_counter() - t0)
    history["final_acc"] = history["test_acc"][-1]
    history["best_acc"] = max(history["test_acc"])
    history["params"] = (client, server)
    return history
