"""Mixture-of-Experts layer: a softmax top-k router and a
capacity-bounded, sort-based dispatch.

The PyTorch twin of ``repro/models/moe.py``, step for step: router
logits in the activation dtype, an fp32 softmax, top-k, the Switch
load-balance aux term, a stable sort of the (token-major) assignments by
expert, at most ``capacity`` tokens an expert (the rest dropped), the
(E, C, D) buffers, one batched product an expert projection, and the
gate-weighted combine.  JAX computes the whole layer in plain XLA (no
Pallas kernel), so the products here are ``torch.bmm``.

Two places where a PyTorch call would not do what the JAX one does:

* ``jax.lax.top_k`` puts the lower index first among equal values and
  ``torch.topk`` promises no order; at OLMoE's width in bf16 ~6% of
  tokens tie at the k-th place.  The top-k is a stable descending sort.
* JAX combines with a scatter-add (``.at[tok].add``) in the activation
  dtype; ``index_add_`` on CUDA adds with atomics, in no fixed order.
  The combine here gathers each token's k contributions in the order of
  the sorted assignments (ascending expert) and adds them from zero in
  the activation dtype, which is the order XLA's scatter adds them in.
  The dispatch is a gather too, so the layer is deterministic on the card
  and its backward (a sorted index accumulate) as well.

JAX's data-sharded branch (``repro/models/moe.py:63-74``) keys on the
``moe_tokens`` binding of the logical-axis rules (``sharding.bound_axes``),
which only a serving step's rules set (``launch/specs.py::build_rules``;
the rounds never do, so the client-sharded rounds dispatch per rank as
above).  When it gives ``dp > 1`` shards of ``t // dp >= 8 E`` tokens,
each shard is dispatched on its own, its capacity reckoned from its own
tokens, and the aux loss is the shards' mean:

* under a bare mesh shape (one process holding the whole mesh) the
  shards run in order, as JAX's ``vmap`` runs them;
* on a grid (``sharding.current_grid()``) whose ``batch`` binding splits
  the rows over the data axis, each rank's tokens are its data shard's:
  it runs its own, and the aux mean is summed over the data group;
* on a grid whose rows arrive whole on every rank (``batch`` unbound: the
  decode rules of a batch below the data axis, ``long_500k``), each data
  rank dispatches its ``moe_tokens`` shard of them and the outputs are
  gathered over the data group, the aux the shards' mean: JAX's ``vmap``
  over an unsplit input.

Otherwise a grid whose data axis splits the tokens gathers them over the
data group and dispatches the global stream, capacity from all ``t``
tokens, as JAX does, so an overflow drops the tokens one rank would; each
rank keeps its rows.  Rows that arrive whole are the global stream
already.  Experts split over the model axis (``expert``): a
rank runs its ``E / M`` experts on its tokens, which every rank of its
model group holds, and its combine is a partial sum, summed over the
model group.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models.layers import _act, dense_param

Params = Dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int = 0,
             dtype=torch.float32, device=None) -> Params:
    """The router ``(d, E)`` at scale 1/sqrt(d), the expert projections
    ``wg`` / ``wu`` ``(E, d, f)`` at ``dense_param``'s default scale (the
    fan-in is read off ``shape[0]``, so 1/sqrt(E), as in JAX) and ``wd``
    ``(E, f, d)`` at 1/sqrt(f); ``layers > 0`` stacks them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def w(shape, scale=None):
        return dense_param(gen, shape, layers=layers, scale=scale,
                           dtype=dtype, device=device)

    p: Params = {"router": w((d, e), scale=1.0 / math.sqrt(d))}
    if cfg.activation in ("swiglu", "geglu"):
        p["wg"] = w((e, d, f))
    p["wu"] = w((e, d, f))
    p["wd"] = w((e, f, d), scale=1.0 / math.sqrt(f))
    return p


def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Tokens an expert takes from a call of ``num_tokens`` tokens: the
    capacity factor times its even share, rounded up to a multiple of 8,
    at least 8."""
    c = int(math.ceil(num_tokens * cfg.experts_per_token
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), the fp32 aux loss).  The B·S tokens
    are routed as one batch, so the capacity depends on the call, unless
    the ``moe_tokens`` binding splits them into shards (see the module's
    docstring).  On a grid ``x`` is this rank's rows."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    axes, dp = sharding.bound_axes("moe_tokens")
    grid = sharding.current_grid()
    # the data shards the rows arrive in: the batch binding's
    nd = 1 if grid is None else sharding.bound_axes("batch")[1]
    t = b * s * nd
    per_shard = dp > 1 and t % dp == 0 and t // dp >= 8 * cfg.num_experts
    if grid is None:
        if per_shard:
            outs, auxes = zip(*(_moe_core(cfg, p, xs)
                                for xs in xt.reshape(dp, t // dp, d)))
            return (torch.cat(outs).reshape(b, s, d),
                    torch.stack(auxes).mean())
        out, aux = _moe_core(cfg, p, xt)
        return out.reshape(b, s, d), aux
    if dp > 1 and nd not in (1, dp):
        raise NotImplementedError(
            f"moe_tokens bound to {axes} ({dp} shards) on a grid whose "
            f"tokens arrive in {nd}: {sharding.ITEM_UNEXECUTED}")
    if per_shard and nd == dp:
        out, aux = _moe_core(cfg, p, xt)
        return out.reshape(b, s, d), sharding.data_sum(aux) / dp
    if per_shard:
        # whole rows: this data rank's shard, the shards' outputs gathered
        i = sharding.block_slices((axes,), (dp,), grid)[0].start
        out, aux = _moe_core(cfg, p, xt.reshape(dp, t // dp, d)[i])
        return (sharding.data_gather(out, 0).reshape(b, s, d),
                sharding.data_sum(aux) / dp)
    if nd == 1:
        out, aux = _moe_core(cfg, p, xt)
        return out.reshape(b, s, d), aux
    # the global stream: every data rank dispatches all t tokens and keeps
    # its own rows
    i = grid.coords["data"]
    out, aux = _moe_core(cfg, p, sharding.data_gather(xt, 0),
                         rows=slice(i * b * s, (i + 1) * b * s))
    return out.reshape(b, s, d), aux


class Dispatch(NamedTuple):
    """The dispatch plan of one token batch of T tokens, A = T·k
    assignments (token-major: assignment ``i`` is token ``i // k``'s)."""
    gate_vals: torch.Tensor     # (T, k) fp32, the top-k probabilities
    expert_ids: torch.Tensor    # (T, k)
    one_hot: torch.Tensor       # (T, E) fp32, 1 where a token chose e
    order: torch.Tensor         # (A,) the stable sort of the ids by expert
    keep: torch.Tensor          # (A,) bool, in sorted order
    slot: torch.Tensor          # (A,) buffer row, in sorted order
    counts: torch.Tensor        # (E,) assignments an expert received
    starts: torch.Tensor        # (E,) its first place in sorted order


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, indices), ties to the
    lower index, as a stable descending sort."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(cfg: ModelConfig, probs: torch.Tensor, cap: int) -> Dispatch:
    """The dispatch plan of fp32 router ``probs`` (T, E) at capacity
    ``cap``.  A kept assignment's slot is ``expert * cap + its place among
    that expert's``; a dropped one (its place ``>= cap``) takes the
    overflow slot ``E * cap``."""
    e, k = cfg.num_experts, cfg.experts_per_token
    t = probs.shape[0]
    dev = probs.device
    gate_vals, expert_ids = top_k(probs, k)
    a = t * k
    e_flat = expert_ids.reshape(a)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # per-expert counts from a one-hot sum (exact integers in fp32): no
    # host read, unlike torch.bincount on the card
    one_hot = torch.zeros((t, e), dtype=torch.float32, device=dev).scatter_(
        1, expert_ids, 1.0)
    counts = one_hot.sum(0).long()
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(a, device=dev) - starts[e_sorted]
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))
    return Dispatch(gate_vals, expert_ids, one_hot, order, keep, slot,
                    counts, starts)


def _moe_core(cfg: ModelConfig, p: Params, xt: torch.Tensor,
              rows: slice = slice(None)
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch, the expert products and the combine over a token
    batch xt (T, D) -> (out[rows] (T', D) in xt's dtype, aux).  With the
    experts split over the model axis (``wu`` holds ``E / M`` of them)
    this rank runs its own, and ``out`` sums its partial combine over the
    model group (only ``rows``)."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dtype, dev = xt.dtype, xt.device

    logits = (xt @ p["router"].to(dtype)).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    cap = _capacity(cfg, t)
    r = route(cfg, probs, cap)
    gate_vals = r.gate_vals / torch.clamp(r.gate_vals.sum(-1, keepdim=True),
                                          min=1e-9)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    f_e = r.one_hot.mean(0) * e / k
    p_e = probs.mean(0)
    aux = cfg.router_aux_coef * float(e) * torch.sum(f_e * p_e)

    # ---- dispatch: slot (e, c) holds the c-th token sent to expert e, for
    # this rank's experts [lo, lo + el) --------------------------------------
    el = p["wu"].shape[0]
    lo = None if el == e else sharding.model_block(e, el)
    mine = slice(None) if lo is None else slice(lo, lo + el)
    a = t * k
    tok_sorted = r.order // k               # assignments are token-major
    g_sorted = gate_vals.reshape(a).to(dtype)[r.order]
    c = torch.arange(cap, device=dev)
    counts, starts = r.counts[mine], r.starts[mine]
    filled = c[None] < counts[:, None]                               # (E, C)
    src = torch.where(filled, starts[:, None] + c[None],
                      torch.zeros_like(filled, dtype=torch.long))
    xe = torch.where(filled[..., None], xt[tok_sorted[src]],
                     torch.zeros((), dtype=dtype, device=dev))      # (E, C, D)

    # ---- expert compute ---------------------------------------------------
    up = torch.bmm(xe, p["wu"].to(dtype))
    if "wg" in p:
        h = _act(cfg, torch.bmm(xe, p["wg"].to(dtype))) * up
    else:
        h = F.gelu(up, approximate="tanh")
    ye = torch.bmm(h, p["wd"].to(dtype))                            # (E, C, D)

    # ---- combine: each token's k contributions in sorted order, added
    # from zero in the activation dtype (XLA's scatter-add order) ---------
    ye_flat = torch.cat([ye.reshape(el * cap, d),
                         torch.zeros((1, d), dtype=dtype, device=dev)])
    slot = r.slot
    if lo is not None:
        # another rank's expert (or an overflow) reads the zero row
        slot = slot - lo * cap
        slot = torch.where(r.keep & (slot >= 0) & (slot < el * cap), slot,
                           torch.full_like(slot, el * cap))
    contrib = ye_flat[slot] * (g_sorted * r.keep.to(dtype))[:, None]
    out = combine(contrib, r.order, k)[rows]
    return (out if lo is None else sharding.model_sum(out)), aux


def combine(contrib: torch.Tensor, order: torch.Tensor, k: int
            ) -> torch.Tensor:
    """``zeros(T, D).at[order // k].add(contrib)`` without atomics:
    ``contrib`` (A, D) holds the sorted assignments' contributions, whose
    token-major indices are ``order``; each token's k rows are gathered in
    sorted order and added from zero in ``contrib``'s dtype."""
    a, d = contrib.shape
    t = a // k
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(a, device=order.device))
    mine = contrib[torch.sort(inv.view(t, k), dim=1).values]      # (T, k, D)
    out = torch.zeros((t, d), dtype=contrib.dtype, device=contrib.device)
    for j in range(k):
        out = out + mine[:, j]
    return out
