"""The aggregator registry of Algorithm 2 step 5.

The twin of ``repro/core/aggregation.py``.  Every entry has the signature

    rule(stacked, importance, mask, params, *, safe, use_kernel) -> Params

over a client-stacked tree (leaves ``(N, ...)``), the ``(N,)`` importance
and the ``(N,)`` participation mask.  **Weighted** rules (``importance``,
``uniform``, ``norm_clip``) turn the mask into normalized coefficients
(``core/wssl.py``); ``importance`` and ``uniform`` average through the
weighted-average kernel when ``use_kernel`` is set.  **Robust** rules
(``trimmed_mean``, ``median``, ``krum``, ``multi_krum``,
``geometric_median``) are unweighted statistics: a positive mask entry is
one full vote, and an empty mask falls back to every client (clients start
each round synchronized, so that is a no-op sync).  A client-sharded round
aggregates through the two-level tree at the end of the module
(``shard_aggregate_clients``; ``tree_aggregate`` is its one-process
reference).

The robust rules are plain tensor code in both packages (sorts, a Gram
product, reductions); their knobs (:class:`AggParams`) are fp32 numbers,
and every bound computed from them (the trim window, Krum's neighbour
count, Multi-Krum's m) is computed in fp32 as JAX's traced scalars are.
What differs from the JAX module, and why:

* Sums run in PyTorch's order, so a statistic that reduces (a mean, a
  distance) agrees with JAX's to rounding, not bit for bit.
* Krum's Gram product runs in true fp32 (no TF32) on the card: TF32
  would move the scores.
* A rule that returns one client's row (Krum) returns a copy, since the
  sync writes the aggregate back into the stack it came from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.config import AggregationConfig, WSSLConfig
from repro_torch.core import wssl
from repro_torch.models.layers import true_fp32
from repro_torch.tree import tree_leaves, tree_unflatten

Params = Any


class AggParams(NamedTuple):
    """The rule knobs of an AggregationConfig, each rounded to fp32 as the
    JAX package's traced scalars are."""

    trim_fraction: float      # per-tail trim fraction (trimmed_mean)
    byzantine_f: float        # assumed Byzantine count (krum, multi_krum)
    multi_krum_m: float       # candidates to average; 0.0 = auto (s - f)
    clip_factor: float = 1.0  # deviation-norm cap multiplier (norm_clip)


def agg_params(cfg: AggregationConfig) -> AggParams:
    f32 = lambda v: float(np.float32(v))
    m = 0.0 if cfg.multi_krum_m is None else cfg.multi_krum_m
    return AggParams(trim_fraction=f32(cfg.trim_fraction),
                     byzantine_f=f32(cfg.byzantine_f),
                     multi_krum_m=f32(m), clip_factor=f32(cfg.clip_factor))


AggregatorFn = Callable[..., Params]


@dataclasses.dataclass(frozen=True)
class Aggregator:
    name: str
    fn: AggregatorFn
    # True: coefficients scale contributions; False: an unweighted robust
    # statistic, where a mask entry only gates membership
    weighted: bool
    # True: a masked weighted sum, which splits into per-shard partial sums
    decomposes: bool = False
    doc: str = ""


_AGGREGATORS: Dict[str, Aggregator] = {}


def register_aggregator(name: str, *, weighted: bool = False,
                        decomposes: bool = False, doc: str = ""
                        ) -> Callable[[AggregatorFn], AggregatorFn]:
    """Register ``fn(stacked, importance, mask, params, *, safe,
    use_kernel)`` under ``name``.  A later registration overrides an
    earlier one (user rules can shadow built-ins)."""
    def deco(fn: AggregatorFn) -> AggregatorFn:
        _AGGREGATORS[name] = Aggregator(name=name, fn=fn, weighted=weighted,
                                        decomposes=decomposes,
                                        doc=doc or (fn.__doc__ or ""))
        return fn
    return deco


def get_aggregator(name: str) -> Aggregator:
    if name not in _AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; known: "
                       f"{list_aggregators()}")
    return _AGGREGATORS[name]


def list_aggregators() -> List[str]:
    return sorted(_AGGREGATORS)


# ---------------------------------------------------------------------------
# Shared masked-statistic machinery
# ---------------------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    """A knob (a float or a tensor) as a 0-d fp32 tensor on ``device``."""
    return torch.as_tensor(v, dtype=torch.float32).to(device)


def _membership(mask: torch.Tensor) -> torch.Tensor:
    """Binarized membership with the empty-mask fallback: a fractional
    (staleness-discounted) entry counts as a full participant; with no
    participant at all every client votes (a no-op sync)."""
    alive = (mask > 0).float()
    return torch.where(alive.sum() > 0, alive, torch.ones_like(alive))


def trimmed_mean_average(stacked: Params, mask: torch.Tensor,
                         trim_fraction=0.1) -> Params:
    """Coordinate-wise trimmed mean over the *masked* client axis: per
    coordinate, drop the k lowest and k highest surviving values (k =
    floor(trim * s) for s participants, in fp32, capped so that at least
    one survives) and average the rest.  Dead clients sort to +inf and a
    rank window [k, s - k) selects the kept values."""
    m = _membership(mask)
    s = m.sum()
    zero = torch.zeros_like(s)
    k = torch.clamp(torch.floor(_f32(trim_fraction, s.device) * s), min=zero,
                    max=torch.maximum(torch.floor((s - 1) / 2), zero))
    denom = torch.clamp(s - 2.0 * k, min=1.0)

    def one(a):
        n = a.shape[0]
        a2 = a.reshape(n, -1)
        alive = (m > 0).reshape(n, 1)
        rank = torch.arange(n, dtype=torch.float32,
                            device=a.device).reshape(n, 1)
        inc = (rank >= k) & (rank < s - k)
        srt = torch.sort(torch.where(alive, a2.float(), torch.inf),
                         dim=0).values
        out = torch.where(inc, srt, 0.0).sum(0) / denom
        return out.reshape(a.shape[1:]).to(a.dtype)

    return tree_map(one, stacked)


def median_average(stacked: Params, mask: torch.Tensor) -> Params:
    """Coordinate-wise masked median: the maximal trimmed mean (trim 0.5
    keeps one value for odd s and averages two for even s)."""
    return trimmed_mean_average(stacked, mask, 0.5)


def _flat_clients(stacked: Params) -> torch.Tensor:
    """Every leaf's client rows side by side, in JAX's leaf order, as one
    (N, D) fp32 matrix."""
    leaves = tree_leaves(stacked)
    n = leaves[0].shape[0]
    return torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)


def krum_scores(stacked: Params, mask: torch.Tensor,
                byzantine_f) -> torch.Tensor:
    """Per-client Krum scores over the masked client axis: the sum of
    client i's squared distances to its k nearest surviving neighbours,
    k = s - f - 2 clamped to [1, s - 1].  Dead clients score +inf, and
    distances to them are +inf.  The distances take the Gram form
    ``x2_i + x2_j - 2 flat @ flat.T`` (memory N D + N^2), the product in
    true fp32."""
    flat = _flat_clients(stacked)
    n = flat.shape[0]
    m = _membership(mask)
    alive = m > 0
    s = m.sum()
    x2 = (flat * flat).sum(-1)
    with true_fp32():
        gram = flat @ flat.T
    del flat
    sq = torch.clamp(x2[:, None] + x2[None, :] - 2.0 * gram, min=0.0)
    eye = torch.eye(n, dtype=torch.bool, device=sq.device)
    valid = alive[None, :] & alive[:, None] & ~eye
    d = torch.where(valid, sq, torch.inf)
    srt = torch.sort(d, dim=1).values                # ascending, inf last
    k = torch.minimum(torch.clamp(s - _f32(byzantine_f, s.device) - 2.0,
                                  min=1.0),
                      torch.clamp(s - 1.0, min=1.0))
    rank = torch.arange(n, dtype=torch.float32, device=sq.device)[None, :]
    # a lone survivor has no finite neighbour: its kept window is empty
    # (score 0), which still beats every dead client's +inf
    kept = torch.where((rank < k) & torch.isfinite(srt), srt, 0.0)
    return torch.where(alive, kept.sum(dim=1), torch.inf)


def krum_average(stacked: Params, mask: torch.Tensor, byzantine_f
                 ) -> Params:
    """Krum: a copy of the stage of the lowest-scored surviving client
    (ties break to the lowest index)."""
    i_star = int(torch.argmin(krum_scores(stacked, mask, byzantine_f)))
    return tree_map(lambda a: a[i_star].clone(), stacked)


def multi_krum_average(stacked: Params, mask: torch.Tensor, byzantine_f,
                       multi_krum_m=0.0) -> Params:
    """Multi-Krum: the unweighted mean of the ``m`` lowest-scored
    survivors; ``m <= 0`` is the default ``s - f``, and any value is
    clamped to [1, s].  The order is a stable sort: ties go by index."""
    scores = krum_scores(stacked, mask, byzantine_f)
    n = scores.shape[0]
    s = _membership(mask).sum()
    f = _f32(byzantine_f, s.device)
    m_raw = _f32(multi_krum_m, s.device)
    m_sel = torch.minimum(torch.clamp(torch.where(m_raw > 0, m_raw, s - f),
                                      min=1.0), s)
    order = torch.argsort(scores, stable=True)
    ranks = torch.arange(n, dtype=torch.float32, device=scores.device)
    picked = torch.zeros_like(scores).scatter_(0, order,
                                               (ranks < m_sel).float())
    coefs = picked / torch.clamp(picked.sum(), min=1.0)
    return wssl.weighted_average(stacked, coefs)


def geometric_median_average(stacked: Params, mask: torch.Tensor,
                             iters: int = 8, eps: float = 1e-8) -> Params:
    """Geometric median over the masked client axis by a fixed number of
    Weiszfeld iterations from the masked uniform mean:

        z <- sum_i w_i x_i / sum_i w_i,   w_i = m_i / max(||x_i - z||, eps)

    on the flattened (N, D) client matrix; dead clients weigh 0."""
    m = _membership(mask)
    flat = _flat_clients(stacked)                        # (N, D) fp32
    w = m / torch.clamp(m.sum(), min=1.0)
    z = (w[:, None] * flat).sum(dim=0)
    for _ in range(iters):
        d = torch.sqrt(torch.clamp(((flat - z) ** 2).sum(dim=1), min=0.0))
        w = m / torch.clamp(d, min=eps)
        w = w / torch.clamp(w.sum(), min=eps)
        z = (w[:, None] * flat).sum(dim=0)
    del flat
    out, offset = [], 0
    for leaf in tree_leaves(stacked):
        size = leaf[0].numel()
        out.append(z[offset:offset + size].reshape(leaf.shape[1:])
                   .to(leaf.dtype))
        offset += size
    return tree_unflatten(tree_map(lambda a: a[0], stacked), iter(out))


def norm_clip_average(stacked: Params, importance: torch.Tensor,
                      mask: torch.Tensor, clip_factor=1.0, *,
                      safe: bool = False, eps: float = 1e-8) -> Params:
    """Importance-weighted mean with per-client deviation-norm clipping:
    around the coordinate-wise masked median mu,

        d_i = x_i - mu,  d_i <- d_i min(1, c tau / ||d_i||),
        out = mu + sum_i gamma_i d_i

    with tau the masked median of the deviation norms.  An amplified
    update keeps its direction at a bounded length."""
    mu = median_average(stacked, mask)
    deltas = tree_map(lambda a, c: a.float() - c.float(), stacked, mu)
    norms = torch.sqrt(torch.clamp(
        (_flat_clients(deltas) ** 2).sum(dim=1), min=0.0))        # (N,)
    tau = median_average({"n": norms}, mask)["n"]
    cap = _f32(clip_factor, tau.device) * tau
    scale = torch.minimum(torch.ones_like(norms),
                          cap / torch.clamp(norms, min=eps))       # (N,)
    coef_fn = (wssl.safe_mean_coefficients if safe
               else wssl.mean_coefficients)
    coefs = coef_fn(importance, mask, use_importance=True)

    def one(mu_l, d):
        tail = (1,) * (d.dim() - 1)
        clipped = d * scale.reshape((-1,) + tail)
        agg = (coefs.reshape((-1,) + tail) * clipped).sum(dim=0)
        return (mu_l.float() + agg).to(mu_l.dtype)

    return tree_map(one, mu, deltas)


# ---------------------------------------------------------------------------
# Built-in entries
# ---------------------------------------------------------------------------


def _mean_rule(stacked, importance, mask, *, use_importance, safe,
               use_kernel):
    coef_fn = (wssl.safe_mean_coefficients if safe
               else wssl.mean_coefficients)
    coefs = coef_fn(importance, mask, use_importance=use_importance)
    return wssl.weighted_average(stacked, coefs, use_kernel=use_kernel)


@register_aggregator("importance", weighted=True, decomposes=True,
                     doc="importance-weighted mean (the paper's rule)")
def _importance_rule(stacked, importance, mask, params, *, safe=False,
                     use_kernel=False):
    return _mean_rule(stacked, importance, mask, use_importance=True,
                      safe=safe, use_kernel=use_kernel)


@register_aggregator("uniform", weighted=True, decomposes=True,
                     doc="unweighted mean over the participation mask")
def _uniform_rule(stacked, importance, mask, params, *, safe=False,
                  use_kernel=False):
    return _mean_rule(stacked, importance, mask, use_importance=False,
                      safe=safe, use_kernel=use_kernel)


@register_aggregator("trimmed_mean",
                     doc="coordinate-wise trimmed mean (per-tail "
                         "trim_fraction)")
def _trimmed_mean_rule(stacked, importance, mask, params, *, safe=False,
                       use_kernel=False):
    return trimmed_mean_average(stacked, mask, params.trim_fraction)


@register_aggregator("median", doc="coordinate-wise masked median")
def _median_rule(stacked, importance, mask, params, *, safe=False,
                 use_kernel=False):
    return median_average(stacked, mask)


@register_aggregator("krum",
                     doc="Krum: single client nearest its s-f-2 neighbours")
def _krum_rule(stacked, importance, mask, params, *, safe=False,
               use_kernel=False):
    return krum_average(stacked, mask, params.byzantine_f)


@register_aggregator("multi_krum",
                     doc="mean of the m lowest-scored Krum candidates")
def _multi_krum_rule(stacked, importance, mask, params, *, safe=False,
                     use_kernel=False):
    return multi_krum_average(stacked, mask, params.byzantine_f,
                              params.multi_krum_m)


@register_aggregator("geometric_median",
                     doc="Weiszfeld geometric median (fixed iterations)")
def _geometric_median_rule(stacked, importance, mask, params, *, safe=False,
                           use_kernel=False):
    return geometric_median_average(stacked, mask)


@register_aggregator("norm_clip", weighted=True,
                     doc="importance mean with deviation norms clipped to "
                         "clip_factor x the median")
def _norm_clip_rule(stacked, importance, mask, params, *, safe=False,
                    use_kernel=False):
    return norm_clip_average(stacked, importance, mask, params.clip_factor,
                             safe=safe)


# ---------------------------------------------------------------------------
# The one dispatch the round uses
# ---------------------------------------------------------------------------


def aggregate_clients(stacked: Params, importance: torch.Tensor,
                      mask: torch.Tensor, cfg: WSSLConfig, *,
                      safe: bool = False, use_kernel: bool = False,
                      params: Optional[AggParams] = None) -> Params:
    """Algorithm 2 step 5 through the registry: the rule that
    ``cfg.resolve_aggregation()`` names, with ``params`` (default: lowered
    from the config).  ``safe`` selects the empty-mask fallback of the
    weighted rules (a faulted round can drop every selected client); the
    robust rules carry their fallback internally."""
    acfg = cfg.resolve_aggregation()
    agg = get_aggregator(acfg.rule)
    p = agg_params(acfg) if params is None else params
    return agg.fn(stacked, importance, mask, p, safe=safe,
                  use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# The two-level aggregation tree of a client-sharded round
# ---------------------------------------------------------------------------
#
# With the client axis split over a process group (core/round.py::
# make_sharded_round_fn), aggregation is a tree: each shard reduces its
# local clients to one partial stage and the partials combine across the
# group.  A decomposable rule sums the unnormalized partial weighted sums,
# its coefficients normalized against the global mask, in an all_reduce:
# S |theta| bytes cross shards each way whatever the client count.  A rule
# that needs the whole client axis at once (coordinate sorts, Krum's
# distances, Weiszfeld) all_gathers the local stacks and runs the flat
# rule as it is.


def rule_decomposes(cfg: WSSLConfig) -> bool:
    """Whether the configured rule aggregates per shard (a masked weighted
    sum) or needs the all_gather fallback."""
    return get_aggregator(cfg.resolve_aggregation().rule).decomposes


def partial_weighted_sum(stacked: Params, coefs: torch.Tensor) -> Params:
    """sum_i w_i theta_i over the (local) client axis, unnormalized and in
    fp32: one shard's partial aggregate.  ``coefs`` carry the *global*
    normalization, so the cross-shard sum completes the mean.  A matmul,
    ``w @ flat``, as JAX computes it (outside any kernel)."""
    w = coefs.float()

    def one(a):
        return (w @ a.reshape(a.shape[0], -1).float()).reshape(a.shape[1:])

    return tree_map(one, stacked)


def _tree_coefs(importance, mask, acfg, safe):
    coef_fn = (wssl.safe_mean_coefficients if safe
               else wssl.mean_coefficients)
    return coef_fn(importance, mask,
                   use_importance=acfg.rule == "importance")


def shard_aggregate_clients(stacked: Params, importance: torch.Tensor,
                            mask: torch.Tensor, cfg: WSSLConfig, *, group,
                            shard_index: int, num_shards: int,
                            safe: bool = False,
                            params: Optional[AggParams] = None) -> Params:
    """Algorithm 2 step 5 on one rank of a client-sharded round.
    ``stacked`` leaves are local ``(N/S, ...)``; ``importance`` and
    ``mask`` the whole (N,) vectors every rank holds.  Returns the global
    stage, the same on every rank.

    Decomposable rules: coefficients normalized against the global mask
    (the flat rule's), sliced to the shard, the partial weighted sum, an
    all_reduce, a cast to each leaf's dtype: the flat rule up to the order
    of the client sum.  Every other rule: all_gather of the local stacks
    (flat client order), then the flat rule as it is."""
    from repro_torch import sharding
    acfg = cfg.resolve_aggregation()
    agg = get_aggregator(acfg.rule)
    p = agg_params(acfg) if params is None else params
    n_loc = tree_leaves(stacked)[0].shape[0]
    if agg.decomposes:
        coefs = _tree_coefs(importance, mask, acfg, safe)
        loc = coefs[shard_index * n_loc:(shard_index + 1) * n_loc]
        part = partial_weighted_sum(stacked, loc)
        sharding.all_reduce_tree(part, group)
        return tree_map(lambda t, a: t.to(a.dtype), part, stacked)
    full = tree_map(lambda a: sharding.all_gather_rows(a, group), stacked)
    return agg.fn(full, importance, mask, p, safe=safe, use_kernel=False)


def tree_aggregate(stacked: Params, importance: torch.Tensor,
                   mask: torch.Tensor, cfg: WSSLConfig, *, num_shards: int,
                   safe: bool = False,
                   params: Optional[AggParams] = None) -> Params:
    """The two-level tree on one process, without a group: the client axis
    split into ``num_shards`` contiguous groups (client i in shard i //
    (N/S), the sharded round's layout), a partial sum each, the partials
    combined pairwise in a binary tree.  A decomposable rule equals
    :func:`aggregate_clients` up to the order of the sum; every other
    rule is the flat rule exactly (the fallback)."""
    acfg = cfg.resolve_aggregation()
    agg = get_aggregator(acfg.rule)
    p = agg_params(acfg) if params is None else params
    if not agg.decomposes:
        return agg.fn(stacked, importance, mask, p, safe=safe,
                      use_kernel=False)
    n = tree_leaves(stacked)[0].shape[0]
    if n % num_shards != 0:
        raise ValueError(f"tree_aggregate: {n} clients do not divide into "
                         f"{num_shards} shards")
    n_loc = n // num_shards
    coefs = _tree_coefs(importance, mask, acfg, safe)
    partials = [partial_weighted_sum(
        tree_map(lambda a: a[s * n_loc:(s + 1) * n_loc], stacked),
        coefs[s * n_loc:(s + 1) * n_loc]) for s in range(num_shards)]
    while len(partials) > 1:               # the binary combine tree
        partials = [tree_map(torch.add, partials[i], partials[i + 1])
                    if i + 1 < len(partials) else partials[i]
                    for i in range(0, len(partials), 2)]
    return tree_map(lambda t, a: t.to(a.dtype), partials[0], stacked)
