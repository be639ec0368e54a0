"""WSSL Algorithm 1 — importance weights and weighted sampling of clients —
and the Algorithm 2 aggregation coefficients.

The twin of ``repro/core/wssl.py``.  "Selecting" k of N clients yields a
(N,) float participation mask over the fixed client axis, and weighted
sampling without replacement is Gumbel top-k over the importance logits.
The Gumbel noise is the selection's one random draw:
:func:`weighted_sample` takes an explicit ``torch.Generator`` or an
injected ``gumbel`` tensor, so a test can feed the JAX package's draw and
get its selection exactly.  The other draws of a round (compression,
faults) come from streams of their own (:func:`derived_generator`) and
never advance the selection generator.

The parameter aggregation itself is the registry in
``core/aggregation.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.config import WSSLConfig
from repro_torch.kernels import ops

Params = Any

_TINY = torch.finfo(torch.float32).tiny


# ---------------------------------------------------------------------------
# Importance weights (Algorithm 1 steps b-c)
# ---------------------------------------------------------------------------


def compute_importance(val_losses: torch.Tensor, cfg: WSSLConfig,
                       prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """beta_i from per-client validation losses (lower loss, higher weight):
    softmax(-loss / T), an EMA with ``prev``, normalized."""
    temp = torch.tensor(cfg.importance_temp, dtype=torch.float32,
                        device=val_losses.device)
    beta = torch.softmax(-val_losses.float() / temp, dim=-1)
    if prev is not None:
        beta = cfg.importance_ema * prev + (1.0 - cfg.importance_ema) * beta
    return normalize_weights(beta)


def normalize_weights(beta: torch.Tensor) -> torch.Tensor:
    """gamma_i = beta_i / sum(beta)  (Algorithm 1 line 8)."""
    return beta / torch.clamp(beta.sum(), min=1e-12)


# ---------------------------------------------------------------------------
# Weighted sampling (Algorithm 1 step d)
# ---------------------------------------------------------------------------


_M64 = (1 << 64) - 1


def _mix(x: int, v: int) -> int:
    """One splitmix64 step of ``x ^ v``."""
    x = ((x ^ v) + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derived_generator(seed: int, *values: int, device=None
                      ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and
    ``values`` by splitmix64: one independent stream per tuple, the
    counterpart of folding the values into a JAX key.  A draw from it
    never advances any other generator."""
    for v in values:
        seed = _mix(seed, v & _M64)
    return torch.Generator(device=device).manual_seed(seed >> 1)


def gumbel_noise(shape, generator: torch.Generator, *,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(u))``, u uniform in [tiny, 1), from
    ``generator`` (on its own device), moved to ``device``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device).clamp_(min=_TINY)
    return (-torch.log(-torch.log(u))).to(device or generator.device)


def weighted_sample(weights: torch.Tensor, k: int, *,
                    generator: Optional[torch.Generator] = None,
                    gumbel: Optional[torch.Tensor] = None,
                    penalty: Optional[torch.Tensor] = None,
                    beta: float = 0.0) -> torch.Tensor:
    """k distinct client indices drawn in proportion to ``weights`` (Gumbel
    top-k).  The noise is ``gumbel`` when given, else drawn from
    ``generator``.  ``penalty`` with ``beta > 0`` is subtracted from the
    keys (staleness-aware selection); ``beta = 0`` leaves the draw as is."""
    if gumbel is None:
        if generator is None:
            raise ValueError("weighted_sample needs a generator or a gumbel "
                             "draw")
        gumbel = gumbel_noise(weights.shape, generator, device=weights.device)
    keys = torch.log(torch.clamp(weights, min=1e-12)) + gumbel.to(weights.device)
    if penalty is not None and beta:
        keys = keys - beta * penalty
    return torch.topk(keys, k).indices


def selection_mask(idx: torch.Tensor, num_clients: int) -> torch.Tensor:
    """(k,) indices -> (N,) float mask."""
    mask = torch.zeros((num_clients,), dtype=torch.float32, device=idx.device)
    return mask.index_fill_(0, idx, 1.0)


def participation_mask(weights: torch.Tensor, cfg: WSSLConfig, round_index,
                       *, idx: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       penalty: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Algorithm 1's participation as a (N,) mask, with the rule of line 4:
    round 0 selects every client.  The sample is drawn (or ``idx`` reused)
    in every round, round 0 too, as in the JAX package."""
    if idx is None:
        idx = weighted_sample(weights, cfg.num_selected(), generator=generator,
                              gumbel=gumbel, penalty=penalty,
                              beta=cfg.select_staleness_beta)
    mask = selection_mask(idx, cfg.num_clients)
    if int(round_index) == 0:
        return torch.ones_like(mask)
    return mask


def select_clients(weights: torch.Tensor, cfg: WSSLConfig,
                   round_index: int = 1, *,
                   generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None,
                   penalty: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Algorithm 1 for one epoch, the host-side view with concrete
    indices: (the selected indices, the (N,) mask).  The sample is drawn
    in every round; round 0 returns every client (the rule of
    :func:`participation_mask`)."""
    sampled = weighted_sample(weights, cfg.num_selected(), generator=generator,
                              gumbel=gumbel, penalty=penalty,
                              beta=cfg.select_staleness_beta)
    mask = participation_mask(weights, cfg, round_index, idx=sampled)
    if int(round_index) == 0:
        return torch.arange(cfg.num_clients, dtype=torch.int32,
                            device=weights.device), mask
    return sampled, mask


# ---------------------------------------------------------------------------
# Aggregation coefficients (Algorithm 2 step 5)
# ---------------------------------------------------------------------------


def mean_coefficients(weights: torch.Tensor, mask: torch.Tensor, *,
                      use_importance: bool = True) -> torch.Tensor:
    """Normalized per-client mean coefficients over a (possibly fractional)
    mask, importance-weighted or uniform."""
    w = weights * mask if use_importance else mask
    return w / torch.clamp(w.sum(), min=1e-12)


def safe_mean_coefficients(weights: torch.Tensor, mask: torch.Tensor, *,
                           use_importance: bool = True) -> torch.Tensor:
    """:func:`mean_coefficients` falling back to every client when the mask
    is empty (then the round is a no-op sync)."""
    w = mean_coefficients(weights, mask, use_importance=use_importance)
    full = mean_coefficients(weights, torch.ones_like(mask),
                             use_importance=use_importance)
    return torch.where(mask.sum() > 0, w, full)


def _rule_uses_importance(cfg: WSSLConfig) -> bool:
    # only the paper's rule weighs the mean (and the per-client losses) by
    # importance; every other rule treats participants uniformly here
    return cfg.resolve_aggregation().rule == "importance"


def aggregation_weights(weights: torch.Tensor, mask: torch.Tensor,
                        cfg: WSSLConfig) -> torch.Tensor:
    """Per-client aggregation coefficients, restricted to the selected
    clients (these also weight the per-client losses of the round)."""
    return mean_coefficients(weights, mask,
                             use_importance=_rule_uses_importance(cfg))


def safe_aggregation_weights(weights: torch.Tensor, mask: torch.Tensor,
                             cfg: WSSLConfig) -> torch.Tensor:
    """:func:`aggregation_weights` with the empty-mask fallback."""
    return safe_mean_coefficients(weights, mask,
                                  use_importance=_rule_uses_importance(cfg))


# ---------------------------------------------------------------------------
# Bounded-staleness discounts (for the async rounds)
# ---------------------------------------------------------------------------


def staleness_weights(staleness: torch.Tensor, max_staleness,
                      kind: str = "polynomial", alpha=0.5) -> torch.Tensor:
    """Per-client discount w(s) in [0, 1]: exactly 1 at s = 0 under every
    ``kind`` and exactly 0 at s >= max_staleness; between them 1
    (``constant``), (1 + s)^-alpha (``polynomial``) or exp(-alpha s)
    (``exponential``)."""
    s = torch.as_tensor(staleness, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=s.device)
    if kind == "constant":
        base = torch.ones_like(s)
    elif kind == "polynomial":
        base = torch.pow(1.0 + s, -alpha)
    elif kind == "exponential":
        base = torch.exp(-alpha * s)
    else:
        raise ValueError(f"unknown staleness weighting {kind!r}")
    limit = torch.as_tensor(max_staleness, dtype=torch.float32,
                            device=s.device)
    return torch.where(s < limit, base, torch.zeros_like(base))


def async_contribution(fresh_mask: torch.Tensor, arriving_mask: torch.Tensor,
                       staleness: torch.Tensor, max_staleness,
                       kind: str = "polynomial", alpha=0.5) -> torch.Tensor:
    """The (N,) fractional participation mask of a bounded-staleness round:
    fresh clients at 1, arriving buffered updates at their discount."""
    w = staleness_weights(staleness, max_staleness, kind=kind, alpha=alpha)
    return fresh_mask + arriving_mask * w


# ---------------------------------------------------------------------------
# Parameter averaging and sync
# ---------------------------------------------------------------------------


def weighted_average(stacked: Params, coefs: torch.Tensor, *,
                     use_kernel: bool = False) -> Params:
    """theta_global = sum_i w_i theta_i over the stacked client axis (leaf
    dim 0), summed in fp32 and rounded once to the leaf's dtype.
    ``use_kernel`` sends each leaf through ``kernels/ops.weighted_average``
    (the CUDA kernel on the card, its plain version on the CPU)."""
    w = coefs.float()
    if use_kernel:
        return tree_map(lambda a: ops.weighted_average(a, w), stacked)

    def one(a):
        out = w @ a.reshape(a.shape[0], -1).float()
        return out.reshape(a.shape[1:]).to(a.dtype)

    return tree_map(one, stacked)


def trimmed_mean_average(stacked: Params, mask: torch.Tensor,
                         trim_fraction: float = 0.1) -> Params:
    """Legacy alias: the rule lives in the aggregator registry
    (``core/aggregation.py::trimmed_mean_average``)."""
    from repro_torch.core import aggregation
    return aggregation.trimmed_mean_average(stacked, mask, trim_fraction)


def aggregate_clients(stacked: Params, importance: torch.Tensor,
                      mask: torch.Tensor, cfg: WSSLConfig, *,
                      safe: bool = False) -> Params:
    """Legacy alias: Algorithm 2 step 5 dispatches through the aggregator
    registry (``core/aggregation.py::aggregate_clients``)."""
    from repro_torch.core import aggregation
    return aggregation.aggregate_clients(stacked, importance, mask, cfg,
                                         safe=safe)


@torch.no_grad()
def broadcast_global(stacked: Params, global_params: Params) -> Params:
    """Reset every client's stage to the aggregated global stage, in place
    (the sync); returns ``stacked``."""
    for a, g in zip(tree_leaves(stacked), tree_leaves(global_params)):
        a.copy_(g[None].expand_as(a))
    return stacked
