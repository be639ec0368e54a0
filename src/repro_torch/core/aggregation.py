"""The aggregator registry of Algorithm 2 step 5.

The twin of ``repro/core/aggregation.py``.  Every entry has the signature

    rule(stacked, importance, mask, params, *, safe, use_kernel) -> Params

over a client-stacked tree (leaves ``(N, ...)``), the ``(N,)`` importance
and the ``(N,)`` participation mask.  The weighted rules ``importance`` and
``uniform`` are ported: they turn the mask into normalized coefficients
(``core/wssl.py``) and average with them, through the weighted-average
kernel when ``use_kernel`` is set.  Every robust rule of the JAX package is
registered under its name and raises ``NotImplementedError`` until it is
ported (ROADMAP Queue 1, item 8); nothing is silently substituted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.config import AggregationConfig, WSSLConfig
from repro_torch.core import wssl

Params = Any


class AggParams(NamedTuple):
    """The rule knobs of an AggregationConfig as fp32 numbers.  The weighted
    rules read none of them; the robust rules will (ROADMAP Queue 1,
    item 8)."""

    trim_fraction: float
    byzantine_f: float
    multi_krum_m: float       # 0.0 = auto (s - f)
    clip_factor: float = 1.0


def agg_params(cfg: AggregationConfig) -> AggParams:
    m = 0.0 if cfg.multi_krum_m is None else cfg.multi_krum_m
    return AggParams(trim_fraction=float(cfg.trim_fraction),
                     byzantine_f=float(cfg.byzantine_f),
                     multi_krum_m=float(m), clip_factor=float(cfg.clip_factor))


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
    # False for the JAX package's rules that are registered but not ported
    ported: bool = True


_AGGREGATORS: Dict[str, Aggregator] = {}

_UNPORTED = ("aggregation rule {!r} is not ported yet (ROADMAP Queue 1, "
             "item 8: robust aggregation and faults)")


def register_aggregator(name: str, *, weighted: bool = False,
                        decomposes: bool = False, doc: str = "",
                        ported: bool = True
                        ) -> Callable[[AggregatorFn], AggregatorFn]:
    """Register ``fn(stacked, importance, mask, params, *, safe,
    use_kernel)`` under ``name``.  A later registration overrides an
    earlier one (user rules can shadow built-ins)."""
    def deco(fn: AggregatorFn) -> AggregatorFn:
        _AGGREGATORS[name] = Aggregator(name=name, fn=fn, weighted=weighted,
                                        decomposes=decomposes,
                                        doc=doc or (fn.__doc__ or ""),
                                        ported=ported)
        return fn
    return deco


def get_aggregator(name: str) -> Aggregator:
    if name not in _AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; known: "
                       f"{list_aggregators()}")
    return _AGGREGATORS[name]


def list_aggregators() -> List[str]:
    return sorted(_AGGREGATORS)


def resolve(cfg: WSSLConfig) -> Aggregator:
    """The aggregator ``cfg`` names; raises ``NotImplementedError`` for a
    rule that is registered but not ported yet."""
    agg = get_aggregator(cfg.resolve_aggregation().rule)
    if not agg.ported:
        raise NotImplementedError(_UNPORTED.format(agg.name))
    return agg


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


def _unported(name: str, *, weighted: bool = False) -> None:
    def rule(stacked, importance, mask, params, *, safe=False,
             use_kernel=False):
        raise NotImplementedError(_UNPORTED.format(name))
    register_aggregator(name, weighted=weighted, ported=False,
                        doc=f"{name} (not ported yet)")(rule)


for _name in ("trimmed_mean", "median", "krum", "multi_krum",
              "geometric_median"):
    _unported(_name)
_unported("norm_clip", weighted=True)


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
    weighted rules."""
    agg = resolve(cfg)
    p = agg_params(cfg.resolve_aggregation()) if params is None else params
    return agg.fn(stacked, importance, mask, p, safe=safe,
                  use_kernel=use_kernel)
