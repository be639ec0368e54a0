"""Fault injection for WSSL rounds — the twin of ``repro/sim/faults.py``.

A :class:`~repro_torch.config.Scenario` lowers to :class:`ScenarioParams`
(its knobs as fp32 numbers).  Each round samples them into a
:class:`FaultPlan` of ``(N,)`` fp32 vectors that compose with the
Gumbel-top-k selection mask:

* ``keep``        — 1/0 round survival (a dropped client multiplies into
                    the participation mask like an unselected one).
* ``flip``        — 1 for adversarial clients whose training labels shift.
* ``grad_scale``  — stragglers (and clients behind slow edge hops) finish
                    1/slowdown of a local step; applied to the parameter
                    *update* after the optimizer, since Adam's normalized
                    step ignores a constant gradient scale.
* ``noise_scale`` — sigma of Gaussian noise on the client-stage gradient.
* ``sign_flip``   — Byzantine clients send the negated gradient.
* ``byz_scale``   — Byzantine amplification of the sent update.
* ``adaptive``    — ALIE-style adversaries send mean(honest) - z std(honest).

Multi-hop pipelines add per-hop faults: each edge-hop replica can die for
a round (masking the clients routed through it, composed into ``keep``)
or straggle (composed into ``grad_scale``).

What differs from the JAX module, and why:

* **Every draw can be injected.**  The dropout Bernoulli and the two
  per-hop Bernoullis are ``u < p`` on uniforms (as ``jax.random.bernoulli``
  computes them), and :class:`FaultDraws` carries those uniforms; the
  gradient noise comes from a ``noise(leaf_index, shape)`` hook.  Without
  them, the draws come from an explicit ``torch.Generator``.
* **In place.**  The gradient and update transforms write into the trees
  they are given (the round owns them) and return them.  The update
  transforms take the pre-step rows of the clients listed in ``rows``
  only; a client outside ``rows`` must not have moved (a masked client,
  frozen by the optimizer), and its pre-step row is its current one.
* **A transform with nothing to do does nothing.**  JAX applies each one
  as an exact identity at the clean point (multiply by 1.0, add 0 x
  noise, ``where`` on an all-false mask); here a plan with no noisy,
  sign-flipped, scaled or adaptive client skips the pass, so the
  ``clean`` scenario equals the round without one bit for bit.
* The ``axis_name`` branch of the adaptive attack (client-axis sharding)
  is not ported (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import Scenario
from repro_torch.tree import tree_leaves

Params = Any

Noise = Callable[[int, Tuple[int, ...]], torch.Tensor]


class ScenarioParams(NamedTuple):
    """A Scenario's knobs, each rounded to fp32 as the JAX package's traced
    scalars are."""

    dropout_prob: float
    straggler_fraction: float
    straggler_slowdown: float
    label_flip_fraction: float
    gradient_noise_fraction: float
    gradient_noise_scale: float
    sign_flip_fraction: float
    grad_scale_fraction: float
    grad_scale_factor: float
    adaptive_fraction: float
    adaptive_margin: float
    hop_dropout_prob: float
    hop_latency_prob: float
    hop_latency_slowdown: float


class FaultPlan(NamedTuple):
    """Per-round (N,) fp32 fault vectors, composable with the selection
    mask."""

    keep: torch.Tensor          # 1.0 = survives the round, 0.0 = dropped
    flip: torch.Tensor          # 1.0 = training labels corrupted
    grad_scale: torch.Tensor    # straggler update fraction (1.0 = full)
    noise_scale: torch.Tensor   # gradient-noise sigma (0.0 = none)
    sign_flip: torch.Tensor     # 1.0 = client-stage gradient negated
    byz_scale: torch.Tensor     # Byzantine update scale (1.0 = none)
    adaptive: torch.Tensor      # ALIE evasion margin z (0.0 = honest)


class FaultDraws(NamedTuple):
    """Injected draws of one round's faults (tests feed the JAX draws):
    ``dropout`` (N,) and ``dead`` / ``slow_hop`` (num_hops, replicas)
    uniforms in [0, 1), compared against their probabilities; ``noise``
    returns the standard-normal draw of gradient leaf ``i`` (in
    ``tree.tree_leaves`` order) at ``shape``.  A field left None is
    drawn from the generator."""

    dropout: Optional[torch.Tensor] = None
    dead: Optional[torch.Tensor] = None
    slow_hop: Optional[torch.Tensor] = None
    noise: Optional[Noise] = None


def scenario_params(sc: Scenario) -> ScenarioParams:
    """Lower a Scenario's round-relevant knobs to fp32 numbers."""
    return ScenarioParams(*(float(np.float32(getattr(sc, f)))
                            for f in ScenarioParams._fields))


def _uniform(given: Optional[torch.Tensor], shape: Tuple[int, ...],
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    if given is not None:
        return given.to(device=device, dtype=torch.float32).reshape(shape)
    if generator is None:
        raise ValueError("a fault draw needs a generator or an injected "
                         "draw")
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device).to(device)


def sample_fault_plan(sp: ScenarioParams, num_clients: int,
                      num_hops: int = 0, hop_replicas: int = 1, *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[FaultDraws] = None,
                      device=None) -> FaultPlan:
    """One round's FaultPlan on ``device``.  Cohorts are deterministic
    index ranges (``floor(fraction * N)`` adversaries from the bottom,
    stragglers from the top, as ``Scenario.adversary_ids`` /
    ``straggler_ids``); only dropout and the per-hop faults draw: the
    dropout uniforms first, then the dead-replica and the slow-replica
    ones, each from ``draws`` or else from ``generator``.

    ``num_hops`` is the number of edge stages; each hop level has
    ``hop_replicas`` fault domains and client i routes through replica
    ``i % hop_replicas`` at every level.  A dead replica masks exactly its
    routed clients; a slow one scales their round progress (the min with
    the client's own straggler scale).  Arithmetic in fp32, as JAX's."""
    draws = draws if draws is not None else FaultDraws()
    if device is None:
        device = generator.device if generator is not None else "cpu"
    n = num_clients
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    one = f(1.0)
    ids = torch.arange(n, dtype=torch.float32, device=device)
    cohort = lambda frac: ids + 1.0 <= f(frac) * n + 1e-6
    flip = cohort(sp.label_flip_fraction)
    noisy = cohort(sp.gradient_noise_fraction)
    sflip = cohort(sp.sign_flip_fraction)
    scaled = cohort(sp.grad_scale_fraction)
    adaptive = cohort(sp.adaptive_fraction)
    n_strag = torch.floor(f(sp.straggler_fraction) * n + 1e-6)
    strag = ids >= n - n_strag
    dropped = _uniform(draws.dropout, (n,), generator, device) < f(
        sp.dropout_prob)
    slow = one / torch.clamp(f(sp.straggler_slowdown), min=1.0)
    keep = 1.0 - dropped.float()
    grad_scale = torch.where(strag, slow, one)

    if num_hops > 0:
        r = max(int(hop_replicas), 1)
        route = torch.arange(n, device=device) % r
        dead = _uniform(draws.dead, (num_hops, r), generator, device) < f(
            sp.hop_dropout_prob)
        slow_hop = _uniform(draws.slow_hop, (num_hops, r), generator,
                            device) < f(sp.hop_latency_prob)
        keep = keep * (1.0 - dead[:, route].any(dim=0).float())
        hop_slow = one / torch.clamp(f(sp.hop_latency_slowdown), min=1.0)
        hop_scale = torch.where(slow_hop[:, route].any(dim=0), hop_slow, one)
        grad_scale = torch.minimum(grad_scale, hop_scale)

    return FaultPlan(
        keep=keep, flip=flip.float(), grad_scale=grad_scale,
        noise_scale=noisy.float() * f(sp.gradient_noise_scale),
        sign_flip=sflip.float(),
        byz_scale=torch.where(scaled, f(sp.grad_scale_factor), one),
        adaptive=adaptive.float() * f(sp.adaptive_margin))


def _per_client(vec: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a (N,) fault vector against a (N, ...) tensor."""
    return vec.reshape((-1,) + (1,) * (ref.dim() - 1))


def _rows(vec: torch.Tensor) -> List[int]:
    """The clients whose entry of ``vec`` is non-zero, on the host."""
    return torch.nonzero(vec).flatten().tolist()


def client_latencies(plan: Optional[FaultPlan], num_clients: int,
                     device=None) -> torch.Tensor:
    """Per-client simulated round completion time, in units of a clean
    client's round: the inverse of the plan's progress scale (a client at
    4x slowdown finishes at t = 4.0).  ``plan=None`` is a homogeneous
    population, all at t = 1.0."""
    if plan is None:
        return torch.ones((num_clients,), dtype=torch.float32, device=device)
    return 1.0 / torch.clamp(plan.grad_scale, 1e-6, 1.0)


def label_shift(num_classes: int) -> int:
    """The label-flip attack's class shift, shared by the round and the
    paper loop."""
    return max(1, num_classes // 2)


def corrupt_labels(plan: FaultPlan, labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """Shift adversarial clients' labels by label_shift(C) mod C.  labels:
    (N, ...) int; returns a new tensor (``labels`` itself when no client
    flips)."""
    if not _rows(plan.flip):
        return labels
    flipped = (labels + label_shift(num_classes)) % num_classes
    return torch.where(_per_client(plan.flip.to(labels.device), labels) > 0,
                       flipped, labels)


def add_gradient_noise(grads: Params, sigma, per_client: bool = False, *,
                       noise: Optional[Noise] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Params:
    """N(0, sigma^2) on every gradient leaf, in place: ``g + s * eps`` with
    ``eps`` the standard-normal draw of leaf i from ``noise(i, shape)``
    (leaves in ``tree.tree_leaves`` order, JAX's), else from
    ``generator``.  ``sigma`` is a scalar, or a (N,) vector broadcast over
    stacked (N, ...) leaves when ``per_client``.  Returns ``grads``."""
    for i, g in enumerate(tree_leaves(grads)):
        if per_client:
            s = _per_client(sigma, g).to(device=g.device, dtype=g.dtype)
        else:
            s = torch.tensor(sigma, dtype=g.dtype, device=g.device)
        if noise is not None:
            eps = noise(i, tuple(g.shape)).to(device=g.device, dtype=g.dtype)
        else:
            eps = torch.randn(g.shape, generator=generator, dtype=g.dtype,
                              device=generator.device).to(g.device)
        g.add_(eps.mul_(s))
    return grads


def apply_sign_flip(plan: FaultPlan, grads: Params) -> Params:
    """Negate the sign-flipped clients' rows of stacked (N, ...) client
    gradients, in place (the client ascends instead of descending)."""
    rows = _rows(plan.sign_flip)
    for g in tree_leaves(grads) if rows else ():
        for i in rows:
            g[i].neg_()
    return grads


def corrupt_client_grads(plan: FaultPlan, grads: Params, *,
                         noise: Optional[Noise] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Params:
    """Byzantine sign flip, then adversarial Gaussian noise, on stacked
    (N, ...) client-stage gradients, in place.  No noise is drawn when no
    client is noisy (JAX adds 0 x noise there).  Constant magnitude
    attacks go through :func:`scale_client_updates` instead."""
    apply_sign_flip(plan, grads)
    if _rows(plan.noise_scale):
        add_gradient_noise(grads, plan.noise_scale, per_client=True,
                           noise=noise, generator=generator)
    return grads


def _row_index(rows: Optional[Sequence[int]], n: int) -> List[int]:
    return list(range(n)) if rows is None else list(rows)


@torch.no_grad()
def scale_client_updates(plan: FaultPlan, new_params: Params,
                         old_params: Params,
                         rows: Optional[Sequence[int]] = None) -> Params:
    """Per-client update scaling, in place: theta <- theta_old + s *
    (theta_new - theta_old) in fp32, rounded once to the leaf's dtype,
    with s = grad_scale * byz_scale (straggler progress s < 1, Byzantine
    amplification s > 1).  ``old_params`` holds the pre-step rows of the
    clients ``rows`` (default: all N, in order); an affected client
    outside ``rows`` did not move, and its scaled update is its row as it
    is.  Unaffected clients keep theta_new bit for bit."""
    scale = plan.grad_scale * plan.byz_scale
    n = scale.shape[0]
    affected = set(_rows(scale != 1.0))
    hit = [(j, i) for j, i in enumerate(_row_index(rows, n)) if i in affected]
    for new, old in zip(tree_leaves(new_params), tree_leaves(old_params)):
        for j, i in hit:
            o = old[j].float()
            sc = scale[i].to(new.device)
            new[i] = (o + sc * (new[i].float() - o)).to(new.dtype)
    return new_params


@torch.no_grad()
def adaptive_scale_updates(plan: FaultPlan, new_params: Params,
                           old_params: Params, mask: torch.Tensor,
                           rows: Optional[Sequence[int]] = None) -> Params:
    """Adaptive Byzantine attack ("a little is enough", Baruch et al.), in
    place: each adaptive client sends

        delta_sent = mean(delta_honest) - z * std(delta_honest)

    per coordinate, over the ``mask``-participating, surviving,
    non-adaptive clients (the population statistics of JAX: sums over all
    N rows with the honest weights, divided by the honest count).  Its
    sent stage sits inside the honest spread, so importance weighting
    cannot down-weight it; distance-based rules out-vote it.  ``old_params``
    and ``rows`` as in :func:`scale_client_updates`; every adaptive
    client's row is replaced, selected or not (its validation reads it).
    Nothing moves when no client is adaptive."""
    is_adaptive = (plan.adaptive > 0).float()
    adaptive = _rows(is_adaptive)
    if not adaptive:
        return new_params
    honest = mask * plan.keep * (1.0 - is_adaptive)
    denom = torch.clamp(honest.sum(), min=1.0)
    n = honest.shape[0]
    idx = _row_index(rows, n)
    pos = {i: j for j, i in enumerate(idx)}
    for new, old in zip(tree_leaves(new_params), tree_leaves(old_params)):
        delta = torch.zeros(new.shape, dtype=torch.float32, device=new.device)
        delta[idx] = new[idx].float() - old.float()
        h = _per_client(honest.to(new.device), delta)
        mu = (h * delta).sum(dim=0) / denom
        var = (h * (delta - mu) ** 2).sum(dim=0) / denom
        del delta, h
        sd = torch.sqrt(var)
        for i in adaptive:
            o = old[pos[i]] if i in pos else new[i]
            crafted = mu - plan.adaptive[i].to(new.device) * sd
            new[i] = (o.float() + crafted).to(new.dtype)
    return new_params
