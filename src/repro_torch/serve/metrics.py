"""Serving metrics: tail latency and degraded-mode output agreement.

A copy of ``repro/serve/metrics.py`` (numpy-only), kept in the port so
that it imports nothing of ``repro``.

The paper's robustness story is measured at training time by accuracy /
fairness deltas under scenarios; the serving analog is (a) the tail of the
request-latency distribution (p50/p95/p99 — faults should show up as a
fatter tail, not as missing answers) and (b) *output agreement*: the
fraction of requests whose degraded-mode token streams exactly match the
clean run.  Greedy decoding plus re-prefill-and-replay re-routing is
deterministic, so agreement below 1.0 flags a correctness bug in the
fault path, not noise.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import numpy as np


def latency_percentiles(latencies: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 (plus mean/max) of a latency sample, in simulated
    decode-step units."""
    if not len(latencies):
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    arr = np.asarray(latencies, np.float64)
    return {
        "p50": float(np.percentile(arr, 50)),
        "p95": float(np.percentile(arr, 95)),
        "p99": float(np.percentile(arr, 99)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
    }


def acceptance_rate(accepted: int, drafted: int) -> float:
    """Fraction of self-drafted tokens the full-pipeline verifier accepted.
    1.0 means the client-stage draft head always agreed with the pipeline;
    0.0 means every round fell back to the single verified token."""
    return float(accepted) / float(drafted) if drafted else 0.0


def slo_attainment(deadlines: Mapping[int, float],
                   completions: Mapping[int, float]) -> Dict[str, float]:
    """SLO accounting over the requests that carried a *finite* deadline.

    * ``attainment`` — fraction completed at or before their deadline.
    * ``on_time`` / ``late`` / ``missed`` — counts; a request absent from
      ``completions`` (shed at admission, or unfinished at ``max_ticks``)
      counts as missed.

    Deadline-less (``inf``) requests are excluded: with no SLO there is
    nothing to attain, and counting them would inflate attainment."""
    finite = {rid: d for rid, d in deadlines.items() if math.isfinite(d)}
    if not finite:
        return {"attainment": 1.0, "on_time": 0.0, "late": 0.0,
                "missed": 0.0}
    on_time = late = missed = 0
    for rid, d in finite.items():
        t = completions.get(rid)
        if t is None:
            missed += 1
        elif t <= d:
            on_time += 1
        else:
            late += 1
    return {"attainment": on_time / len(finite), "on_time": float(on_time),
            "late": float(late), "missed": float(missed)}


def output_agreement(reference: Mapping[int, List[int]],
                     degraded: Mapping[int, List[int]]) -> Dict[str, float]:
    """Compare degraded-mode outputs against the clean reference.

    * ``exact``  — fraction of reference requests whose degraded token
      stream matches exactly (missing requests count as disagreement).
    * ``token``  — mean per-request fraction of agreeing positions,
      normalized by the *longer* stream (truncated or over-long answers
      are penalized; a missing request scores 0).
    * ``answered`` — fraction of reference requests answered at all.
    """
    if not reference:
        return {"exact": 1.0, "token": 1.0, "answered": 1.0}
    exact = token = answered = 0.0
    for rid, ref in reference.items():
        got = degraded.get(rid)
        if got is None:
            continue
        answered += 1.0
        if list(got) == list(ref):
            exact += 1.0
        n = min(len(ref), len(got))
        if n and len(ref):
            agree = sum(int(a == b) for a, b in zip(ref[:n], got[:n]))
            token += agree / max(len(ref), len(got))
    n_ref = len(reference)
    return {"exact": exact / n_ref, "token": token / n_ref,
            "answered": answered / n_ref}
