"""Fairness metrics for WSSL's §VI claims — a copy of
``repro/core/fairness.py`` (numpy and plain Python floats).

* participation entropy (normalized): 1.0 = perfectly even participation.
* Jain's fairness index over participation counts or per-client accuracy.
* per-client accuracy spread (max-min, std).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def participation_entropy(counts: Sequence[float]) -> float:
    c = np.asarray(counts, np.float64)
    p = c / max(c.sum(), 1e-12)
    p = p[p > 0]
    h = -(p * np.log(p)).sum()
    return float(h / np.log(max(len(c), 2)))


def jain_index(values: Sequence[float]) -> float:
    v = np.asarray(values, np.float64)
    if np.allclose(v, 0):
        return 1.0
    return float(v.sum() ** 2 / (len(v) * (v ** 2).sum()))


def accuracy_spread(per_client_acc: Sequence[float]) -> Dict[str, float]:
    a = np.asarray(per_client_acc, np.float64)
    return {
        "min": float(a.min()),
        "max": float(a.max()),
        "spread": float(a.max() - a.min()),
        "std": float(a.std()),
        "jain": jain_index(a),
    }


def fairness_report(participation_counts: Sequence[float],
                    per_client_acc: Sequence[float]) -> Dict[str, float]:
    rep = {"participation_entropy": participation_entropy(participation_counts),
           "participation_jain": jain_index(participation_counts)}
    rep.update({f"acc_{k}": v for k, v in accuracy_spread(per_client_acc).items()})
    return rep


def importance_gap(importance: Sequence[float],
                   corrupt_ids: Sequence[int]) -> Dict[str, float]:
    """How far importance weighting pushes corrupted clients below the
    clean-client mean — the robustness mechanism of §VI made measurable.
    ``gap`` > 0 (equivalently ``downweighted``) means the corrupted cohort
    is, on average, weighted below the clean cohort."""
    imp = np.asarray(importance, np.float64)
    bad = np.zeros(len(imp), bool)
    bad[list(corrupt_ids)] = True
    if not bad.any():
        return {"corrupt_mean": float("nan"), "clean_mean": float(imp.mean()),
                "gap": 0.0, "downweighted": False}
    if bad.all():
        return {"corrupt_mean": float(imp.mean()), "clean_mean": float("nan"),
                "gap": 0.0, "downweighted": False}
    corrupt_mean = float(imp[bad].mean())
    clean_mean = float(imp[~bad].mean())
    return {"corrupt_mean": corrupt_mean, "clean_mean": clean_mean,
            "gap": clean_mean - corrupt_mean,
            "downweighted": corrupt_mean < clean_mean}


def robustness_report(importance: Sequence[float],
                      corrupt_ids: Sequence[int],
                      per_client_val_loss: Optional[Sequence[float]] = None
                      ) -> Dict[str, float]:
    """importance_gap + fairness-variance of the importance distribution
    (and, when given, of per-client validation loss)."""
    rep = dict(importance_gap(importance, corrupt_ids))
    rep["importance_jain"] = jain_index(importance)
    rep["importance_std"] = float(np.asarray(importance, np.float64).std())
    if per_client_val_loss is not None:
        v = np.asarray(per_client_val_loss, np.float64)
        rep["val_loss_std"] = float(v.std())
        rep["val_loss_spread"] = float(v.max() - v.min())
    return rep
