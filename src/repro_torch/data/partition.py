"""Client data partitioning: IID, stratified (the paper's CIFAR protocol),
and Dirichlet non-IID (the skew regime WSSL targets, §II-E).

A copy of ``repro/data/partition.py`` (numpy only): the same arguments
give the same index arrays in both packages."""

from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(n: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_clients)]


def partition_stratified(labels: np.ndarray, num_clients: int,
                         seed: int = 0) -> List[np.ndarray]:
    """Each client gets the same class distribution (paper §IV-B)."""
    rng = np.random.default_rng(seed)
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        for i, chunk in enumerate(np.array_split(idx, num_clients)):
            parts[i].extend(chunk.tolist())
    return [np.sort(np.array(p, dtype=np.int64)) for p in parts]


def partition_dirichlet(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.3, seed: int = 0,
                        min_per_client: int = 8) -> List[np.ndarray]:
    """Label-skewed non-IID split: class c mass over clients ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        probs = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(probs) * len(idx)).astype(int)[:-1]
        for i, chunk in enumerate(np.split(idx, cuts)):
            parts[i].extend(chunk.tolist())
    # guarantee a floor so every client can form a batch.  The floor is
    # clamped to what the dataset can actually support (at 10k clients a
    # small corpus cannot give everyone min_per_client), which also makes
    # the donor pass provably terminate.  Donors are visited largest-first
    # by a pointer that only ever advances — once a donor is drained to
    # the floor it is never revisited — so the whole rebalance is
    # O(moves + C log C), not the O(C²) rescan-per-deficit of the naive
    # loop (checked at 10k clients in the JAX package's tests).
    floor = min(min_per_client, len(labels) // num_clients)
    donors = np.argsort([len(p) for p in parts])[::-1]
    di = 0
    for i in range(num_clients):
        while len(parts[i]) < floor and di < num_clients:
            d = donors[di]
            if d == i or len(parts[d]) <= floor:
                di += 1
                continue
            parts[i].append(parts[d].pop())
    return [np.sort(np.array(p, dtype=np.int64)) for p in parts]


def partition_for_scenario(labels: np.ndarray, num_clients: int,
                           scenario=None, seed: int = 0) -> List[np.ndarray]:
    """Scenario-aware split: Dirichlet label skew when the
    scenario sets ``skew_alpha``, the paper's stratified protocol otherwise.

    ``scenario`` is a :class:`repro_torch.config.Scenario` (or anything
    with a ``skew_alpha`` attribute); None means clean/stratified."""
    alpha = getattr(scenario, "skew_alpha", None)
    sc_seed = getattr(scenario, "seed", 0)
    if alpha is None:
        return partition_stratified(labels, num_clients, seed=seed)
    return partition_dirichlet(labels, num_clients, alpha=alpha,
                               seed=seed + sc_seed)


def partition_by_subject(subjects: np.ndarray, num_clients: int
                         ) -> List[np.ndarray]:
    """Assign whole subjects to clients (the gait dataset's natural split)."""
    uniq = np.unique(subjects)
    groups = np.array_split(uniq, num_clients)
    return [np.sort(np.flatnonzero(np.isin(subjects, g))) for g in groups]
