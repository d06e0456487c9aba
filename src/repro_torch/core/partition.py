"""Client data partitioning schemes (§5.2 of the paper).

Heterogeneity is feature-distribution skew driven by class identity:
each "class" is one underlying distribution p^(m) in Eq. 1.

- ``Dir(alpha)``: for each class, its samples are distributed over the C
  clients with proportions drawn from a symmetric Dirichlet(alpha).
  Smaller alpha => more heterogeneous (Fig. 1).
- ``Quantity(alpha)``: each client receives data from exactly ``alpha``
  randomly chosen classes ("quantity-based label imbalance").

Partitioning is host-side data-pipeline work, so it runs in numpy; the
result is padded fixed-shape arrays + 0/1 masks so that local training can
run under vmap / shard_map with ragged client sizes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ClientSplit(NamedTuple):
    """Padded per-client datasets.

    data : (C, N_max, d) float32, zero-padded
    mask : (C, N_max) float32 in {0, 1}
    sizes: (C,) int64 true local dataset sizes |D_c|
    class_counts: (C, M) number of points of each class per client
    """
    data: np.ndarray
    mask: np.ndarray
    sizes: np.ndarray
    class_counts: np.ndarray


def _pack(per_client: list[np.ndarray], n_classes: int,
          per_client_labels: list[np.ndarray], pad_to: int | None = None) -> ClientSplit:
    c = len(per_client)
    d = per_client[0].shape[1]
    sizes = np.array([len(p) for p in per_client], dtype=np.int64)
    n_max = int(pad_to or max(int(sizes.max()), 1))
    data = np.zeros((c, n_max, d), dtype=np.float32)
    mask = np.zeros((c, n_max), dtype=np.float32)
    counts = np.zeros((c, n_classes), dtype=np.int64)
    for i, (p, lab) in enumerate(zip(per_client, per_client_labels)):
        n = len(p)
        data[i, :n] = p
        mask[i, :n] = 1.0
        if n:
            counts[i] = np.bincount(lab, minlength=n_classes)
    return ClientSplit(data, mask, sizes, counts)


def partition_dirichlet(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                        n_clients: int, alpha: float,
                        min_size: int = 2) -> ClientSplit:
    """Dir(alpha) partitioning: per-class Dirichlet proportions over clients."""
    n_classes = int(y.max()) + 1
    while True:  # re-draw until every client has at least min_size points
        idx_lists: list[list[int]] = [[] for _ in range(n_clients)]
        for m in range(n_classes):
            idx = np.flatnonzero(y == m)
            rng.shuffle(idx)
            props = rng.dirichlet(alpha * np.ones(n_clients))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for c, part in enumerate(np.split(idx, cuts)):
                idx_lists[c].extend(part.tolist())
        if min(len(l) for l in idx_lists) >= min_size:
            break
    per, labels = [], []
    for l in idx_lists:
        sel = np.array(sorted(l))
        per.append(x[sel])
        labels.append(y[sel])
    return _pack(per, n_classes, labels)


def partition_quantity(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                       n_clients: int, alpha: int,
                       min_size: int = 2) -> ClientSplit:
    """Quantity(alpha): each client gets data from ``alpha`` random classes.

    Each class's points are split evenly among the clients assigned to it.
    Every class is guaranteed at least one client (round-robin backstop) so
    no part of the global distribution disappears.
    """
    n_classes = int(y.max()) + 1
    alpha = int(alpha)
    # choose alpha classes per client (as sets)
    choices = [set(rng.choice(n_classes, size=min(alpha, n_classes),
                              replace=False).tolist())
               for _ in range(n_clients)]
    # backstop: every class must keep >= 1 client so no data is dropped —
    # each uncovered class is ADDED to the currently least-loaded client
    # (max classes per client stays <= alpha + ceil(M / n_clients);
    # documented data-conservation choice)
    covered = set().union(*choices)
    for m in range(n_classes):
        if m not in covered:
            least = min(range(n_clients), key=lambda c: len(choices[c]))
            choices[least].add(m)

    idx_lists: list[list[int]] = [[] for _ in range(n_clients)]
    for m in range(n_classes):
        takers = [c for c in range(n_clients) if m in choices[c]]
        idx = np.flatnonzero(y == m)
        rng.shuffle(idx)
        for c, part in zip(takers, np.array_split(idx, len(takers))):
            idx_lists[c].extend(part.tolist())
    per, labels = [], []
    for l in idx_lists:
        sel = np.array(sorted(l), dtype=np.int64) if l else np.zeros(0, np.int64)
        per.append(x[sel])
        labels.append(y[sel])
    return _pack(per, n_classes, labels)


def partition(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
              n_clients: int, scheme: str, alpha: float) -> ClientSplit:
    if scheme == "dirichlet":
        return partition_dirichlet(rng, x, y, n_clients, alpha)
    if scheme == "quantity":
        return partition_quantity(rng, x, y, n_clients, int(alpha))
    raise ValueError(f"unknown partition scheme: {scheme!r}")
