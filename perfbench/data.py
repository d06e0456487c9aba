"""Frozen copies of the data the benchmark feeds the program.

The program's own generators (``repro_torch.data.datasets``) and partition
(``repro_torch.core.partition``) may change in later work; the benchmark's
inputs may not. These are copies of the training split of ``mnist_like``
and ``smd_like`` (the test and OOD rows are drawn as the originals draw
them, and dropped: the fit cells need no test split), of the PCA and
min-max scaling they use, and of ``partition_dirichlet`` and ``_pack``. The loops of the originals are
vectorised where that keeps every array identical and every draw of the
generator in its place; ``perfbench/tests`` holds them to the originals.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ClientSplit(NamedTuple):
    """Padded per-client data: data (C, N_max, d) float32 zero-padded, mask
    (C, N_max) float32 0/1, sizes (C,) int64, class_counts (C, M) int64."""
    data: np.ndarray
    mask: np.ndarray
    sizes: np.ndarray
    class_counts: np.ndarray


def _minmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo, hi = x.min(axis=0), x.max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    return np.clip((x - lo) / span, 0.0, 1.0)


def _pca(x: np.ndarray, n_components: int) -> np.ndarray:
    """Fit PCA on x and project x onto its first components (float32)."""
    x64 = np.asarray(x, dtype=np.float64)
    mean = x64.mean(axis=0)
    _, _, vt = np.linalg.svd(x64 - mean, full_matrices=False)
    comps = vt[:n_components].astype(np.float32)
    return (np.asarray(x, np.float32) - mean.astype(np.float32)) @ comps.T


def _digit_images(rng: np.random.Generator, n: int, n_classes: int = 10,
                  size: int = 16):
    """Per-class stroke templates, shifted by up to 2 px (a roll), scaled
    and noised: ``mnist_like``'s images, the roll vectorised."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / (size - 1)
    templates = []
    for m in range(n_classes):
        trng = np.random.default_rng(1000 + m)
        img = np.zeros((size, size))
        for _ in range(4):
            cx, cy = trng.uniform(0.15, 0.85, 2)
            sx, sy = trng.uniform(0.05, 0.25, 2)
            rot = trng.uniform(0, np.pi)
            dx, dy = xx - cx, yy - cy
            u = np.cos(rot) * dx + np.sin(rot) * dy
            v = -np.sin(rot) * dx + np.cos(rot) * dy
            img += np.exp(-(u ** 2 / (2 * sx ** 2) + v ** 2 / (2 * sy ** 2)))
        templates.append(img / img.max())
    y = rng.integers(0, n_classes, n)
    imgs = np.stack(templates)[y]
    shifts = rng.integers(-2, 3, size=(n, 2))
    ar = np.arange(size)
    rows = (ar[None, :] - shifts[:, :1]) % size
    cols = (ar[None, :] - shifts[:, 1:]) % size
    imgs = imgs[np.arange(n)[:, None, None], rows[:, :, None],
                cols[:, None, :]]
    imgs = imgs * rng.uniform(0.7, 1.3, (n, 1, 1))
    imgs = imgs + rng.normal(0, 0.08, imgs.shape)
    return imgs.astype(np.float32), y


def mnist_like(rng: np.random.Generator, n_train: int, n_test: int):
    """The training split of ``mnist_like(rng, n_train, n_test)``: (x (n,
    24) float32 in [0, 1], labels (n,) int64, 10 classes). The test and
    OOD images are drawn, as the original draws them, and dropped."""
    n_ood = int(n_test * 0.10)
    imgs, y = _digit_images(rng, n_train + n_test + n_ood)
    tr = _pca(imgs[:n_train].reshape(n_train, -1), 24)
    return _minmax(tr), y[:n_train].astype(np.int64), 10


def smd_like(rng: np.random.Generator, n_train: int, n_test: int):
    """The training split of ``smd_like(rng, n_train, n_test)``: (x (n, 38)
    float32 in [0, 1], labels (n,) int64, 28 machines). The test and OOD
    rows are drawn, as the original draws them, and dropped."""
    d, n_classes = 38, 28
    n_ood = int(n_test * 0.04 / (1 - 0.04)) + 1
    n = n_train + n_test + n_ood
    srng = np.random.default_rng(13)
    machine_mu = srng.uniform(0.2, 0.8, (n_classes, d))
    machine_scale = srng.uniform(0.02, 0.12, (n_classes, d))
    y = rng.integers(0, n_classes, n)
    load = rng.beta(2, 5, (n, 1))
    coupling = srng.uniform(0, 0.6, (1, d))
    x = machine_mu[y] + load * coupling + rng.normal(0, 1, (n, d)) * \
        machine_scale[y]
    for _ in range(n_ood):    # the OOD rows' draws, values dropped
        rng.choice(d, rng.integers(3, 9), replace=False)
        if rng.uniform() < 0.5:
            rng.uniform(0.5, 1.2)
    return _minmax(x[:n_train]), y[:n_train].astype(np.int64), n_classes


GENERATORS = {"mnist_like": mnist_like, "smd_like": smd_like}


def pack(per_client: list, n_classes: int, per_client_labels: list,
         pad_to: int | None = None) -> ClientSplit:
    """``_pack``: zero-padded (C, N_max, d) rows, 0/1 mask, sizes and
    per-client class counts; N_max is ``pad_to`` where that holds every
    client (the original's ``pad_to`` is taken as it is)."""
    c = len(per_client)
    d = per_client[0].shape[1]
    sizes = np.array([len(p) for p in per_client], dtype=np.int64)
    n_max = int(max(int(sizes.max()), int(pad_to or 0), 1))
    data = np.zeros((c, n_max, d), dtype=np.float32)
    mask = np.zeros((c, n_max), dtype=np.float32)
    counts = np.zeros((c, n_classes), dtype=np.int64)
    for i, (p, lab) in enumerate(zip(per_client, per_client_labels)):
        data[i, :len(p)] = p
        mask[i, :len(p)] = 1.0
        if len(p):
            counts[i] = np.bincount(lab, minlength=n_classes)
    return ClientSplit(data, mask, sizes, counts)


def partition_dirichlet(rng: np.random.Generator, x: np.ndarray,
                        y: np.ndarray, n_clients: int, alpha: float,
                        min_size: int = 2,
                        shares_rng: np.random.Generator | None = None,
                        pad_to: int | None = None) -> ClientSplit:
    """``partition_dirichlet``: each class's rows, shuffled by ``rng``,
    spread over the clients by Dirichlet(alpha) proportions, redrawn until
    every client holds at least ``min_size`` rows; each client's rows in
    ascending order. The proportions come from ``shares_rng`` where one is
    given (the original draws them from ``rng``); ``pad_to`` as in
    ``pack``."""
    shares_rng = rng if shares_rng is None else shares_rng
    n_classes = int(y.max()) + 1
    while True:
        owner = np.empty(len(y), dtype=np.int64)
        for m in range(n_classes):
            idx = np.flatnonzero(y == m)
            rng.shuffle(idx)
            props = shares_rng.dirichlet(alpha * np.ones(n_clients))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for c, part in enumerate(np.split(idx, cuts)):
                owner[part] = c
        if np.bincount(owner, minlength=n_clients).min() >= min_size:
            break
    sels = [np.flatnonzero(owner == c) for c in range(n_clients)]
    return pack([x[s] for s in sels], n_classes, [y[s] for s in sels],
                pad_to)


def make_split(config: dict, seed: int) -> ClientSplit:
    """The cell's client split. ``--seed`` draws the rows (the
    configuration's generator at its row count) and shuffles each class;
    the clients' Dirichlet(alpha) shares of every class are drawn from the
    configuration's ``partition_seed``. So every seed gives the clients
    the same shares of the rows, while the rows themselves change; every
    client is padded to the configuration's ``pad_rows`` (above the
    largest client any seed draws), so every seed gives one shape."""
    rng = np.random.default_rng(seed)
    x, y, _ = GENERATORS[config["generator"]](rng, config["rows"],
                                              config["test_rows"])
    return partition_dirichlet(
        rng, x, y, config["clients"], config["alpha"],
        shares_rng=np.random.default_rng(config["partition_seed"]),
        pad_to=config["pad_rows"])
