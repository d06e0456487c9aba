"""PCA feature reduction (§5.1: MNIST 784->24, RWHAR 63->16)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PCAModel(NamedTuple):
    mean: np.ndarray        # (d,)
    components: np.ndarray  # (k, d) principal axes (rows)
    explained_variance: np.ndarray  # (k,)


def fit_pca(x: np.ndarray, n_components: int) -> PCAModel:
    x = np.asarray(x, dtype=np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    # economy SVD; rows of vt are principal axes
    _, s, vt = np.linalg.svd(xc, full_matrices=False)
    ev = (s ** 2) / max(len(x) - 1, 1)
    return PCAModel(mean.astype(np.float32),
                    vt[:n_components].astype(np.float32),
                    ev[:n_components].astype(np.float32))


def transform_pca(model: PCAModel, x: np.ndarray) -> np.ndarray:
    return ((np.asarray(x, np.float32) - model.mean) @ model.components.T)
