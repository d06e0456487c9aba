"""Feature preprocessing: min-max normalization to [0,1] (§5.1)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MinMaxScaler(NamedTuple):
    lo: np.ndarray
    hi: np.ndarray

    def transform(self, x: np.ndarray) -> np.ndarray:
        span = np.maximum(self.hi - self.lo, 1e-9)
        return np.clip((np.asarray(x, np.float32) - self.lo) / span, 0.0, 1.0)


def fit_minmax(x: np.ndarray) -> MinMaxScaler:
    x = np.asarray(x, np.float32)
    return MinMaxScaler(x.min(axis=0), x.max(axis=0))
