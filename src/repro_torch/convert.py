"""Carry weights and data across to the port.

The JAX package's models and splits arrive here as numpy arrays
(``np.asarray(jax_gmm.weights)`` etc.), so nothing here imports JAX:
:func:`gmm_from_numpy` builds a port :class:`GMM` on a device,
:func:`gmm_to_numpy` turns one back into arrays, and
:func:`split_to_clients` puts a padded numpy ``ClientSplit`` on a device
as :class:`SplitClients`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gmm import GMM
from repro_torch.fed.runtime import SplitClients


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def gmm_from_numpy(weights, means, covs, device="cuda") -> GMM:
    """A float32 port model on ``device`` from (weights, means, covs)
    arrays, single (K, ...) or stacked (C, K, ...)."""
    return GMM(_tensor(weights, device), _tensor(means, device),
               _tensor(covs, device))


def gmm_to_numpy(gmm: GMM) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(weights, means, covs) of a port model as numpy arrays."""
    return tuple(t.detach().cpu().numpy()
                 for t in (gmm.weights, gmm.means, gmm.covs))


def split_to_clients(split, device="cuda") -> SplitClients:
    """A padded split (``data (C, N, d)``, ``mask (C, N)``, ``sizes (C,)``
    numpy arrays, as ``partition`` makes them in either package) as
    :class:`SplitClients` on ``device``, which keeps ``split``."""
    return SplitClients(_tensor(split.data, device),
                        _tensor(split.mask, device), np.asarray(split.sizes),
                        split)
