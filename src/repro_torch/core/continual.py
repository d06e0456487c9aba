"""Continual one-shot federated GMM learning (port of
``repro/core/continual.py``; beyond the paper, whose conclusion names
continuous federated learning as future work).

Time proceeds in windows. In window t each client trains a local GMM on
its new data and uploads it (one round a window). The server keeps the
previous global model G_{t-1} and aggregates

    G_t = FedGenAggregate( clients_t  U  decay-weighted G_{t-1} )

by treating G_{t-1} as one more "client" whose pseudo dataset size is
``memory / (1 - memory) * N_t``: the synthetic refit set is drawn from a
mixture of the fresh client components and the old global model.
``memory`` in [0, 1) trades plasticity against stability (0 is the paper's
stateless per-window behaviour). No client uploads old data again.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.config import derive_seed, make_generator
from repro_torch.core.em import fit_gmm
from repro_torch.core.fedgen import train_locals
from repro_torch.core.gmm import GMM, merge_gmms


class ContinualState(NamedTuple):
    global_gmm: Optional[GMM]
    window: int
    rounds_total: int


def init_state() -> ContinualState:
    return ContinualState(None, 0, 0)


def continual_round(seed: int, state: ContinualState, data, mask, sizes,
                    k_clients: int, k_global: int, h: int = 100,
                    memory: float = 0.5, max_iter: int = 200,
                    tol: float = 1e-3, device="cuda") -> ContinualState:
    """One window: local training on the fresh data ``data (C, N, d)``,
    ``mask (C, N)`` and one-shot aggregation with the decayed previous
    global model. ``seed`` splits into the local-training, sampling and
    refit streams."""
    stacked = train_locals(derive_seed(seed, "train"), data, mask, k_clients,
                           max_iter=max_iter, tol=tol, device=device)
    gmms = [stacked.gmm[i] for i in range(stacked.gmm.weights.shape[0])]
    weights = [float(s) for s in sizes]
    n_fresh = sum(weights)
    if state.global_gmm is not None and memory > 0.0:
        gmms.append(state.global_gmm.to(gmms[0].device))
        weights.append(memory / max(1.0 - memory, 1e-6) * n_fresh)
    merged = merge_gmms(gmms, torch.tensor(weights, dtype=torch.float32))
    n_synth = h * sum(g.n_components for g in gmms)
    synth = merged.sample(
        make_generator(derive_seed(seed, "sample"), merged.device), n_synth)
    res = fit_gmm(derive_seed(seed, "fit"), synth, k_global,
                  max_iter=max_iter, tol=tol, device=device)
    return ContinualState(res.gmm, state.window + 1, state.rounds_total + 1)
