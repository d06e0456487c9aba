"""The federation runtime, one-shot slice (port of the ``one_shot`` branch
of ``repro/fed/runtime.py::run_rounds`` and of ``SplitClients``).

A strategy with ``one_shot = True`` implements ``init_state(seed,
backend)``, ``run_once(state, backend)``, ``round_payload(backend,
state)`` and ``finalize(state, n_rounds, converged, comm)``; the runtime
owns the client dispatch and the ledger. Iterative strategies, cohort
sampling, stragglers, uplink transforms and executors come with later
slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed.ledger import CommStats


class SplitClients:
    """Resident padded clients on one device: ``data (C, N, d)``,
    ``mask (C, N)`` and the true sizes |D_c| (host integers)."""

    kind = "split"

    def __init__(self, data: torch.Tensor, mask: torch.Tensor, sizes):
        self.data = data
        self.mask = mask
        self.sizes = np.asarray(sizes, dtype=np.int64)

    @property
    def num_clients(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_backend(clients, device) -> SplitClients:
    """THE client dispatch: a :class:`SplitClients` passes through (moved to
    ``device``), a padded split (any object with ``data``/``mask``/``sizes``
    arrays, such as ``repro_torch.core.partition.ClientSplit``) is copied
    onto ``device``."""
    if isinstance(clients, SplitClients):
        if clients.device == torch.device(device):
            return clients
        return SplitClients(clients.data.to(device), clients.mask.to(device),
                            clients.sizes)
    if all(hasattr(clients, f) for f in ("data", "mask", "sizes")):
        from repro_torch.convert import split_to_clients
        return split_to_clients(clients, device)
    raise TypeError(f"federated clients must be a ClientSplit or "
                    f"SplitClients, got {type(clients).__name__}")


def run_rounds(strategy, clients, *, seed: int = 0, device="cuda"):
    """Run a one-shot :class:`FederationStrategy`: one round, then the
    ledger (the strategy's :class:`RoundPayload` times one round)."""
    if not getattr(strategy, "one_shot", False):
        raise NotImplementedError(
            "this slice of the port runs one-shot strategies only")
    backend = make_backend(clients, device)
    state = strategy.run_once(strategy.init_state(seed, backend), backend)
    comm: CommStats = strategy.round_payload(backend, state).totals(1)
    return strategy.finalize(state, 1, True, comm)
