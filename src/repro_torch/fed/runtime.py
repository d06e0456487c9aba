"""The federation runtime: one round loop under every federated algorithm
of the port (port of ``repro/fed/runtime.py``, resident split backend).

FedGenGMM, DEM, FedEM and FedKMeans all decompose into the same round::

    client-update  ->  uplink  ->  server-combine  ->  broadcast

A strategy supplies the algorithm and :func:`run_rounds` owns the client
dispatch, the round loop, cohort sampling, straggler drops and the
communication ledger.

- One-shot strategies (``one_shot = True``) implement ``init_state(seed,
  backend)``, ``run_once(state, backend)``, ``round_payload(backend,
  state)`` and ``finalize(state, n_rounds, converged, comm)``.
- Iterative strategies implement ``init_state``, ``local_step(state, x, w,
  idx)`` (the update of a *batch* of clients: rows ``x (m, N, d)``, masks
  ``w (m, N)``, global indices ``idx (m,)`` -> an additive payload tuple
  with a leading axis m, the port's stand-in for ``jax.vmap``),
  ``server_combine(state, total)``, ``converged(state)``, optionally
  ``keep_going(state)`` and ``post_rounds(state, backend)``, and the same
  ``round_payload`` / ``finalize``.

The JAX package runs resident round loops as one jitted ``while_loop``.
Here the loop runs on the host: one bootstrap round, then rounds while the
strategy's ``keep_going`` holds, reading that one flag per round (one
device sync), as the EM loop does (``core/em.py::_em_loop``). Sources,
meshes, uplink transforms and executors come with later slices.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.fed.ledger import CommStats


@runtime_checkable
class FederationStrategy(Protocol):
    """The strategy contract (duck-typed; frozen dataclasses are the
    idiom). See the module docstring for the methods each kind adds."""

    one_shot: bool

    def init_state(self, seed: int, backend) -> Any: ...

    def round_payload(self, backend, state): ...

    def finalize(self, state, n_rounds, converged, comm: CommStats): ...


def _tree_map(fn, tree):
    """``fn`` over every tensor of a payload (a tensor or a (named) tuple
    of tensors)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    vals = [fn(t) for t in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


class SplitClients:
    """Resident padded clients on one device: ``data (C, N, d)``,
    ``mask (C, N)``, the true sizes |D_c| (host integers), and the
    ``ClientSplit`` they came from where there is one (the pilot init
    uploads raw rows from it)."""

    kind = "split"

    def __init__(self, data: torch.Tensor, mask: torch.Tensor, sizes,
                 split=None):
        self.data = data
        self.mask = mask
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.split = split

    @property
    def num_clients(self) -> int:
        return self.data.shape[0]

    @property
    def population_clients(self) -> int:
        return self.num_clients

    @property
    def dim(self) -> int:
        return self.data.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def reduce_clients(self, local_step, state, cohort=None, weights=None):
        """Run ``local_step`` on all clients, or on the ``cohort`` (sorted
        global indices) only, as one batch; zero the dropped clients by
        ``weights`` (0/1 per member); and sum the payloads over clients.

        A cohort's m payloads are scattered into their population slots of
        a zero-filled (C, ...) tensor before the sum over C, so a cohort
        round adds in the same order as the full-population round with the
        non-members' payloads zeroed."""
        c = self.num_clients
        if cohort is None:
            idx = torch.arange(c, device=self.device)
            per = local_step(state, self.data, self.mask, idx)
        else:
            idx = torch.as_tensor(np.asarray(cohort), dtype=torch.int64,
                                  device=self.device)
            per = local_step(state, self.data[idx], self.mask[idx], idx)
        if weights is not None:
            wt = torch.as_tensor(np.asarray(weights), device=self.device)
            per = _tree_map(lambda s: s * wt.to(s.dtype).view(
                (-1,) + (1,) * (s.ndim - 1)), per)
        if cohort is not None:
            per = _tree_map(lambda s: s.new_zeros((c,) + s.shape[1:])
                            .index_copy_(0, idx, s), per)
        return _tree_map(lambda s: torch.sum(s, dim=0), per)


def make_backend(clients, device) -> SplitClients:
    """THE client dispatch: a :class:`SplitClients` passes through (moved to
    ``device``), a padded split (any object with ``data``/``mask``/``sizes``
    arrays, such as ``repro_torch.core.partition.ClientSplit``) is copied
    onto ``device``."""
    if isinstance(clients, SplitClients):
        data, mask = clients.data.to(device), clients.mask.to(device)
        if data is clients.data and mask is clients.mask:
            return clients
        return SplitClients(data, mask, clients.sizes, clients.split)
    if all(hasattr(clients, f) for f in ("data", "mask", "sizes")):
        from repro_torch.convert import split_to_clients
        return split_to_clients(clients, device)
    raise TypeError(f"federated clients must be a ClientSplit or "
                    f"SplitClients, got {type(clients).__name__}")


# ----------------------------------------------------------------------
# The round loop
# ----------------------------------------------------------------------

def _keep_going(strategy, state):
    """The strategy's own ``keep_going`` where it has one (EM-style
    ``delta > tol``, false on a NaN delta), else ``not converged``."""
    kg = getattr(strategy, "keep_going", None)
    if kg is not None:
        return kg(state)
    return not strategy.converged(state)


def _cohort_and_weights(sampler, stragglers, backend, rnd: int):
    """Round ``rnd``'s cohort (None = every client) and straggler weights
    (None = everyone on time), from the round loop's policies."""
    cohort = None if sampler is None else sampler.cohort(rnd)
    weights = None
    if stragglers is not None:
        members = cohort if cohort is not None \
            else np.arange(backend.num_clients)
        weights = stragglers.drop_mask(rnd, members)
    return cohort, weights


class _CohortView:
    """Accounting view handed to ``round_payload`` under a sampler:
    ``num_clients`` is the cohort size m (what a round moves),
    ``population_clients`` the population C (what once-per-run init
    traffic touches)."""

    def __init__(self, backend, cohort_size: int):
        self._backend = backend
        self.num_clients = int(cohort_size)
        self.population_clients = backend.num_clients
        self.kind = backend.kind

    @property
    def dim(self) -> int:
        return self._backend.dim


def run_rounds(strategy, clients, *, seed: int = 0, device="cuda",
               state0=None, max_rounds: int = 1, sampler=None,
               stragglers=None):
    """Run a federation strategy to convergence: THE round loop.

    One-shot strategies run one round. Iterative ones run a bootstrap
    round, then rounds while ``keep_going`` holds and fewer than
    ``max_rounds`` have run. ``state0`` replaces the strategy's own
    ``init_state(seed, backend)``. ``sampler`` (``repro_torch.fed.cohort``)
    makes each round compute only its sampled cohort and sizes the
    per-round ledger to it; ``stragglers`` drops each round's slowest
    arrivals to an exact-zero contribution. After the loop, the strategy's
    ``post_rounds`` (if any) runs once, then the ledger is drawn up: the
    strategy's :class:`RoundPayload` times the realized rounds."""
    backend = make_backend(clients, device)
    one_shot = getattr(strategy, "one_shot", False)
    if one_shot and (sampler is not None or stragglers is not None):
        raise ValueError(
            "cohort sampling and straggler handling need a round "
            "structure; one-shot strategies take neither")
    if sampler is not None and sampler.num_clients != backend.num_clients:
        raise ValueError(
            f"sampler is sized for {sampler.num_clients} clients but the "
            f"backend has {backend.num_clients}")
    if state0 is None:
        state0 = strategy.init_state(seed, backend)

    if one_shot:
        state = strategy.run_once(state0, backend)
        rounds, converged = 1, True
    else:
        def one_round(state, rnd):
            cohort, weights = _cohort_and_weights(sampler, stragglers,
                                                  backend, rnd)
            total = backend.reduce_clients(strategy.local_step, state,
                                           cohort, weights)
            return strategy.server_combine(state, total)

        state = one_round(state0, 0)
        rounds = 1
        while rounds < max_rounds and bool(_keep_going(strategy, state)):
            state = one_round(state, rounds)
            rounds += 1
        converged = bool(strategy.converged(state))
        post = getattr(strategy, "post_rounds", None)
        if post is not None:
            state = post(state, backend)

    ledger_backend = backend if sampler is None \
        else _CohortView(backend, sampler.cohort_size)
    comm: CommStats = strategy.round_payload(ledger_backend,
                                             state).totals(rounds)
    return strategy.finalize(state, rounds, converged, comm)
