"""The federation runtime: one round loop under every federated algorithm
of the port (port of ``repro/fed/runtime.py``: the resident split and the
out-of-core source backends).

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
  with a leading axis m, the port's stand-in for ``jax.vmap``; on source
  clients ``x`` is one client's :class:`DataSource`, ``w`` None and ``idx``
  its index, and the payload has no client axis),
  ``server_combine(state, total)``, ``converged(state)``, optionally
  ``keep_going(state)`` and ``post_rounds(state, backend)``, and the same
  ``round_payload`` / ``finalize``.

An uplink transform (``repro_torch.fed.transforms``) is applied to every
client's payload between ``local_step`` and the reduce, with the round's
shared :class:`~repro_torch.fed.transforms.UplinkKey`; its ``finish`` runs
on the summed total before ``server_combine``. Payloads may then hold
dicts and int32 leaves (the secure-aggregation channel), which the reduces
sum modulo 2^32.

The JAX package runs resident round loops as one jitted ``while_loop``.
Here the loop runs on the host: one bootstrap round, then rounds while the
strategy's ``keep_going`` holds, reading that one flag per round (one
device sync), as the EM loop does (``core/em.py::_em_loop``). The JAX
package's mesh backend (``ShardedClients``) is not ported.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.config import is_source_list
from repro_torch.core.em import _tree_add, _tree_map, wrap_int32
from repro_torch.fed.ledger import CommStats
from repro_torch.fed.transforms import uplink_key


@runtime_checkable
class FederationStrategy(Protocol):
    """The strategy contract (duck-typed; frozen dataclasses are the
    idiom). See the module docstring for the methods each kind adds."""

    one_shot: bool

    def init_state(self, seed: int, backend) -> Any: ...

    def round_payload(self, backend, state): ...

    def finalize(self, state, n_rounds, converged, comm: CommStats): ...


def _sum_clients(s: torch.Tensor) -> torch.Tensor:
    """The sum of a stacked payload leaf over its client axis: float leaves
    as ``torch.sum``, int32 leaves modulo 2^32 (``torch.sum`` would promote
    them to int64 and never wrap)."""
    if s.dtype == torch.int32:
        return wrap_int32(torch.sum(s, dim=0, dtype=torch.int64))
    return torch.sum(s, dim=0)


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

    def reduce_clients(self, local_step, state, cohort=None, weights=None,
                       transform=None, tparams=None, tkey=None):
        """Run ``local_step`` on all clients, or on the ``cohort`` (sorted
        global indices) only, as one batch; apply the uplink ``transform``
        (if any) to every client's payload; zero the dropped clients by
        ``weights`` (per member, multiplied in each leaf's dtype); and sum
        the payloads over clients.

        A cohort's m payloads are scattered into their population slots of
        a zero-filled (C, ...) tensor before the sum over C, so a cohort
        round adds in the same order as the full-population round with the
        non-members' payloads zeroed."""
        c = self.num_clients
        ids = np.arange(c) if cohort is None else np.asarray(cohort)
        if cohort is None:
            idx = torch.arange(c, device=self.device)
            per = local_step(state, self.data, self.mask, idx)
        else:
            idx = torch.as_tensor(ids, dtype=torch.int64,
                                  device=self.device)
            per = local_step(state, self.data[idx], self.mask[idx], idx)
        if transform is not None:
            # every client gets the round's shared key; its draws are its own
            per = transform.apply(tkey, tparams, per, ids, ids)
        if weights is not None:
            wt = torch.as_tensor(np.asarray(weights), device=self.device)
            per = _tree_map(lambda s: s * wt.to(s.dtype).view(
                (-1,) + (1,) * (s.ndim - 1)), per)
        if cohort is not None:
            per = _tree_map(lambda s: s.new_zeros((c,) + s.shape[1:])
                            .index_copy_(0, idx, s), per)
        return _tree_map(_sum_clients, per)


class SourceClients:
    """Out-of-core clients: one :class:`DataSource` stream each, run on
    ``device``. A round is a host loop over the (cohort) clients, each
    streaming its own blocks through the engine; the payloads are summed in
    cohort order, so the sum does not depend on how the clients were
    scheduled.

    ``executor`` (a :class:`repro_torch.fed.async_runtime.ClientExecutor`,
    or anything with ``map_ordered(fn, items) -> list``) runs the clients'
    steps on its worker threads, so one client's host work (block reads,
    padding, launches) can overlap another's device work. Workers launch on
    the calling thread's current stream, so every client's kernels are
    ordered before the reduce that the calling thread enqueues after
    collecting them; the payloads are still summed in cohort order, so the
    result has the serial loop's bits."""

    kind = "sources"

    def __init__(self, sources, device, executor=None):
        self.sources = list(sources)
        self.device = torch.device(device)
        self.executor = executor

    @property
    def num_clients(self) -> int:
        return len(self.sources)

    @property
    def population_clients(self) -> int:
        return self.num_clients

    @property
    def dim(self) -> int:
        return self.sources[0].dim

    @property
    def sizes(self) -> np.ndarray:
        return np.asarray([s.num_rows for s in self.sources], np.int64)

    def reduce_clients(self, local_step, state, cohort=None, weights=None,
                       transform=None, tparams=None, tkey=None):
        """Run ``local_step(state, source, None, i)`` and the uplink
        ``transform`` (if any) for every client, or for the ``cohort``
        (sorted global indices) only, skipping the clients ``weights``
        drops (0) and scaling the others by their weight; sum the payloads
        in cohort order."""
        ids = (np.arange(self.num_clients) if cohort is None
               else np.asarray(cohort))
        w = None if weights is None else np.asarray(weights)
        # a dropped client's step never runs, serially or on the executor
        jobs = [(pos, int(i)) for pos, i in enumerate(ids)
                if w is None or w[pos] != 0.0]

        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)

        def run(i):
            with torch.cuda.stream(stream):
                p = local_step(state, self.sources[i], None, i)
                if transform is None:
                    return p
                return transform.apply(tkey, tparams, p, i, ids)

        if self.executor is not None and len(jobs) > 1:
            raw = self.executor.map_ordered(run, [i for _, i in jobs])
        else:
            raw = [run(i) for _, i in jobs]
        total = None
        for (pos, _), p in zip(jobs, raw):
            if w is not None and w[pos] != 1.0:
                p = _tree_map(lambda s: s * (float(w[pos])
                                             if s.dtype.is_floating_point
                                             else int(w[pos])), p)
            total = p if total is None else _tree_add(total, p)
        if total is None:
            raise ValueError("every client of the round was dropped")
        return total


def make_backend(clients, device):
    """THE client dispatch: a :class:`SplitClients` passes through (moved to
    ``device``), a padded split (any object with ``data``/``mask``/``sizes``
    arrays, such as ``repro_torch.core.partition.ClientSplit``) is copied
    onto ``device``, and a list of per-client DataSources becomes
    :class:`SourceClients` on ``device``."""
    if isinstance(clients, SourceClients):
        return SourceClients(clients.sources, device, clients.executor)
    if is_source_list(clients):
        return SourceClients(clients, device)
    if isinstance(clients, SplitClients):
        data, mask = clients.data.to(device), clients.mask.to(device)
        if data is clients.data and mask is clients.mask:
            return clients
        return SplitClients(data, mask, clients.sizes, clients.split)
    if all(hasattr(clients, f) for f in ("data", "mask", "sizes")):
        from repro_torch.convert import split_to_clients
        return split_to_clients(clients, device)
    raise TypeError(f"federated clients must be a ClientSplit, "
                    f"SplitClients or a non-empty list of DataSources, got "
                    f"{type(clients).__name__}")


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


def _round(strategy, state, backend, cohort=None, weights=None,
           transform=None, tparams=None, tkey=None):
    """One round: client updates -> (transformed) uplink -> reduce ->
    transform ``finish`` -> server combine."""
    total = backend.reduce_clients(strategy.local_step, state, cohort,
                                   weights, transform, tparams, tkey)
    if transform is not None:
        total = transform.finish(total)
    return strategy.server_combine(state, total)


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


_TRANSFORM_METHODS = ("apply", "finish", "traced", "wire_itemsize",
                      "epsilon_per_round")


def _validate_transform(transform):
    """Duck-type and hashability check of an uplink transform (frozen
    dataclasses are the contract, as in the JAX package, where a transform
    is a static jit argument)."""
    missing = [m for m in _TRANSFORM_METHODS
               if not callable(getattr(transform, m, None))]
    if missing:
        raise TypeError(
            f"transform {type(transform).__name__} is missing "
            f"{missing}; see repro_torch.fed.transforms.PayloadTransform")
    try:
        hash(transform)
    except TypeError as e:
        raise TypeError(
            f"transform {type(transform).__name__} must be hashable "
            f"(a frozen dataclass)") from e


def _transform_ledger(payload, transform):
    """The transform-aware ledger: the uplink carries the transform's wire
    dtype, and each realized round spends its epsilon."""
    if transform is None:
        return payload
    return payload._replace(
        uplink_itemsize=transform.wire_itemsize(payload.itemsize),
        epsilon_per_round=float(transform.epsilon_per_round()))


def run_rounds(strategy, clients, *, seed: int = 0, device="cuda",
               state0=None, max_rounds: int = 1, sampler=None,
               stragglers=None, transform=None, executor=None):
    """Run a federation strategy to convergence: THE round loop.

    One-shot strategies run one round. Iterative ones run a bootstrap
    round, then rounds while ``keep_going`` holds and fewer than
    ``max_rounds`` have run. ``state0`` replaces the strategy's own
    ``init_state(seed, backend)``. ``sampler`` (``repro_torch.fed.cohort``)
    makes each round compute only its sampled cohort and sizes the
    per-round ledger to it; ``stragglers`` drops each round's slowest
    arrivals to an exact-zero contribution. After the loop, the strategy's
    ``post_rounds`` (if any) runs once, then the ledger is drawn up: the
    strategy's :class:`RoundPayload` times the realized rounds.

    ``transform`` (``repro_torch.fed.transforms``) is applied to every
    client's uplink; the ledger then carries its wire dtype and
    ``epsilon_spent``. An additive-only transform (pairwise masks) is
    refused for a one-shot strategy, whose server reads each client's
    payload. ``executor`` (a ``ClientExecutor``) runs source clients'
    steps on worker threads; resident clients ignore it."""
    backend = make_backend(clients, device)
    if executor is not None and backend.kind == "sources":
        backend.executor = executor
    one_shot = getattr(strategy, "one_shot", False)
    if one_shot and (sampler is not None or stragglers is not None):
        raise ValueError(
            "cohort sampling and straggler handling need a round "
            "structure; one-shot strategies take neither")
    if sampler is not None and sampler.num_clients != backend.num_clients:
        raise ValueError(
            f"sampler is sized for {sampler.num_clients} clients but the "
            f"backend has {backend.num_clients}")
    tparams = None
    if transform is not None:
        _validate_transform(transform)
        if one_shot and getattr(transform, "additive_only", False):
            raise ValueError(
                f"{type(transform).__name__} masks only cancel in an "
                f"additive aggregate; a one-shot strategy's server reads "
                f"each client payload individually, so the combination "
                f"is meaningless")
        tparams = transform.traced()
    if state0 is None:
        state0 = strategy.init_state(seed, backend)

    if one_shot:
        if transform is None:
            state = strategy.run_once(state0, backend)
        else:
            state = strategy.run_once(state0, backend, transform=transform,
                                      tparams=tparams,
                                      tkey=uplink_key(transform, 0))
        rounds, converged = 1, True
    else:
        def one_round(state, rnd):
            cohort, weights = _cohort_and_weights(sampler, stragglers,
                                                  backend, rnd)
            tkey = None if transform is None else uplink_key(transform, rnd)
            return _round(strategy, state, backend, cohort, weights,
                          transform, tparams, tkey)

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
    payload = _transform_ledger(
        strategy.round_payload(ledger_backend, state), transform)
    comm: CommStats = payload.totals(rounds)
    return strategy.finalize(state, rounds, converged, comm)
