"""The federation runtime: one round loop under every federated algorithm
of the port (port of ``repro/fed/runtime.py``: the resident split, the
out-of-core source and the mesh-sharded backends).

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
device sync), as the EM loop does (``core/em.py::_em_loop``).

The JAX package shards a mesh axis inside one process (``shard_map``); the
port's :class:`ShardedClients` is SPMD over processes instead: every rank
of a ``torch.distributed`` ``DeviceMesh`` runs the same round loop over its
own block of clients, and a round's reduce is one ``all_reduce``. Every
rank then holds the same state, so the loops stay in step.
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.core.config import (derive_seed, is_source_list,
                                     resolve_device)
from repro_torch.core.em import (_tree_add, _tree_leaves, _tree_map,
                                 wrap_int32)
from repro_torch.data.sources import stage_to_device
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


def _reduce_block(local_step, state, data, mask, lo: int, population: int,
                  cohort, weights, transform, tparams, tkey):
    """The round payload summed over one block of resident clients, the
    global indices ``lo, lo + 1, ...`` of a ``population``: ``local_step``
    on the block's clients (all of them, or the ``cohort`` members it
    owns) as one batch with their global indices, the uplink ``transform``
    per client against the round's members, the straggler ``weights`` (one
    per member, multiplied in each leaf's dtype), and the sum over the
    block.

    A cohort's payloads are scattered into their slots of a zero-filled
    (block, ...) tensor before the sum, so a cohort round adds in the same
    order as the full round with the non-members' payloads zeroed. A block
    that owns no member steps its first client, as a cohort of one, only
    for the payload's structure and scatters nothing (the JAX package's
    shard steps every member on every shard and gates them)."""
    per = data.shape[0]
    members = (np.arange(population) if cohort is None
               else np.asarray(cohort))
    if cohort is None:
        pos = ids = np.arange(lo, lo + per)  # weights come one per client
    else:
        pos = np.flatnonzero((members >= lo) & (members < lo + per))
        ids = members[pos]
    # a block that owns no member steps its first client as a cohort of one
    run, members = ((ids, members) if len(ids) else
                    (np.asarray([lo]), np.asarray([lo])))
    idx = tracing.blocking(lambda: torch.as_tensor(
        run, dtype=torch.int64, device=data.device))
    if cohort is None:
        p = local_step(state, data, mask, idx)
    else:
        loc = idx - lo
        p = local_step(state, data[loc], mask[loc], idx)
    if transform is not None:
        # every client gets the round's shared key; its draws are its own
        p = transform.apply(tkey, tparams, p, run, members)
    if weights is not None and len(ids):
        wt = torch.as_tensor(np.asarray(weights)[pos], device=data.device)
        p = _tree_map(lambda s: s * wt.to(s.dtype).view(
            (-1,) + (1,) * (s.ndim - 1)), p)
    if cohort is not None:
        loc, m = idx[:len(ids)] - lo, len(ids)
        p = _tree_map(lambda s: s.new_zeros((per,) + s.shape[1:])
                      .index_copy_(0, loc, s[:m]), p)
    return _tree_map(_sum_clients, p)


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
        the payloads over clients (:func:`_reduce_block` over one block of
        every client)."""
        return _reduce_block(local_step, state, self.data, self.mask, 0,
                             self.num_clients, cohort, weights, transform,
                             tparams, tkey)


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


def _all_gather_into(out: torch.Tensor, buf: torch.Tensor, group) -> None:
    gather = getattr(dist, "all_gather_single", None)
    if gather is None:  # before all_gather_single took its name
        gather = dist.all_gather_into_tensor
    gather(out, buf, group=group)


class ShardedClients:
    """Clients sharded over the ``axis`` dimension of a ``DeviceMesh``
    (``torch.distributed.device_mesh.init_device_mesh``), one process a
    rank. Every rank is handed the same global ``data (C, N, d)`` and
    ``mask (C, N)`` (numpy arrays or CPU tensors) and moves only its own
    contiguous block of ``C / world`` clients, global indices ``ids``, to
    its device: the current CUDA device on a ``"cuda"`` mesh (which raises
    without CUDA), the CPU on a ``"cpu"`` mesh. ``C`` must divide by the
    world size.

    The host metadata (``num_clients``, ``sizes``, ``dim``) is the whole
    population's, so strategies account and sample as over a split. A
    round's reduce sums the rank's clients in ``SplitClients``' order and
    makes one ``all_reduce`` of the float payload (a second, summed modulo
    2^32, for int32 secure-aggregation leaves); at world size 1 it gives
    ``SplitClients``' bits. ``ShardedClients.collectives`` counts the
    collective calls of every sharded backend in the process (reset it by
    assignment), as the kernels' wrappers count their launches."""

    kind = "sharded"
    split = None
    collectives = 0

    def __init__(self, data, mask, mesh, axis: str = "data"):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.world = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank(axis)
        if mesh.device_type == "cuda":
            resolve_device("cuda")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = resolve_device(mesh.device_type)
        c = data.shape[0]
        if c % self.world != 0:
            raise ValueError(
                f"{c} clients do not divide over the {self.world} ranks of "
                f"mesh axis {axis!r}")
        per = c // self.world
        lo = self.rank * per
        self.ids = np.arange(lo, lo + per)
        self.num_clients = c
        self.sizes = np.asarray(
            torch.as_tensor(mask).sum(dim=1), dtype=np.int64)

        def block(a):
            return torch.as_tensor(a[lo:lo + per]).to(
                device=self.device, dtype=torch.float32)

        self.data, self.mask = block(data), block(mask)

    @property
    def population_clients(self) -> int:
        return self.num_clients

    @property
    def dim(self) -> int:
        return self.data.shape[-1]

    def block_seeds(self, seed: int):
        """The seeds the block's clients draw from as members of a batch of
        every client seeded with ``seed`` (``derive_seed(seed, c)``)."""
        from repro_torch.core.kmeans import MemberSeeds
        return MemberSeeds(derive_seed(seed, int(c)) for c in self.ids)

    def all_reduce(self, tree):
        """The sum over the ranks of a payload (a tensor, tuple, NamedTuple
        or dict of tensors): one ``all_reduce`` a kind of leaf, the float
        leaves of one dtype flattened into one buffer, int32 leaves widened
        to int64 and wrapped back modulo 2^32 (no reliance on how a backend
        overflows)."""
        leaves = _tree_leaves(tree)
        groups: dict = {}
        for pos, leaf in enumerate(leaves):
            key = (leaf.dtype if leaf.dtype.is_floating_point
                   else torch.int64)
            groups.setdefault(key, []).append(pos)
        out = list(leaves)
        for key, members in groups.items():
            buf = torch.cat([leaves[p].reshape(-1).to(key)
                             for p in members])
            dist.all_reduce(buf, group=self.group)
            ShardedClients.collectives += 1
            at = 0
            for p in members:
                leaf = leaves[p]
                v = buf[at:at + leaf.numel()].view(leaf.shape)
                at += leaf.numel()
                out[p] = (wrap_int32(v) if leaf.dtype == torch.int32
                          else v.to(leaf.dtype))
        it = iter(out)
        return _tree_map(lambda _: next(it), tree)

    def all_gather(self, tensors):
        """Each tensor's ``(C, ...)`` stack over the ranks from the rank's
        ``(C / world, ...)`` block: one ``all_gather`` of one buffer packed
        from all of them (one dtype)."""
        m = len(self.ids)
        if len({t.dtype for t in tensors}) != 1:
            raise ValueError("all_gather packs tensors of one dtype")
        cols = [t.reshape(m, -1) for t in tensors]
        buf = torch.cat(cols, dim=1).contiguous()
        out = buf.new_empty((self.world * m, buf.shape[1]))
        _all_gather_into(out, buf, self.group)
        ShardedClients.collectives += 1
        parts = torch.split(out, [c.shape[1] for c in cols], dim=1)
        return tuple(p.reshape((self.num_clients,) + tuple(t.shape[1:]))
                     for p, t in zip(parts, tensors))

    def reduce_clients(self, local_step, state, cohort=None, weights=None,
                       transform=None, tparams=None, tkey=None):
        """``SplitClients.reduce_clients`` over the rank's block
        (:func:`_reduce_block`), then the sum over the ranks
        (:meth:`all_reduce`)."""
        return self.all_reduce(_reduce_block(
            local_step, state, self.data, self.mask, int(self.ids[0]),
            self.num_clients, cohort, weights, transform, tparams, tkey))


def split_to_clients(split, device="cuda") -> SplitClients:
    """A padded split (``data (C, N, d)``, ``mask (C, N)``, ``sizes (C,)``
    numpy arrays, as ``partition`` makes them in either package; or a
    :class:`SplitClients`, whose tensors keep their dtype) as
    :class:`SplitClients` on ``device``, which keeps ``split`` (a
    :class:`SplitClients` its own). Every call copies every byte of
    ``data`` and ``mask``; on a card an array of more than one chunk
    (:data:`~repro_torch.data.sources.UPLOAD_CHUNK` elements) goes through
    the pinned ring of :func:`~repro_torch.data.sources.stage_to_device`.
    Notes ``staged_bytes``, the bytes that went through the ring, on the
    open span."""
    # the mask first: where it takes the plain copy, that copy waits for
    # the stream, which then holds none of the data's copies yet
    mask, staged_mask = stage_to_device(split.mask, device)
    data, staged_data = stage_to_device(split.data, device)
    tracing.note("staged_bytes", staged_data + staged_mask)
    return SplitClients(data, mask, split.sizes,
                        split.split if isinstance(split, SplitClients)
                        else split)


def make_backend(clients, device, mesh=None, axis: str = "data"):
    """THE client dispatch: with a ``mesh``, ``(data, mask)`` arrays or a
    padded split become :class:`ShardedClients` over its ``axis`` (on the
    mesh's device, whatever ``device`` says); a :class:`SplitClients`
    passes through (moved to ``device``), a padded split (any object with
    ``data``/``mask``/``sizes`` arrays, such as
    ``repro_torch.core.partition.ClientSplit``) is copied onto ``device``,
    and a list of per-client DataSources becomes :class:`SourceClients` on
    ``device``. A padded split's copy, and a :class:`SplitClients`' move,
    is the ``fed.upload`` span (:func:`split_to_clients`): every call
    copies every byte, and an array of more than one chunk reaches a card
    through the pinned ring."""
    if mesh is not None:
        if isinstance(clients, ShardedClients):
            return clients
        data, mask = ((clients.data, clients.mask)
                      if hasattr(clients, "data") else clients)
        return ShardedClients(data, mask, mesh, axis)
    if isinstance(clients, SourceClients):
        return SourceClients(clients.sources, device, clients.executor)
    if is_source_list(clients):
        return SourceClients(clients, device)
    if all(hasattr(clients, f) for f in ("data", "mask", "sizes")):
        with tracing.span("fed.upload"):
            moved = split_to_clients(clients, device)
        if moved.data is clients.data and moved.mask is clients.mask:
            return clients
        return moved
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
               state0=None, max_rounds: int = 1, mesh=None,
               axis: str = "data", sampler=None, stragglers=None,
               transform=None, executor=None):
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
    steps on worker threads; resident clients ignore it.

    With a ``mesh`` (a ``DeviceMesh``), ``clients`` are ``(data, mask)``
    arrays or a padded split, sharded over the mesh's ``axis``
    (:class:`ShardedClients`): every rank calls ``run_rounds`` with the same
    arguments, runs its own block, and gets the same result."""
    backend = make_backend(clients, device, mesh, axis)
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
            with tracing.span("fed.round"):
                return _round(strategy, state, backend, cohort, weights,
                              transform, tparams, tkey)

        state = one_round(state0, 0)
        rounds = 1
        while rounds < max_rounds and tracing.blocking(
                bool, _keep_going(strategy, state)):
            state = one_round(state, rounds)
            rounds += 1
        converged = tracing.blocking(bool, strategy.converged(state))
        post = getattr(strategy, "post_rounds", None)
        if post is not None:
            state = post(state, backend)

    ledger_backend = backend if sampler is None \
        else _CohortView(backend, sampler.cohort_size)
    payload = _transform_ledger(
        strategy.round_payload(ledger_backend, state), transform)
    comm: CommStats = payload.totals(rounds)
    return strategy.finalize(state, rounds, converged, comm)
