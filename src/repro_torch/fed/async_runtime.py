"""Asynchronous federation: buffered staleness-weighted rounds and the
concurrent source-client executor (port of ``repro/fed/async_runtime.py``).

- :class:`ClientExecutor`: a pool of long-lived worker threads that the
  ``SourceClients`` backend fans per-client steps out to, so one client's
  host work (block reads, padding, launches) can overlap another's device
  work. The backend still sums the payloads in cohort order, so the result
  has the serial loop's bits.
- :func:`run_async`: buffered asynchronous rounds. Clients train against
  the server model current at their dispatch; the server combines as soon
  as ``buffer_size`` updates have arrived, and with ``lookahead > 0`` more
  clients are in flight than one combine consumes, so updates arrive for a
  model ``s`` versions newer than the one they trained against. Each
  update is weighted by the staleness rule
  (:class:`repro_torch.fed.cohort.PolynomialStaleness`), the M-step
  renormalizes by the surviving weighted ``wsum``, and the per-update
  staleness lands in the ledger (``CommStats.staleness``).

Arrival order is dispatch order, not completion order: a combine consumes
the oldest in-flight updates. So every seeded run is reproducible, and
``buffer_size = cohort size, lookahead = 0`` reproduces the synchronous
loop: every combine is one whole fresh cohort, all dispatched at the
current version (weight exactly 1.0), through the same reduce -> finish ->
combine calls as :func:`repro_torch.fed.runtime.run_rounds`. The JAX
package jits three pieces of a combine and pads groups to one static
width; here a group's members go to ``reduce_clients`` as they are.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.em import _tree_add
from repro_torch.fed.cohort import PolynomialStaleness
from repro_torch.fed.runtime import (_CohortView, _cohort_and_weights,
                                     _keep_going, _round, _transform_ledger,
                                     _validate_transform, make_backend,
                                     run_rounds)
from repro_torch.fed.transforms import uplink_key


class ClientExecutor:
    """A pool of long-lived client workers for the source backend (a
    ``ThreadPoolExecutor``: threads live as long as the pool, work items
    queue). Build it once and pass it to any number of ``run_rounds`` /
    ``run_async`` calls; use it as a context manager to shut it down.

    :meth:`map_ordered` returns results in submission order whatever the
    completion order, which is what the backend's cohort-order sum relies
    on. It is opt-in (``executor=None``, the serial loop, is the default):
    workers share the interpreter lock, so small client steps run slower
    on it; PERF.md records the workloads it has been timed on."""

    def __init__(self, max_workers: int):
        if int(max_workers) < 1:
            raise ValueError(
                f"max_workers must be >= 1, got {max_workers}")
        self.max_workers = int(max_workers)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="fed-client")

    def map_ordered(self, fn: Callable[[Any], Any],
                    items: Sequence[Any]) -> list:
        """``fn`` over ``items`` on the workers, results in item order."""
        futures = [self._pool.submit(fn, item) for item in items]
        return [f.result() for f in futures]

    def shutdown(self) -> None:
        """Stop the workers (waits for in-flight client steps)."""
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


@dataclasses.dataclass(frozen=True)
class AsyncPolicy:
    """The async knob of DEM / FedEM and ``fit_federated``: one frozen
    bundle of :func:`run_async`'s keywords. ``buffer_size`` updates a
    combine (None: the cohort size, the sync-equivalent default),
    ``lookahead`` extra in-flight dispatches (``k·buffer_size`` sustains
    staleness about k), ``staleness_alpha`` the exponent of
    :class:`~repro_torch.fed.cohort.PolynomialStaleness`, and
    ``max_workers`` (> 0 builds a :class:`ClientExecutor` for source
    clients; resident clients ignore it)."""

    buffer_size: Optional[int] = None
    lookahead: int = 0
    staleness_alpha: float = 0.5
    max_workers: int = 0

    def __post_init__(self):
        if self.buffer_size is not None and int(self.buffer_size) < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}")
        if int(self.lookahead) < 0:
            raise ValueError(
                f"lookahead must be >= 0, got {self.lookahead}")
        if not float(self.staleness_alpha) >= 0.0:
            raise ValueError(
                f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        if int(self.max_workers) < 0:
            raise ValueError(
                f"max_workers must be >= 0, got {self.max_workers}")

    def driver_kwargs(self) -> dict:
        """The :func:`run_async` keyword arguments of this policy."""
        return dict(buffer_size=self.buffer_size,
                    lookahead=int(self.lookahead),
                    staleness=PolynomialStaleness(
                        float(self.staleness_alpha)),
                    max_workers=int(self.max_workers))


def _resolve_staleness(staleness):
    """A rule object (``.weight(s)``), a bare alpha, or None (the default
    polynomial damping)."""
    if staleness is None:
        return PolynomialStaleness()
    if isinstance(staleness, (int, float)):
        return PolynomialStaleness(float(staleness))
    if not callable(getattr(staleness, "weight", None)):
        raise TypeError(
            f"staleness must be an alpha or a rule with .weight(s), got "
            f"{type(staleness).__name__}")
    return staleness


# One in-flight update: which client, against which model version, at what
# straggler weight, from which dispatch round (its transform and straggler
# round), and whether its dispatch batch carried no weights at all (so a
# zero-staleness reduce passes weights=None, as the synchronous loop does).
_Update = collections.namedtuple(
    "_Update", ("client", "version", "weight", "rnd", "unweighted"))


def run_async(strategy, clients, *, seed: int = 0, device="cuda",
              state0=None, max_rounds: int = 1, mesh=None,
              axis: str = "data", sampler=None, stragglers=None,
              transform=None,
              buffer_size: Optional[int] = None, lookahead: int = 0,
              staleness=None, executor=None, max_workers: int = 0,
              progress=None):
    """Buffered asynchronous rounds, the staggered counterpart of
    :func:`~repro_torch.fed.runtime.run_rounds`.

    Assignments stream from the sampler's cohorts (the whole population a
    batch without one); up to ``buffer_size + lookahead`` clients are in
    flight, each pinned to the model version current at its dispatch. A
    combine consumes the ``buffer_size`` oldest updates, weights each by
    ``rule.weight(version - dispatch version)`` times its straggler weight,
    sums them group by group against the stale model each group trained
    on, and M-steps against the current model. ``max_rounds`` bounds the
    combines. Convergence, ``post_rounds``, the sampler, straggler and
    transform seams and the ledger behave as in ``run_rounds``; updates
    still in flight when the loop stops are never consumed or counted.

    ``staleness`` is a rule with ``.weight(s)``, an alpha, or None.
    ``executor`` / ``max_workers`` put a :class:`ClientExecutor` on a
    source backend. ``progress(version, state, staleness_tuple)`` is called
    after every combine. Additive-only transforms (pairwise masks) need the
    whole cohort in one aggregate, so they are accepted only in the
    sync-equivalent configuration. ``mesh`` and ``axis`` shard the clients
    over a ``DeviceMesh`` as in ``run_rounds``: every rank drives the same
    schedule, and each group's reduce is one all-reduce."""
    backend = make_backend(clients, device, mesh, axis)
    if getattr(strategy, "one_shot", False):
        raise ValueError(
            "run_async needs a round structure; one-shot strategies "
            "have nothing to buffer — use run_rounds")
    rule = _resolve_staleness(staleness)
    population = backend.num_clients
    batch_m = population if sampler is None else int(sampler.cohort_size)
    buffer = batch_m if buffer_size is None else int(buffer_size)
    if not 1 <= buffer <= population:
        raise ValueError(
            f"buffer_size must be in [1, population={population}], got "
            f"{buffer}")
    lookahead = int(lookahead)
    if lookahead < 0:
        raise ValueError(f"lookahead must be >= 0, got {lookahead}")
    sync_equivalent = buffer == batch_m and lookahead == 0

    tparams = None
    if transform is not None:
        _validate_transform(transform)
        if getattr(transform, "additive_only", False) and not sync_equivalent:
            raise ValueError(
                f"{type(transform).__name__} masks only cancel when one "
                f"aggregate sums the whole cohort; buffered async rounds "
                f"(buffer_size != cohort_size or lookahead > 0) split "
                f"cohorts across combines")
        tparams = transform.traced()
    if sampler is not None and sampler.num_clients != population:
        raise ValueError(
            f"sampler is sized for {sampler.num_clients} clients but "
            f"the backend has {population}")

    own_executor = None
    if backend.kind == "sources":
        if executor is None and int(max_workers) > 0:
            executor = own_executor = ClientExecutor(int(max_workers))
        if executor is not None:
            backend.executor = executor

    try:
        if state0 is None:
            state0 = strategy.init_state(seed, backend)
        return _drive(strategy, backend, state0, int(max_rounds), sampler,
                      stragglers, transform, tparams, buffer, lookahead,
                      rule, progress)
    finally:
        if own_executor is not None:
            own_executor.shutdown()


def run_policy(strategy, clients, async_policy=None, **kw):
    """``run_rounds(strategy, clients, **kw)``, or ``run_async`` with the
    ``async_policy``'s knobs added when one is given: the one dispatch the
    cfg cores and ``fit_federated`` share."""
    if async_policy is None:
        return run_rounds(strategy, clients, **kw)
    return run_async(strategy, clients, **kw, **async_policy.driver_kwargs())


def _group_consumed(consumed):
    """Contiguous (version, dispatch round) groups of one buffer: a group
    shares the model it trained against and its round's key."""
    groups = []
    for u in consumed:
        if groups and (groups[-1][0], groups[-1][1]) == (u.version, u.rnd):
            groups[-1][2].append(u)
        else:
            groups.append([u.version, u.rnd, [u]])
    return groups


def _drive(strategy, backend, state0, max_rounds, sampler, stragglers,
           transform, tparams, buffer, lookahead, rule, progress):
    """The event loop behind :func:`run_async`: top up the in-flight
    window, consume the oldest ``buffer`` updates, combine, repeat."""
    population = backend.num_clients
    fifo: collections.deque = collections.deque()
    states = {0: state0}          # models of the versions still in flight
    state = state0
    version = 0                   # server combines so far
    dispatch_rnd = 0              # assignment batches drawn so far
    staleness_counter: collections.Counter = collections.Counter()

    def top_up():
        """Fill the in-flight window with dispatches against the current
        model version."""
        nonlocal dispatch_rnd
        while len(fifo) < buffer + lookahead:
            cohort, weights = _cohort_and_weights(sampler, stragglers,
                                                  backend, dispatch_rnd)
            members = (np.arange(population) if cohort is None
                       else np.asarray(cohort))
            w = None if weights is None else np.asarray(weights)
            for pos, i in enumerate(members):
                fifo.append(_Update(int(i), version,
                                    1.0 if w is None else float(w[pos]),
                                    dispatch_rnd, w is None))
            dispatch_rnd += 1

    def group_args(rnd, updates, stale_w):
        """(cohort, weights, key) of one group's reduce; a whole
        population batch without a sampler is ``cohort=None``, as the
        synchronous loop spells it."""
        members = np.asarray([u.client for u in updates], np.int64)
        unweighted = all(u.unweighted for u in updates) and stale_w == 1.0
        weights = None if unweighted else np.asarray(
            [u.weight * stale_w for u in updates], np.float32)
        full_pop = sampler is None and len(members) == population
        tkey = None if transform is None else uplink_key(transform, rnd)
        return (None if full_pop else members), weights, tkey

    while True:
        top_up()
        consumed = [fifo.popleft() for _ in range(buffer)]
        groups = _group_consumed(consumed)
        for v, _, updates in groups:
            for u in updates:
                if u.weight != 0.0:
                    staleness_counter[version - v] += 1
        if len(groups) == 1 and groups[0][0] == version:
            # one fresh group: the synchronous loop's round, call for call
            _, rnd, updates = groups[0]
            cohort, weights, tkey = group_args(rnd, updates, 1.0)
            state = _round(strategy, state, backend, cohort, weights,
                           transform, tparams, tkey)
        else:
            total = None
            for v, rnd, updates in groups:
                cohort, weights, tkey = group_args(
                    rnd, updates, rule.weight(version - v))
                g = backend.reduce_clients(strategy.local_step, states[v],
                                           cohort, weights, transform,
                                           tparams, tkey)
                total = g if total is None else _tree_add(total, g)
            if transform is not None:
                total = transform.finish(total)
            state = strategy.server_combine(state, total)
        version += 1
        states[version] = state
        live = min((u.version for u in fifo), default=version)
        for v in [v for v in states if v < min(live, version)]:
            del states[v]
        if progress is not None:
            progress(version, state,
                     tuple(version - 1 - u.version for u in consumed
                           if u.weight != 0.0))
        if version >= max_rounds or not bool(_keep_going(strategy, state)):
            break

    converged = bool(strategy.converged(state))
    post = getattr(strategy, "post_rounds", None)
    if post is not None:
        state = post(state, backend)
    payload = _transform_ledger(
        strategy.round_payload(_CohortView(backend, buffer), state),
        transform)
    payload = payload._replace(
        staleness=tuple(sorted(staleness_counter.items())))
    return strategy.finalize(state, version, converged, payload.totals(
        version))
