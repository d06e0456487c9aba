"""The iterative federated baselines as strategies on the federation runtime
(port of ``repro/fed/strategies.py``), over a padded split or a list of
per-client DataSources.

- :class:`FedEMStrategy`: iterative federated EM after Tian et al.: each
  round every participating client runs ``local_epochs`` local EM steps
  from the broadcast model and ships its final epoch's statistics; the
  server sums and M-steps. With full participation and one epoch it is
  :class:`~repro_torch.core.dem.DEMStrategy`. Partial participation is
  cohort execution: the round loop's sampler hands the backend each
  round's cohort and only those clients compute.
- :class:`FedKMeansStrategy`: iterative federated k-means after Garst &
  Reinders: clients ship per-center label statistics (counts, sums,
  inertia) against the broadcast centers; the server recombines them into
  new centers and stops on the squared center shift.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.config import FitConfig, derive_seed, is_source_list
from repro_torch.core.dem import (DEMStrategy, _broadcast, _resolve_init,
                                  fed_kmeans_centers, max_separated_centers)
from repro_torch.core.em import e_step_stats, m_step
from repro_torch.core.gmm import GMM
from repro_torch.data.sources import DataSource
from repro_torch.core.kmeans import federated_kmeans, lloyd_round_stats
from repro_torch.fed.cohort import make_sampler
from repro_torch.fed.ledger import (CommStats, RoundPayload, dtype_itemsize,
                                    label_payload_floats)
from repro_torch.fed.async_runtime import run_policy
from repro_torch.fed.runtime import run_rounds


class FedEMResult(NamedTuple):
    global_gmm: GMM
    log_likelihood: torch.Tensor   # avg loglik over the last round's cohort
    n_rounds: int
    converged: bool
    comm: CommStats


class FedEMState(NamedTuple):
    """DEM's round state plus the round counter and the per-cohort loglik
    ring buffer that makes partial-participation convergence judgeable."""
    gmm: GMM
    prev_ll: torch.Tensor
    ll: torch.Tensor
    tol: float
    reg_covar: float
    rnd: int
    ll_hist: torch.Tensor   # (T,), T = the cohort cycle's length


def check_participation(participation: float) -> float:
    """The per-round cohort fraction, in (0, 1]."""
    if not 0.0 < float(participation) <= 1.0:
        raise ValueError(
            f"participation must be in (0, 1], got {participation}")
    return float(participation)


@dataclasses.dataclass(frozen=True)
class FedEMStrategy(DEMStrategy):
    """DEM generalized per Tian et al.: ``local_epochs`` local EM steps per
    round and partial participation (``participation`` of the
    ``n_clients`` clients per round, sampled by the round loop). The
    defaults reduce it to :class:`DEMStrategy`."""

    participation: float = 1.0
    local_epochs: int = 1
    n_clients: int = 0   # required when participation < 1 (cycle length)

    name = "fedem"

    def __post_init__(self):
        check_participation(self.participation)
        if int(self.local_epochs) < 1:
            raise ValueError(
                f"local_epochs must be >= 1, got {self.local_epochs}")
        if self.participation < 1.0 and self.n_clients < 1:
            raise ValueError(
                "participation < 1 needs n_clients (the cyclic cohort "
                "window is sized from it)")

    def cohort_size(self) -> int:
        """Clients per round (always >= 1)."""
        if self.participation >= 1.0:
            return self.n_clients
        return max(1, int(round(self.participation * self.n_clients)))

    def _period(self) -> int:
        """Rounds until the cyclic window revisits a cohort, C / gcd(C, m);
        1 under full participation."""
        if self.participation >= 1.0:
            return 1
        c, m = self.n_clients, self.cohort_size()
        return c // math.gcd(c, m)

    def _make_state(self, gmm, prev_ll, ll, tol, reg_covar):
        hist = torch.full((self._period(),), float("-inf"),
                          dtype=gmm.means.dtype, device=gmm.device)
        return FedEMState(gmm, prev_ll, ll, tol, reg_covar, 0, hist)

    def _next_state(self, state, gmm, ll):
        t = self._period()
        if t == 1:
            # full participation: DEM's consecutive-round delta
            return FedEMState(gmm, state.ll, ll, state.tol, state.reg_covar,
                              state.rnd + 1, state.ll_hist)
        # Consecutive rounds score different cohorts, so prev_ll is this
        # same cohort's loglik one cycle ago; slots still at -inf (first
        # cycle) keep the loop going.
        pos = state.rnd % t
        prev = state.ll_hist[pos]
        hist = state.ll_hist.clone()
        hist[pos] = ll
        return FedEMState(gmm, prev, ll, state.tol, state.reg_covar,
                          state.rnd + 1, hist)

    def local_step(self, state: FedEMState, x, w, idx):
        """``local_epochs`` EM steps of a batch of cohort members from the
        broadcast model (each member M-steps on its own statistics between
        E-steps); the last epoch's statistics are the uplink. One
        ``estep_stats`` launch an epoch on the fused backend (a block, on a
        source client)."""
        gmm = (state.gmm if isinstance(x, DataSource)
               else _broadcast(state.gmm, x.shape[0]))
        stats = e_step_stats(gmm, x, w, self.backend, self.chunk)
        for _ in range(self.local_epochs - 1):
            gmm = m_step(stats, state.reg_covar)
            stats = e_step_stats(gmm, x, w, self.backend, self.chunk)
        return stats

    # round_payload is DEM's: under a sampler the round loop's accounting
    # view reports num_clients == cohort size.

    def finalize(self, state: FedEMState, n_rounds, converged,
                 comm: CommStats) -> FedEMResult:
        return FedEMResult(state.gmm, state.ll, n_rounds, converged, comm)


def fedem_cfg(seed: int, clients, config: FitConfig, k: int,
              participation: float = 1.0, local_epochs: int = 1,
              cohort: str = "cyclic", cohort_seed: int = 0,
              stragglers=None, transform=None,
              async_policy=None) -> FedEMResult:
    """Run FedEM on a padded client split or a list of per-client
    DataSources: the cfg-core behind ``repro_torch.api.FedEM``.
    ``participation < 1`` installs the round loop's cohort sampler
    (``cohort``: "cyclic" or "uniform" from ``cohort_seed``); at full
    participation there is none, and the run is DEM's. ``stragglers`` drops
    each round's slowest arrivals; ``transform`` is the uplink transform;
    ``async_policy`` runs the rounds through the buffered asynchronous
    driver."""
    sources = is_source_list(clients)
    n_clients = len(clients) if sources else clients.data.shape[0]
    strategy = FedEMStrategy(
        k=k, covariance_type=config.covariance_type, backend=config.backend,
        chunk=config.resolve_chunk(sources),
        init=_resolve_init(config.init, sources),
        tol=config.resolve_tol("em"), reg_covar=config.reg_covar,
        participation=float(participation), local_epochs=int(local_epochs),
        n_clients=n_clients)
    sampler = None
    if strategy.participation < 1.0:
        sampler = make_sampler(cohort, n_clients, strategy.cohort_size(),
                               seed=cohort_seed)
    kw = dict(seed=seed, device=config.resolve_device(),
              max_rounds=config.resolve_max_iter("em"), sampler=sampler,
              stragglers=stragglers, transform=transform)
    return run_policy(strategy, clients, async_policy, **kw)


# ----------------------------------------------------------------------
# Federated k-means (Garst et al.)
# ----------------------------------------------------------------------

class FedKMeansResult(NamedTuple):
    centers: torch.Tensor     # (K, d) global centers
    inertia: torch.Tensor     # weighted inertia of the returned centers
    n_rounds: int
    converged: bool
    comm: CommStats


class FedKMeansState(NamedTuple):
    centers: torch.Tensor
    shift: torch.Tensor       # squared center shift of the last update
    inertia: torch.Tensor
    tol: float


FEDKMEANS_INITS = ("fed-kmeans", "separated")


@dataclasses.dataclass(frozen=True)
class FedKMeansStrategy:
    """Iterative federated Lloyd: clients ship label statistics against the
    broadcast centers (one ``kmeans_sweep_stats`` launch a round for the
    batch of clients on the fused backend); the server recombines
    ``sums / counts`` into new centers and stops when the squared center
    shift drops to ``tol``."""

    k: int
    assign_backend: str = "auto"
    chunk: Optional[int] = None
    init: str = "fed-kmeans"
    tol: float = dataclasses.field(default=1e-4, compare=False)

    one_shot = False
    name = "fedkmeans"

    def init_state(self, seed: int, backend) -> FedKMeansState:
        seed = derive_seed(seed, "init")
        if self.init == "separated":
            centers = max_separated_centers(seed, self.k, backend.dim,
                                            device=backend.device)
        elif backend.kind == "sources":
            centers = federated_kmeans(seed, backend.sources, self.k,
                                       chunk_size=self.chunk,
                                       assign_backend=self.assign_backend,
                                       device=backend.device)
        else:
            centers = fed_kmeans_centers(seed, backend, self.k, self.chunk,
                                         self.assign_backend)
        inf = torch.tensor(float("inf"), dtype=centers.dtype,
                           device=centers.device)
        return FedKMeansState(centers, inf, inf, float(self.tol))

    def local_step(self, state: FedKMeansState, x, w, idx):
        return lloyd_round_stats(state.centers, x, w, self.assign_backend,
                                 self.chunk)

    def server_combine(self, state: FedKMeansState,
                       total) -> FedKMeansState:
        counts, sums, inertia = total
        cnt = counts.unsqueeze(-1)
        new_centers = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1e-12),
                                  state.centers)
        shift = torch.sum((new_centers - state.centers) ** 2)
        return FedKMeansState(new_centers, shift, inertia, state.tol)

    def converged(self, state: FedKMeansState):
        return state.shift <= state.tol

    def keep_going(self, state: FedKMeansState):
        """Kept apart from ``not converged`` so that a NaN shift halts the
        loop and reports not-converged."""
        return state.shift > state.tol

    def post_rounds(self, state: FedKMeansState, backend) -> FedKMeansState:
        """One more assignment sweep against the final centers, so the
        reported inertia is that of the centers the caller gets (each
        client ships one scalar, ``extra_uplink_floats``)."""
        def rescore(st, x, w, idx):
            return lloyd_round_stats(st.centers, x, w, self.assign_backend,
                                     self.chunk)[2]

        return state._replace(inertia=backend.reduce_clients(rescore, state))

    def round_payload(self, backend, state) -> RoundPayload:
        c, d = backend.num_clients, backend.dim
        pop = backend.population_clients
        # the fed-kmeans warm start first collects each client's k local
        # centers + k cluster sizes (Dennis et al.)
        warm_up = pop * (self.k * d + self.k) \
            if self.init == "fed-kmeans" else 0
        return RoundPayload(
            uplink_floats=c * label_payload_floats(self.k, d),
            downlink_floats=c * self.k * d,
            itemsize=dtype_itemsize(state.centers.dtype),
            # the post-rounds rescore (one scalar a client) + warm start
            extra_uplink_floats=pop + warm_up,
            # the round-0 centers broadcast
            extra_downlink_floats=pop * self.k * d)

    def finalize(self, state: FedKMeansState, n_rounds, converged,
                 comm: CommStats) -> FedKMeansResult:
        return FedKMeansResult(state.centers, state.inertia, n_rounds,
                               converged, comm)


def _resolve_fedkmeans_init(init: str) -> str:
    if init == "auto":
        return "fed-kmeans"
    if init not in FEDKMEANS_INITS:
        raise ValueError(
            f"FedKMeans init must be 'auto' or one of {FEDKMEANS_INITS} "
            f"(a one-shot warm start or separated centers), got {init!r}")
    return init


def fed_kmeans_cfg(seed: int, clients, config: FitConfig, k: int,
                   transform=None) -> FedKMeansResult:
    """Run iterative federated k-means on a padded client split or a list
    of per-client DataSources: the cfg-core behind
    ``repro_torch.api.FedKMeans``. ``tol`` and ``max_iter`` resolve through
    the "kmeans" defaults; ``transform`` is the uplink transform."""
    device = config.resolve_device()
    strategy = FedKMeansStrategy(
        k=k, assign_backend=config.backend,
        chunk=config.resolve_chunk(is_source_list(clients)),
        init=_resolve_fedkmeans_init(config.init),
        tol=config.resolve_tol("kmeans"))
    return run_rounds(strategy, clients, seed=seed, device=device,
                      max_rounds=config.resolve_max_iter("kmeans"),
                      transform=transform)
