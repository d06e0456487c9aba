"""Distributed EM (DEM) baselines, §5.4 of the paper after Wu et al. '23
(port of ``repro/core/dem.py``).

Every client runs the E-step locally and ships sufficient statistics; the
server sums them, runs the M-step and broadcasts the new parameters. One EM
iteration is one communication round, so DEM is a one-screen
:class:`DEMStrategy` on the federation runtime (``repro_torch.fed.runtime``):
``local_step`` is the E-step of a batch of clients against the broadcast
model, ``server_combine`` the M-step plus the avg-loglik convergence
scalar.

Three initializations of the global centers, in ``FitConfig.init`` terms:
  "separated"  (init 1): greedy farthest-point centers in the unit
               hypercube (features are normalized to [0, 1], §5.1);
  "pilot"      (init 2): a pilot GMM on a 100-row subset uploaded to the
               server;
  "fed-kmeans" (init 3): one-shot federated k-means (Dennis et al. '21).

The random stages (the separated scheme's candidates, the pilot subset)
draw from the port's generators, not threefry.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.config import (FitConfig, derive_seed, is_source_list,
                                     make_generator, resolve_device)
from repro_torch.core.em import (e_step_stats, fit_gmm_cfg, init_from_means,
                                 m_step)
from repro_torch.core.gmm import GMM
from repro_torch.core.kmeans import federated_kmeans
from repro_torch.data.sources import ConcatSource, DataSource
from repro_torch.fed.ledger import (CommStats, RoundPayload, dtype_itemsize,
                                    gmm_payload_floats, stats_payload_floats)
from repro_torch.fed.runtime import run_rounds


class DEMResult(NamedTuple):
    global_gmm: GMM
    log_likelihood: torch.Tensor   # avg loglik over all client data
    n_rounds: int
    converged: bool
    comm: CommStats


# DEM init schemes: paper numbering -> FitConfig init-strategy names.
INIT_SCHEME_NAMES = {1: "separated", 2: "pilot", 3: "fed-kmeans"}


def _resolve_init(init: str, sources: bool = False) -> str:
    """``auto`` is fed-kmeans (init 3) on a resident split and separated
    centers (init 1) on source clients (the pilot subset would upload raw
    rows); ``kmeans`` is the single-model init and no DEM scheme."""
    if init == "auto":
        return "separated" if sources else "fed-kmeans"
    if init == "kmeans":
        raise ValueError(
            "init='kmeans' is the single-model GMM init; DEM init "
            "strategies are 'separated' | 'pilot' | 'fed-kmeans' (paper "
            "schemes 1/2/3) or 'auto'")
    return init


# ----------------------------------------------------------------------
# Initializations
# ----------------------------------------------------------------------

def farthest_point_centers(cand: torch.Tensor, k: int) -> torch.Tensor:
    """The greedy farthest-point step of init 1 over candidates
    ``cand (n, d)``: the first center is the cube's middle (0.5, ..., 0.5),
    each next one the candidate farthest from the centers so far (the first
    such candidate on a tie)."""
    d = cand.shape[1]
    center0 = torch.full((d,), 0.5, dtype=cand.dtype, device=cand.device)
    centers = cand.new_zeros((k, d))
    centers[0] = center0
    min_d = torch.sum((cand - center0) ** 2, dim=1)
    for i in range(1, k):
        c = cand[torch.argmax(min_d)]
        centers[i] = c
        min_d = torch.minimum(min_d, torch.sum((cand - c) ** 2, dim=1))
    return centers


def max_separated_centers(seed: int, k: int, d: int,
                          n_candidates: int = 2048,
                          device="cpu") -> torch.Tensor:
    """Init 1: greedy farthest-point centers among ``n_candidates`` uniform
    points of [0, 1]^d, drawn on the host from ``seed`` (the same points on
    every device)."""
    cand = torch.rand((n_candidates, d), generator=make_generator(seed))
    return farthest_point_centers(cand.to(device), k)


# Init 2's pilot subset size (raw rows uploaded to the server), and what
# the ledger charges a pilot init for.
PILOT_ROWS = 100


def pilot_subset_centers(seed: int, split, k: int,
                         n_pilot: int = PILOT_ROWS, backend: str = "auto",
                         device="cuda") -> torch.Tensor:
    """Init 2: the clients upload ``n_pilot`` rows drawn uniformly without
    replacement from their real (unpadded) rows (Gumbel top-k on the host,
    ``derive_seed(seed, "pilot-rows")``); the server fits a pilot GMM of k
    components on them (``max_iter`` 100) on ``device`` and keeps its
    means. ``split`` is a padded numpy ``ClientSplit``. Uploads raw
    data."""
    d = split.data.shape[-1]
    data = torch.as_tensor(np.asarray(split.data, np.float32)).reshape(-1, d)
    mask = torch.as_tensor(np.asarray(split.mask, np.float32)).reshape(-1)
    u = torch.rand(mask.shape, generator=make_generator(
        derive_seed(seed, "pilot-rows")))
    scores = torch.where(mask > 0, -torch.log(-torch.log(u)),
                         float("-inf"))
    pilot = data[torch.topk(scores, n_pilot).indices]
    device = resolve_device(device)
    res = fit_gmm_cfg(derive_seed(seed, "pilot-fit"), pilot, k,
                      FitConfig(backend=backend, max_iter=100,
                                device=str(device)))
    return res.gmm.means


def fed_kmeans_centers(seed: int, clients, k: int,
                       chunk_size: Optional[int] = None,
                       assign_backend: str = "auto") -> torch.Tensor:
    """Init 3: one-shot federated k-means global centers over resident
    clients (``SplitClients``: data and mask tensors on the device)."""
    return federated_kmeans(seed, clients.data, k,
                            client_weights=clients.mask,
                            chunk_size=chunk_size,
                            assign_backend=assign_backend)


# ----------------------------------------------------------------------
# DEM as a federation strategy
# ----------------------------------------------------------------------

class DEMState(NamedTuple):
    """Round-loop state: the global model and the convergence scalars
    (``ll`` and ``prev_ll`` are device scalars)."""
    gmm: GMM
    prev_ll: torch.Tensor
    ll: torch.Tensor
    tol: float
    reg_covar: float


def _broadcast(gmm: GMM, m: int) -> GMM:
    """The global model as a stacked model of ``m`` members (views)."""
    return GMM(gmm.weights.expand((m,) + gmm.weights.shape),
               gmm.means.expand((m,) + gmm.means.shape),
               gmm.covs.expand((m,) + gmm.covs.shape))


@dataclasses.dataclass(frozen=True)
class DEMStrategy:
    """Distributed EM on the federation runtime: clients ship
    :class:`~repro_torch.core.em.SufficientStats`, the server M-steps, one
    EM iteration per communication round."""

    k: int
    covariance_type: str = "diag"
    backend: str = "auto"            # engine knob (resolved per op)
    chunk: Optional[int] = None
    init: str = "fed-kmeans"
    tol: float = dataclasses.field(default=1e-3, compare=False)
    reg_covar: float = dataclasses.field(default=1e-6, compare=False)

    one_shot = False
    name = "dem"

    # -- init ----------------------------------------------------------

    def init_state(self, seed: int, backend) -> DEMState:
        seed = derive_seed(seed, "init")
        if backend.kind == "sources":
            return self._init_sources(seed, backend)
        data, mask, d = backend.data, backend.mask, backend.dim
        if self.init == "separated":
            centers = max_separated_centers(seed, self.k, d,
                                            device=backend.device)
        elif self.init == "pilot":
            if backend.split is None:
                raise ValueError("DEM init 'pilot' needs a ClientSplit (it "
                                 "uploads a raw pilot subset)")
            centers = pilot_subset_centers(seed, backend.split, self.k,
                                           backend=self.backend,
                                           device=backend.device)
        else:  # "fed-kmeans"
            centers = fed_kmeans_centers(seed, backend, self.k, self.chunk,
                                         self.backend)
        gmm0 = init_from_means(centers, data.reshape(-1, d),
                               mask.reshape(-1),
                               covariance_type=self.covariance_type,
                               reg_covar=self.reg_covar)
        return self.state_from_gmm(gmm0)

    def _init_sources(self, seed: int, backend) -> DEMState:
        """The init over source clients: separated or fed-kmeans centers
        (each client's local k-means streamed), then the data's variance
        streamed over the union of the clients."""
        if self.init == "separated":
            centers = max_separated_centers(seed, self.k, backend.dim,
                                            device=backend.device)
        elif self.init == "fed-kmeans":
            centers = federated_kmeans(seed, backend.sources, self.k,
                                       chunk_size=self.chunk,
                                       assign_backend=self.backend,
                                       device=backend.device)
        else:  # "pilot"
            raise ValueError(
                "DEM init 'pilot' uploads raw rows and needs resident "
                "client data; use a ClientSplit for it")
        gmm0 = init_from_means(centers, ConcatSource(backend.sources),
                               covariance_type=self.covariance_type,
                               reg_covar=self.reg_covar,
                               chunk_size=self.chunk)
        return self.state_from_gmm(gmm0)

    def state_from_gmm(self, gmm0: GMM) -> DEMState:
        """Round-0 state around an externally built initial model."""
        neg_inf = torch.tensor(float("-inf"), dtype=gmm0.means.dtype,
                               device=gmm0.device)
        return self._make_state(gmm0, neg_inf, neg_inf, float(self.tol),
                                float(self.reg_covar))

    def _make_state(self, gmm, prev_ll, ll, tol, reg_covar):
        return DEMState(gmm, prev_ll, ll, tol, reg_covar)

    # -- one round ------------------------------------------------------

    def local_step(self, state: DEMState, x, w, idx):
        """The E-step of a batch of clients ``x (m, N, d)`` against the
        broadcast model: per-client statistics with a leading axis m (the
        uplink; additive, so the backend sums them). On the fused backend
        this is one ``estep_stats`` launch for the batch. A source client's
        E-step streams its blocks (one launch a block)."""
        if isinstance(x, DataSource):
            return e_step_stats(state.gmm, x, None, self.backend, self.chunk)
        return e_step_stats(_broadcast(state.gmm, x.shape[0]), x, w,
                            self.backend, self.chunk)

    def server_combine(self, state: DEMState, stats) -> DEMState:
        gmm = m_step(stats, state.reg_covar)
        ll = stats.loglik / torch.clamp(stats.wsum, min=1e-12)
        return self._next_state(state, gmm, ll)

    def _next_state(self, state, gmm, ll):
        return DEMState(gmm, state.ll, ll, state.tol, state.reg_covar)

    def converged(self, state: DEMState):
        return abs(state.ll - state.prev_ll) <= state.tol

    def keep_going(self, state: DEMState):
        """Kept apart from ``converged``: with a NaN loglik both are false,
        so the loop stops after one more round and reports
        not-converged."""
        return abs(state.ll - state.prev_ll) > state.tol

    # -- accounting / result -------------------------------------------

    def round_payload(self, backend, state) -> RoundPayload:
        c, d = backend.num_clients, backend.dim
        diag = self.covariance_type == "diag"
        pop = backend.population_clients
        if self.init == "fed-kmeans":
            # every client uploads its k local centers + k cluster sizes
            init_up = pop * (self.k * d + self.k)
        elif self.init == "pilot":
            init_up = PILOT_ROWS * d   # raw pilot rows to the server
        else:  # "separated": built on the server, no uplink
            init_up = 0
        return RoundPayload(
            uplink_floats=c * stats_payload_floats(self.k, d, diag),
            downlink_floats=c * gmm_payload_floats(self.k, d, diag),
            itemsize=dtype_itemsize(state.gmm.means.dtype),
            extra_uplink_floats=init_up,
            # the round-0 global model broadcast
            extra_downlink_floats=pop * gmm_payload_floats(self.k, d, diag))

    def finalize(self, state: DEMState, n_rounds, converged,
                 comm: CommStats) -> DEMResult:
        return DEMResult(state.gmm, state.ll, n_rounds, converged, comm)


def dem_cfg(seed: int, clients, config: FitConfig, k: int) -> DEMResult:
    """Run DEM on a padded client split or a list of per-client DataSources:
    the cfg-core behind ``repro_torch.api.DEM``. The init scheme is
    ``config.init`` ("auto" = fed-kmeans on a split, separated on
    sources); ``config.max_iter`` bounds the rounds."""
    sources = is_source_list(clients)
    strategy = DEMStrategy(
        k=k, covariance_type=config.covariance_type, backend=config.backend,
        chunk=config.resolve_chunk(sources),
        init=_resolve_init(config.init, sources),
        tol=config.resolve_tol("em"), reg_covar=config.reg_covar)
    return run_rounds(strategy, clients, seed=seed,
                      device=config.resolve_device(),
                      max_rounds=config.resolve_max_iter("em"))
