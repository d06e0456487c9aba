"""Federated GMM learning as collectives over a device mesh (port of
``repro/distributed/fed.py``).

Clients map to the ranks of the mesh's ``"data"`` dimension, one process a
rank (``torch.distributed``: NCCL on the card, gloo on the CPU). Every rank
calls the same entry point with the same global ``data (C, N, d)`` and
``mask (C, N)``; it moves only its own block of ``C / world`` clients to
its device (the mesh's) and returns the same, replicated, result. The
algorithms become collective patterns:

  FedGenGMM (one-shot): the local fits run with no communication, then
      the paper's single round is ONE all-gather of every client's
      (K, 2d+1) parameter block and dataset size, packed into one buffer.
      The server's merge, sample and refit then run replicated on every
      rank.

  DEM / FedEM / FedKMeans (iterative): every round all-reduces the summed
      client payload (EM sufficient statistics, or k-means label
      statistics): one all-reduce a round. They have no loop of their own:
      ``ShardedClients`` is a client backend of the same ``run_rounds``
      driver that runs the single-process strategies.

Client c draws what it draws in a single-process run of the same seed, on
whatever rank it lands, so the local fits do not depend on the world size;
at world size 1 every entry point gives its single-process bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.config import FitConfig
from repro_torch.core.dem import DEMStrategy, _resolve_init
from repro_torch.core.em import init_from_means
from repro_torch.core.fedgen import (SYNTHETIC_MODES, FedGenStrategy,
                                     aggregate_cfg, train_locals_cfg)
from repro_torch.core.gmm import GMM
from repro_torch.fed.cohort import make_sampler
from repro_torch.fed.runtime import ShardedClients, run_rounds
from repro_torch.fed.strategies import (FedEMResult, FedEMStrategy,
                                        FedKMeansResult, FedKMeansStrategy,
                                        _resolve_fedkmeans_init)

AXIS = "data"


class ShardedFedResult(NamedTuple):
    global_gmm: GMM
    local_weights: torch.Tensor   # (C, K)
    local_means: torch.Tensor     # (C, K, d)
    local_covs: torch.Tensor      # (C, K, d)


def _mesh_config(config: Optional[FitConfig], mesh, **legacy) -> FitConfig:
    """The run's config on the mesh's device: ``config``, or the legacy
    keywords folded into one."""
    cfg = config if config is not None else FitConfig.from_legacy(**legacy)
    return cfg.replace(device=mesh.device_type)


def fedgen_sharded(mesh, seed: int, data, mask, k: int, k_global: int,
                   h: int = 100, max_iter: int = 200, tol: float = 1e-3,
                   estep_backend: str = "auto",
                   chunk_size: Optional[int] = None,
                   synthetic: str = "resident",
                   config: Optional[FitConfig] = None) -> ShardedFedResult:
    """One-shot FedGenGMM over a device mesh: ``data (C, N, d)``, ``mask
    (C, N)``, C divisible by the size of the mesh's ``"data"`` dimension.
    ``config`` selects the engine of the local fits and of the replicated
    server refit; the loose knobs are the legacy spelling, folded into one
    config when ``config`` is None. ``synthetic="source"`` replays the
    synthetic set S from a ``SyntheticGMMSource`` instead of holding it.
    Seeds follow ``FedGenStrategy``, so at world size 1 the global model
    has ``fedgengmm_cfg``'s bits."""
    if synthetic not in SYNTHETIC_MODES:
        raise ValueError(f"synthetic must be 'resident' or 'source', "
                         f"got {synthetic!r}")
    cfg = _mesh_config(config, mesh, backend=estep_backend,
                       chunk_size=chunk_size, tol=tol, max_iter=max_iter)
    clients = ShardedClients(data, mask, mesh, AXIS)
    seeds = FedGenStrategy(config=cfg).init_state(seed, clients)
    local = train_locals_cfg(clients.block_seeds(seeds["seed_local"]),
                             clients.data, clients.mask, k, cfg).gmm
    # === the single communication round of the paper ===
    w, mu, cov, sizes = clients.all_gather(
        (local.weights, local.means, local.covs, clients.mask.sum(dim=1)))
    res, _ = aggregate_cfg(seeds["seed_agg"],
                           [GMM(w[i], mu[i], cov[i]) for i in range(len(w))],
                           sizes, cfg, k_global, h=h, synthetic=synthetic)
    return ShardedFedResult(res.gmm, w, mu, cov)


def _state_from_centers(strategy, clients: ShardedClients, centers, cfg):
    """Round-0 state around caller-chosen global centers, the data's
    variance all-reduced over the ranks."""
    d = clients.dim
    gmm0 = init_from_means(
        torch.as_tensor(centers), clients.data.reshape(-1, d),
        clients.mask.reshape(-1),
        covariance_type=cfg.covariance_type, reg_covar=cfg.reg_covar,
        sharded=clients)
    return strategy.state_from_gmm(gmm0)


def dem_sharded(mesh, seed: int, data, mask, k: int, init_centers,
                max_rounds: int = 100, tol: float = 1e-3,
                reg_covar: float = 1e-6, estep_backend: str = "auto",
                chunk_size: Optional[int] = None,
                config: Optional[FitConfig] = None,
                transform=None) -> tuple[GMM, int]:
    """Distributed EM over the mesh: one all-reduce of sufficient statistics
    a round. A ``DEMStrategy`` on the shared round driver, from the
    caller-chosen global ``init_centers`` (the scheme inits live in
    ``repro_torch.core.dem.dem_cfg``); ``seed`` is unused on this path and
    kept for the signature. Returns (global model, rounds)."""
    cfg = _mesh_config(config, mesh, backend=estep_backend,
                       chunk_size=chunk_size, tol=tol, max_iter=max_rounds,
                       reg_covar=reg_covar)
    strategy = DEMStrategy(
        k=k, covariance_type=cfg.covariance_type, backend=cfg.backend,
        chunk=cfg.resolve_chunk(False), tol=cfg.resolve_tol("em"),
        reg_covar=cfg.reg_covar)
    clients = ShardedClients(data, mask, mesh, AXIS)
    res = run_rounds(strategy, clients, mesh=mesh,
                     state0=_state_from_centers(strategy, clients,
                                                init_centers, cfg),
                     max_rounds=cfg.resolve_max_iter("em"),
                     transform=transform)
    return res.global_gmm, res.n_rounds


def fedem_sharded(mesh, seed: int, data, mask, k: int, *,
                  participation: float = 1.0, local_epochs: int = 1,
                  cohort: str = "cyclic", cohort_seed: int = 0,
                  stragglers=None, init_centers=None,
                  config: Optional[FitConfig] = None,
                  transform=None) -> FedEMResult:
    """Iterative federated EM (Tian et al.) over the mesh: DEM's all-reduce
    with partial participation and local epochs. Under ``participation <
    1`` the round loop samples a cohort (``cohort``: "cyclic" or seeded
    "uniform") and each rank computes only the members it owns. The init
    is the config's scheme ("auto": one-shot federated k-means, its local
    fits sharded, one all-gather), or ``init_centers``."""
    cfg = _mesh_config(config or FitConfig(), mesh)
    c = data.shape[0]
    strategy = FedEMStrategy(
        k=k, covariance_type=cfg.covariance_type, backend=cfg.backend,
        chunk=cfg.resolve_chunk(False), init=_resolve_init(cfg.init),
        tol=cfg.resolve_tol("em"), reg_covar=cfg.reg_covar,
        participation=float(participation), local_epochs=int(local_epochs),
        n_clients=c)
    sampler = None
    if strategy.participation < 1.0:
        sampler = make_sampler(cohort, c, strategy.cohort_size(),
                               seed=cohort_seed)
    clients = ShardedClients(data, mask, mesh, AXIS)
    state0 = (None if init_centers is None else
              _state_from_centers(strategy, clients, init_centers, cfg))
    return run_rounds(strategy, clients, seed=seed, mesh=mesh,
                      state0=state0, max_rounds=cfg.resolve_max_iter("em"),
                      sampler=sampler, stragglers=stragglers,
                      transform=transform)


def fed_kmeans_sharded(mesh, seed: int, data, mask, k: int, *,
                       config: Optional[FitConfig] = None,
                       transform=None) -> FedKMeansResult:
    """Iterative federated k-means (Garst et al.) over the mesh: one
    all-reduce of per-center label statistics (counts, sums, inertia) a
    round, DEM's collective with responsibilities replaced by labels."""
    cfg = _mesh_config(config or FitConfig(), mesh)
    strategy = FedKMeansStrategy(
        k=k, assign_backend=cfg.backend, chunk=cfg.resolve_chunk(False),
        init=_resolve_fedkmeans_init(cfg.init),
        tol=cfg.resolve_tol("kmeans"))
    return run_rounds(strategy, (data, mask), seed=seed, mesh=mesh,
                      max_rounds=cfg.resolve_max_iter("kmeans"),
                      transform=transform)
