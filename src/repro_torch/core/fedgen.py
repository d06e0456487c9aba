"""FedGenGMM (Algorithm 4.1): one-shot federated GMM learning (port of
``repro/core/fedgen.py``).

Pipeline:
  1. local EM per client, all clients as one stacked batch over the padded
     (C, N, d) split with its 0/1 row mask (fixed K_c), or per-client BIC
     selection over candidate Ks (heterogeneous K_c),
  2. a single communication round: clients ship (w, mu, Sigma, |D_c|),
  3. server merge: re-weight by |D_c|/|D|, concatenate, normalize,
  4. the server samples |S| = H * sum_c K_c synthetic rows from the merged
     mixture and trains the global GMM on S (fixed K or BIC selection).

Clients arrive as a padded split or as a list of per-client
:class:`DataSource` streams (out of core: each local fit streams its
client's blocks, a host loop over clients). With ``synthetic="source"``
the server never materializes S either: the refit replays a
:class:`SyntheticGMMSource` of the merged mixture block by block.

An uplink transform (``run_rounds(transform=...)``) releases each client's
``(gmm, |D_c|)`` block before the server merges it; under
:class:`~repro_torch.fed.transforms.GaussianDP` that is the one-shot DP
release, the whole budget spent in this one round.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import (FitConfig, derive_seed, is_source_list,
                                     make_generator)
from repro_torch.core.em import (EMResult, bic_streaming, fit_gmm_bic_cfg,
                                 fit_gmm_cfg)
from repro_torch.core.gmm import GMM, merge_gmms
from repro_torch.data.sources import DataSource, SyntheticGMMSource
from repro_torch.fed.ledger import (CommStats, RoundPayload, dtype_itemsize,
                                    payload_floats)
from repro_torch.fed.runtime import run_rounds


class FedGenResult(NamedTuple):
    global_gmm: GMM
    local_gmms: list[GMM]
    synthetic: object          # the server-side dataset S: an (|S|, d)
    #                            tensor, or the SyntheticGMMSource the refit
    #                            replayed (synthetic="source")
    comm: CommStats
    local_results: list[EMResult]


def train_locals_cfg(seed: int, data: torch.Tensor, mask: torch.Tensor,
                     k: int, config: FitConfig) -> EMResult:
    """Local EM of every client at once, fixed K_c = k: data (C, N, d)
    padded, mask (C, N). Client c draws from ``derive_seed(seed, c)``.
    Returns the stacked :class:`EMResult` (leaves with leading dim C)."""
    return fit_gmm_cfg(seed, data, k, config, sample_weight=mask)


def train_locals(seed: int, data, mask, k: int, max_iter: int = 200,
                 tol: float = 1e-3, reg_covar: float = 1e-6,
                 covariance_type: str = "diag", estep_backend: str = "auto",
                 chunk_size: Optional[int] = None,
                 device="cuda") -> EMResult:
    """Legacy keyword surface of :func:`train_locals_cfg`."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return train_locals_cfg(seed, data, mask, k, cfg)


def train_locals_bic_cfg(seed: int, data: torch.Tensor, mask: torch.Tensor,
                         k_candidates: Sequence[int], config: FitConfig
                         ) -> tuple[list[EMResult], list[dict[int, float]]]:
    """Per-client TrainGMM with BIC selection, heterogeneous K_c: data
    (C, N, d) padded, mask (C, N).

    Each candidate K is fitted for all clients as one stacked batch.
    Client c's fit of candidate i is seeded as
    ``fit_gmm_bic_cfg(derive_seed(seed, c), ...)`` seeds it alone, so the
    selection does not depend on the client's position in the batch. Each
    client's BIC is scored on its own rows (the mask as sample weight, so
    n = |D_c|): one ``gmm_log_prob`` launch per client and candidate. The
    first minimum wins. Returns each client's selected :class:`EMResult`
    and each client's BIC by candidate."""
    c = data.shape[0]
    client_seeds = [derive_seed(seed, i) for i in range(c)]
    best = [None] * c
    best_bic = [float("inf")] * c
    bics = [{} for _ in range(c)]
    for i, k in enumerate(k_candidates):
        res = fit_gmm_cfg([derive_seed(s, i) for s in client_seeds], data,
                          k, config, sample_weight=mask)
        scores = torch.stack([
            bic_streaming(res.gmm[m], data[m], mask[m],
                          chunk_size=config.resolve_chunk(False),
                          backend=config.backend) for m in range(c)])
        for m, b in enumerate(scores.tolist()):
            bics[m][k] = b
            if b < best_bic[m]:
                best_bic[m] = b
                best[m] = EMResult(res.gmm[m], res.log_likelihood[m],
                                   res.n_iter[m], res.converged[m])
    return best, bics


def train_locals_bic(seed: int, data, mask, k_candidates: Sequence[int],
                     max_iter: int = 200, tol: float = 1e-3,
                     reg_covar: float = 1e-6, covariance_type: str = "diag",
                     estep_backend: str = "auto",
                     chunk_size: Optional[int] = None, device="cuda"
                     ) -> tuple[list[EMResult], list[dict[int, float]]]:
    """Legacy keyword surface of :func:`train_locals_bic_cfg`."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return train_locals_bic_cfg(seed, data, mask, k_candidates, cfg)


def train_locals_sources_cfg(seed: int, sources: Sequence[DataSource],
                             config: FitConfig, k: Optional[int] = None,
                             k_candidates: Optional[Sequence[int]] = None
                             ) -> list[EMResult]:
    """Local TrainGMM per client, each over its own :class:`DataSource`, a
    host loop over clients: the edge regime, where a client's dataset
    never has to fit in memory, only one block of it. Fixed ``k`` or
    per-client BIC selection over ``k_candidates``; client i is seeded
    with ``derive_seed(seed, i)``. No padding, masks or weights."""
    if k is None and k_candidates is None:
        raise ValueError("need k or k_candidates")
    results = []
    for i, src in enumerate(sources):
        sub = derive_seed(seed, i)
        if k is not None:
            res = fit_gmm_cfg(sub, src, k, config)
        else:
            res, _ = fit_gmm_bic_cfg(sub, src, k_candidates, config)
        results.append(res)
    return results


def train_locals_from_sources(seed: int, sources: Sequence[DataSource],
                              k: Optional[int] = None,
                              k_candidates: Optional[Sequence[int]] = None,
                              max_iter: int = 200, tol: float = 1e-3,
                              reg_covar: float = 1e-6,
                              covariance_type: str = "diag",
                              estep_backend: str = "auto",
                              chunk_size: Optional[int] = None,
                              device="cuda") -> list[EMResult]:
    """Deprecated: the per-client out-of-core local fits are the source arm
    of :func:`train_locals_sources_cfg`, which ``repro_torch.api.FedGenGMM``
    drives. This shim forwards (the same bits) and will be removed."""
    warnings.warn(
        "train_locals_from_sources is deprecated; use "
        "repro_torch.api.FedGenGMM(...).run(sources) for the full pipeline "
        "or train_locals_sources_cfg with a FitConfig — same engine, same "
        "bits", DeprecationWarning, stacklevel=2)
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return train_locals_sources_cfg(seed, sources, cfg, k=k,
                                    k_candidates=k_candidates)


SYNTHETIC_MODES = ("resident", "source")


def aggregate_cfg(seed: int, local_gmms: list[GMM], sizes,
                  config: FitConfig, k_global: Optional[int] = None,
                  h: int = 100,
                  k_candidates: Optional[Sequence[int]] = None,
                  synthetic: str = "resident"):
    """Algorithm 4.1 lines 21-31: merge (the local models may differ in K),
    sample S, train the global model on S: of ``k_global`` components, or
    the BIC choice among ``k_candidates``. ``synthetic="resident"`` holds S
    on the device; ``"source"`` replays a :class:`SyntheticGMMSource` of the
    merged mixture, regenerated block by block (cached on the device up to
    its ``cache_rows``), so the server's memory does not grow with H or the
    number of clients. Returns the refit and S (tensor or source)."""
    if synthetic not in SYNTHETIC_MODES:
        raise ValueError(f"synthetic must be 'resident' or 'source', "
                         f"got {synthetic!r}")
    merged = merge_gmms(local_gmms, sizes)
    n_synth = h * sum(g.n_components for g in local_gmms)
    if synthetic == "source":
        s = SyntheticGMMSource(merged, n_synth, derive_seed(seed, "sample"),
                               device=merged.device)
    else:
        gen = make_generator(derive_seed(seed, "sample"), merged.device)
        s = merged.sample(gen, n_synth)
    if k_global is not None:
        res = fit_gmm_cfg(derive_seed(seed, "fit"), s, k_global, config)
    else:
        if k_candidates is None:
            raise ValueError("need k_global or k_candidates")
        res, _ = fit_gmm_bic_cfg(derive_seed(seed, "fit"), s, k_candidates,
                                 config)
    return res, s


def aggregate(seed: int, local_gmms: list[GMM], sizes, h: int = 100,
              k_global: Optional[int] = None,
              k_candidates: Optional[Sequence[int]] = None,
              max_iter: int = 200, tol: float = 1e-3,
              reg_covar: float = 1e-6, covariance_type: str = "diag",
              estep_backend: str = "auto", chunk_size: Optional[int] = None,
              synthetic: str = "resident", device="cuda"):
    """Legacy keyword surface of :func:`aggregate_cfg`."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return aggregate_cfg(seed, local_gmms, sizes, cfg, k_global, h=h,
                         k_candidates=k_candidates, synthetic=synthetic)


@dataclasses.dataclass(frozen=True)
class FedGenStrategy:
    """Algorithm 4.1 as a one-shot strategy of the federation runtime: the
    single round trains every client locally (fixed ``k_clients``, or BIC
    selection over ``k_candidates``, which makes K_c heterogeneous), then
    merges, samples and refits on the server (``k_global``, or BIC over
    ``k_candidates``). Padded split clients train as one batch, source
    clients one after another, each streamed; ``synthetic`` says whether S
    is resident or replayed. Uplink is each client's (K_c, 2d+1) parameter
    block + |D_c|, downlink the global broadcast, one round by
    construction."""

    config: FitConfig
    k_clients: Optional[int] = None
    k_global: Optional[int] = None
    k_candidates: Optional[tuple] = None
    h: int = 100
    synthetic: str = "resident"

    one_shot = True
    name = "fedgen"

    def init_state(self, seed: int, backend) -> dict:
        return {"seed_local": derive_seed(seed, "local"),
                "seed_agg": derive_seed(seed, "aggregate")}

    def run_once(self, state: dict, backend, transform=None, tparams=None,
                 tkey=None) -> dict:
        """The single round. With an uplink ``transform``, client i's
        ``(gmm, |D_c|)`` block is released under the round-0 key ``tkey``
        (its draws its own) before the merge."""
        if backend.kind == "sharded":
            raise ValueError(
                "FedGenGMM over a mesh runs through "
                "repro_torch.distributed.fedgen_sharded")
        if backend.kind == "sources":
            local_results = train_locals_sources_cfg(
                state["seed_local"], backend.sources, self.config,
                k=self.k_clients, k_candidates=self.k_candidates)
        elif self.k_clients is not None:
            stacked = train_locals_cfg(state["seed_local"], backend.data,
                                       backend.mask, self.k_clients,
                                       self.config)
            local_results = [
                EMResult(stacked.gmm[i], stacked.log_likelihood[i],
                         stacked.n_iter[i], stacked.converged[i])
                for i in range(backend.num_clients)]
        else:
            if self.k_candidates is None:
                raise ValueError("need k_clients or k_candidates")
            local_results, _ = train_locals_bic_cfg(
                state["seed_local"], backend.data, backend.mask,
                self.k_candidates, self.config)
        local_gmms = [r.gmm for r in local_results]
        if transform is not None:
            members = np.arange(len(local_gmms))
            local_gmms = [
                transform.finish(transform.apply(
                    tkey, tparams, (g, float(n)), i, members))[0]
                for i, (g, n) in enumerate(zip(local_gmms, backend.sizes))]
        res, synth = aggregate_cfg(state["seed_agg"], local_gmms,
                                   backend.sizes, self.config, self.k_global,
                                   h=self.h, k_candidates=self.k_candidates,
                                   synthetic=self.synthetic)
        return {"res": res, "synth": synth, "local_gmms": local_gmms,
                "local_results": local_results}

    def round_payload(self, backend, state) -> RoundPayload:
        local_gmms = state["local_gmms"]
        uplink = sum(payload_floats(g) + 1 for g in local_gmms)  # +1: |D_c|
        down = payload_floats(state["res"].gmm) * len(local_gmms)
        return RoundPayload(uplink_floats=uplink, downlink_floats=down,
                            itemsize=dtype_itemsize(
                                state["res"].gmm.means.dtype))

    def finalize(self, state, n_rounds, converged,
                 comm: CommStats) -> FedGenResult:
        return FedGenResult(state["res"].gmm, state["local_gmms"],
                            state["synth"], comm, state["local_results"])


def fedgengmm_cfg(seed: int, clients, config: FitConfig,
                  k_clients: Optional[int] = None,
                  k_global: Optional[int] = None,
                  k_candidates: Optional[Sequence[int]] = None,
                  h: int = 100, synthetic: str = "auto",
                  transform=None) -> FedGenResult:
    """Run the full one-shot pipeline (the cfg-core behind
    ``repro_torch.api.FedGenGMM``) on a padded client split or a list of
    per-client :class:`DataSource` streams: fix ``k_clients``, or pass
    ``k_candidates`` for per-client BIC selection; fix ``k_global``, or
    leave it None for server-side BIC selection over ``k_candidates``.
    ``synthetic="auto"`` replays S from a source for source clients and
    holds it resident for a split. ``transform`` releases every client's
    parameter block before the merge (e.g. ``GaussianDP`` with
    ``rounds=1``)."""
    if synthetic == "auto":
        synthetic = "source" if is_source_list(clients) else "resident"
    strategy = FedGenStrategy(
        config=config, k_clients=k_clients, k_global=k_global,
        k_candidates=None if k_candidates is None else tuple(k_candidates),
        h=h, synthetic=synthetic)
    return run_rounds(strategy, clients, seed=seed,
                      device=config.resolve_device(), transform=transform)


def fedgengmm(seed: int, split, k_clients: Optional[int] = None,
              k_global: Optional[int] = None,
              k_candidates: Optional[Sequence[int]] = None, h: int = 100,
              max_iter: int = 200, tol: float = 1e-3,
              reg_covar: float = 1e-6, covariance_type: str = "diag",
              estep_backend: str = "auto", chunk_size: Optional[int] = None,
              synthetic: str = "resident", device="cuda") -> FedGenResult:
    """Legacy keyword surface of :func:`fedgengmm_cfg` (prefer
    ``repro_torch.api.FedGenGMM``): fix ``k_clients``, or pass
    ``k_candidates`` for per-client BIC selection."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return fedgengmm_cfg(seed, split, cfg, k_clients=k_clients,
                         k_global=k_global, k_candidates=k_candidates, h=h,
                         synthetic=synthetic)


def fedgengmm_from_sources(seed: int, sources: Sequence[DataSource],
                           k_clients: Optional[int] = None,
                           k_global: Optional[int] = None,
                           k_candidates: Optional[Sequence[int]] = None,
                           h: int = 100, max_iter: int = 200,
                           tol: float = 1e-3, reg_covar: float = 1e-6,
                           covariance_type: str = "diag",
                           estep_backend: str = "auto",
                           chunk_size: Optional[int] = None,
                           synthetic: str = "source",
                           device="cuda") -> FedGenResult:
    """Deprecated: ``repro_torch.api.FedGenGMM(...).run(sources)``
    dispatches on the input type, so the separate ``_from_sources``
    spelling is obsolete. This shim forwards to the facade (the facade's
    bits) and will be removed."""
    warnings.warn(
        "fedgengmm_from_sources is deprecated; use "
        "repro_torch.api.FedGenGMM(k_clients=..., k_global=...).run("
        "sources) — same engine, same bits",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import FedGenGMM  # the facade sits above core
    fed = FedGenGMM(k_clients=k_clients, k_global=k_global,
                    k_candidates=k_candidates, h=h, synthetic=synthetic,
                    config=FitConfig.from_legacy(
                        backend=estep_backend, chunk_size=chunk_size,
                        covariance_type=covariance_type, reg_covar=reg_covar,
                        tol=tol, max_iter=max_iter, device=device))
    return fed.run(list(sources), seed=seed)
