"""FedGenGMM (Algorithm 4.1): one-shot federated GMM learning (port of
``repro/core/fedgen.py``, resident split arm).

Pipeline:
  1. local EM per client, all clients as one stacked batch over the padded
     (C, N, d) split with its 0/1 row mask,
  2. a single communication round: clients ship (w, mu, Sigma, |D_c|),
  3. server merge: re-weight by |D_c|/|D|, concatenate, normalize,
  4. the server samples |S| = H * sum_c K_c synthetic rows from the merged
     mixture and trains the global GMM on S.

Per-client BIC selection and out-of-core clients come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.config import FitConfig, derive_seed, make_generator
from repro_torch.core.em import EMResult, fit_gmm_cfg
from repro_torch.core.gmm import GMM, merge_gmms
from repro_torch.fed.ledger import (CommStats, RoundPayload, dtype_itemsize,
                                    payload_floats)
from repro_torch.fed.runtime import run_rounds


class FedGenResult(NamedTuple):
    global_gmm: GMM
    local_gmms: list[GMM]
    synthetic: torch.Tensor    # the server-side dataset S, (|S|, d)
    comm: CommStats
    local_results: list[EMResult]


def train_locals_cfg(seed: int, data: torch.Tensor, mask: torch.Tensor,
                     k: int, config: FitConfig) -> EMResult:
    """Local EM of every client at once, fixed K_c = k: data (C, N, d)
    padded, mask (C, N). Client c draws from ``derive_seed(seed, c)``.
    Returns the stacked :class:`EMResult` (leaves with leading dim C)."""
    return fit_gmm_cfg(seed, data, k, config, sample_weight=mask)


def aggregate_cfg(seed: int, local_gmms: list[GMM], sizes,
                  config: FitConfig, k_global: int,
                  h: int = 100) -> tuple[EMResult, torch.Tensor]:
    """Algorithm 4.1 lines 21-31: merge, sample S, train the global model
    of ``k_global`` components on S (held on the device)."""
    merged = merge_gmms(local_gmms, sizes)
    n_synth = h * sum(g.n_components for g in local_gmms)
    gen = make_generator(derive_seed(seed, "sample"), merged.device)
    s = merged.sample(gen, n_synth)
    res = fit_gmm_cfg(derive_seed(seed, "fit"), s, k_global, config)
    return res, s


@dataclasses.dataclass(frozen=True)
class FedGenStrategy:
    """Algorithm 4.1 as a one-shot strategy of the federation runtime: the
    single round trains every client locally, then merges, samples and
    refits on the server. Uplink is each client's (K, 2d+1) parameter block
    + |D_c|, downlink the global broadcast, one round by construction."""

    config: FitConfig
    k_clients: int
    k_global: int
    h: int = 100

    one_shot = True
    name = "fedgen"

    def init_state(self, seed: int, backend) -> dict:
        return {"seed_local": derive_seed(seed, "local"),
                "seed_agg": derive_seed(seed, "aggregate")}

    def run_once(self, state: dict, backend) -> dict:
        stacked = train_locals_cfg(state["seed_local"], backend.data,
                                   backend.mask, self.k_clients, self.config)
        local_gmms = [stacked.gmm[i] for i in range(backend.num_clients)]
        local_results = [
            EMResult(g, stacked.log_likelihood[i], stacked.n_iter[i],
                     stacked.converged[i]) for i, g in enumerate(local_gmms)]
        res, synth = aggregate_cfg(state["seed_agg"], local_gmms,
                                   backend.sizes, self.config, self.k_global,
                                   h=self.h)
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


def fedgengmm_cfg(seed: int, clients, config: FitConfig, k_clients: int,
                  k_global: int, h: int = 100) -> FedGenResult:
    """Run the full one-shot pipeline on a padded client split (the
    cfg-core behind ``repro_torch.api.FedGenGMM``)."""
    strategy = FedGenStrategy(config=config, k_clients=k_clients,
                              k_global=k_global, h=h)
    return run_rounds(strategy, clients, seed=seed,
                      device=config.resolve_device())
