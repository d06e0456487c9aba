"""Split-merge EM refinement, an alternative local trainer (port of
``repro/core/splitmerge.py``; beyond the paper).

The paper (§4.1) says FedGenGMM makes it "fairly straightforward to
replace the standard EM algorithm with another method to train local
GMMs" (citing split-merge EM, Li & Li '09). After a standard EM fit the
weakest component (lowest weight) is merged into its nearest neighbour and
the strongest high-variance component is split along its widest axis; EM
then refines. The candidate is kept only if it raises the average
log-likelihood, so the refinement never makes the fit worse.

The component picks stay on the device: slots are one-element index
tensors and the edits are indexed writes on clones, so a round reads one
host float (the candidate's log-likelihood). Diagonal covariance.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import derive_seed
from repro_torch.core.em import EMResult, fit_gmm
from repro_torch.core.gmm import GMM


def _put(t: torch.Tensor, slot: torch.Tensor, value: torch.Tensor):
    """``t`` with row ``slot`` (a one-element index tensor) set to
    ``value``, on a clone."""
    return t.clone().index_copy_(0, slot, value.reshape((1,) + t.shape[1:]))


def _merge_weakest(gmm: GMM) -> tuple[GMM, torch.Tensor]:
    """Merge the lowest-weight component into its nearest neighbour
    (moment-preserving), leaving the weak component's slot to be
    overwritten by the split; returns the model and that slot."""
    wk = torch.argmin(gmm.weights).reshape(1)
    mu_wk = gmm.means.index_select(0, wk)[0]
    d2 = torch.sum((gmm.means - mu_wk) ** 2, dim=1)
    d2 = d2.index_fill(0, wk, float("inf"))
    nb = torch.argmin(d2).reshape(1)
    w_wk, w_nb = gmm.weights[wk][0], gmm.weights[nb][0]
    mu_nb = gmm.means.index_select(0, nb)[0]
    cov_wk = gmm.covs.index_select(0, wk)[0]
    cov_nb = gmm.covs.index_select(0, nb)[0]
    w_sum = w_wk + w_nb
    a = w_wk / torch.clamp(w_sum, min=1e-12)
    mu = a * mu_wk + (1 - a) * mu_nb
    var = (a * (cov_wk + mu_wk ** 2)
           + (1 - a) * (cov_nb + mu_nb ** 2)) - mu ** 2
    return GMM(_put(gmm.weights, nb, w_sum), _put(gmm.means, nb, mu),
               _put(gmm.covs, nb, torch.clamp(var, min=1e-6))), wk


def _split_strongest(gmm: GMM, slot: torch.Tensor) -> GMM:
    """Split the component of largest weighted total variance (``slot``
    aside) along its widest axis, writing one half into ``slot``."""
    score = (gmm.weights * torch.sum(gmm.covs, dim=1)).index_fill(
        0, slot, float("-inf"))
    sp = torch.argmax(score).reshape(1)
    cov_sp = gmm.covs.index_select(0, sp)[0]
    mu_sp = gmm.means.index_select(0, sp)[0]
    axis = torch.argmax(cov_sp).reshape(1)
    offset = torch.zeros_like(mu_sp).index_copy_(
        0, axis, torch.sqrt(cov_sp.index_select(0, axis)))
    w_half = gmm.weights[sp][0] / 2.0
    return GMM(_put(_put(gmm.weights, sp, w_half), slot, w_half),
               _put(_put(gmm.means, sp, mu_sp - offset), slot,
                    mu_sp + offset),
               _put(gmm.covs, slot, cov_sp))


def split_merge_fit(seed: int, x, k: int, sample_weight=None,
                    n_rounds: int = 2, max_iter: int = 200,
                    tol: float = 1e-3, reg_covar: float = 1e-6,
                    device="cuda") -> EMResult:
    """``fit_gmm``, then ``n_rounds`` accept-if-better split-merge rounds,
    each an EM fit from the merged-and-split proposal (round r seeded
    ``derive_seed(seed, r + 1)``)."""
    kw = dict(max_iter=max_iter, tol=tol, reg_covar=reg_covar,
              device=device)
    best = fit_gmm(seed, x, k, sample_weight, **kw)
    if k < 3:
        return best
    best_ll = float(best.log_likelihood)
    for r in range(n_rounds):
        merged, slot = _merge_weakest(best.gmm)
        cand = fit_gmm(derive_seed(seed, r + 1), x, k, sample_weight,
                       init_gmm=_split_strongest(merged, slot), **kw)
        cand_ll = float(cand.log_likelihood)
        if cand_ll > best_ll + 1e-6:
            best, best_ll = cand, cand_ll
    return best
