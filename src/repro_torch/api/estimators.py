"""Estimator facades of the port (port of ``repro/api/estimators.py``,
main-path part): :class:`GMMEstimator`, :class:`FedGenGMM` and the scorers
``score`` / ``log_prob`` / ``bic``.

Each facade holds one validated :class:`FitConfig`, whose ``device``
(default ``"cuda"``) says where it runs; data arrive as numpy arrays or
tensors and are moved there. Seeds replace the JAX package's keys: an
explicit ``seed=`` wins, else the config's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.config import FitConfig
from repro_torch.core.em import (EMResult, bic_streaming, fit_gmm_cfg,
                                 log_prob_chunked, score_streaming)
from repro_torch.core.fedgen import FedGenResult, fedgengmm_cfg
from repro_torch.core.gmm import GMM


def _make_config(config: Optional[FitConfig], overrides: dict) -> FitConfig:
    """An explicit ``FitConfig``, field overrides on top of it (or of the
    defaults), or both."""
    cfg = config if config is not None else FitConfig()
    if not isinstance(cfg, FitConfig):
        raise TypeError(f"config must be a FitConfig, "
                        f"got {type(cfg).__name__}")
    if overrides:
        valid = {f.name for f in dataclasses.fields(FitConfig)}
        unknown = set(overrides) - valid
        if unknown:
            raise TypeError(f"unknown FitConfig field(s) {sorted(unknown)}; "
                            f"valid fields: {sorted(valid)}")
        cfg = cfg.replace(**overrides)
    return cfg


def _as_int(value, name: str, minimum: int = 1) -> int:
    if isinstance(value, bool) or int(value) != value:
        raise ValueError(f"{name} must be an integer, got {value!r}")
    if int(value) < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return int(value)


def _placed(gmm: GMM, data, sample_weight, cfg: FitConfig):
    device = cfg.resolve_device()
    x = torch.as_tensor(data, device=device).to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"expected (N, d) rows, got shape {tuple(x.shape)}")
    w = (None if sample_weight is None else
         torch.as_tensor(sample_weight, device=device).to(torch.float32))
    return gmm.to(device), x, w


# ----------------------------------------------------------------------
# Model-level scoring
# ----------------------------------------------------------------------

def score(gmm: GMM, data, sample_weight=None,
          config: Optional[FitConfig] = None) -> torch.Tensor:
    """Average log-likelihood of ``data`` under ``gmm`` (the paper's
    fitness score, Eq. 2), chunked per the config."""
    cfg = config if config is not None else FitConfig()
    gmm, x, w = _placed(gmm, data, sample_weight, cfg)
    return score_streaming(gmm, x, w, chunk_size=cfg.resolve_chunk(),
                           backend=cfg.backend)


def log_prob(gmm: GMM, data,
             config: Optional[FitConfig] = None) -> torch.Tensor:
    """Per-row mixture log density -> (N,) (the anomaly scorer)."""
    cfg = config if config is not None else FitConfig()
    gmm, x, _ = _placed(gmm, data, None, cfg)
    return log_prob_chunked(gmm, x, chunk_size=cfg.resolve_chunk(),
                            backend=cfg.backend)


def bic(gmm: GMM, data, sample_weight=None,
        config: Optional[FitConfig] = None) -> torch.Tensor:
    """Bayesian Information Criterion (lower is better), chunked per the
    config."""
    cfg = config if config is not None else FitConfig()
    gmm, x, w = _placed(gmm, data, sample_weight, cfg)
    return bic_streaming(gmm, x, w, chunk_size=cfg.resolve_chunk(),
                         backend=cfg.backend)


# ----------------------------------------------------------------------

class GMMEstimator:
    """EM-trained Gaussian mixture (the paper's TrainGMM, fixed K).

        est = GMMEstimator(k=8).fit(x)     # on the card
        est.score(x_test)
    """

    def __init__(self, k: int, *, config: Optional[FitConfig] = None,
                 **overrides):
        self.k = _as_int(k, "k")
        self.config = _make_config(config, overrides)
        self.gmm_: Optional[GMM] = None
        self.result_: Optional[EMResult] = None

    def fit(self, data, *, sample_weight=None,
            init_gmm: Optional[GMM] = None,
            seed: Optional[int] = None) -> "GMMEstimator":
        """Fit on an (N, d) array. ``init_gmm`` warm-starts EM; ``seed``
        overrides the config's. Returns ``self``."""
        seed = self.config.seed if seed is None else seed
        self.result_ = fit_gmm_cfg(seed, data, self.k, self.config,
                                   sample_weight, init_gmm)
        self.gmm_ = self.result_.gmm
        return self

    def _fitted(self) -> GMM:
        if self.gmm_ is None:
            raise RuntimeError("estimator is not fitted; call fit() first")
        return self.gmm_

    def score(self, data, sample_weight=None) -> torch.Tensor:
        return score(self._fitted(), data, sample_weight, self.config)

    def log_prob(self, data) -> torch.Tensor:
        return log_prob(self._fitted(), data, self.config)

    def bic(self, data, sample_weight=None) -> torch.Tensor:
        return bic(self._fitted(), data, sample_weight, self.config)


class FedGenGMM:
    """The paper's one-shot federated pipeline (Algorithm 4.1) over a padded
    client split: local EM per client, ONE round of (K, 2d+1) parameter
    blocks, server-side merge -> synthetic replay -> global refit."""

    def __init__(self, *, k_clients: int, k_global: int, h: int = 100,
                 config: Optional[FitConfig] = None, **overrides):
        self.k_clients = _as_int(k_clients, "k_clients")
        self.k_global = _as_int(k_global, "k_global")
        self.h = _as_int(h, "h")
        self.config = _make_config(config, overrides)
        self.result_: Optional[FedGenResult] = None

    def run(self, clients, *, seed: Optional[int] = None) -> FedGenResult:
        """Run over a ``ClientSplit`` (numpy, from either package's
        ``partition``) or :class:`SplitClients`."""
        seed = self.config.seed if seed is None else seed
        self.result_ = fedgengmm_cfg(seed, clients, self.config,
                                     self.k_clients, self.k_global, self.h)
        return self.result_

    @property
    def global_gmm_(self) -> GMM:
        if self.result_ is None:
            raise RuntimeError("runner has no result; call run() first")
        return self.result_.global_gmm
