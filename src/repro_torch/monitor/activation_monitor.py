"""FedGenGMM activation monitor: the paper's technique attached to a served
transformer (port of ``repro/monitor/activation_monitor.py``).

Hidden-state distributions of a served model are an unsupervised anomaly
signal. Every serving shard is a "client": it fits a local GMM over pooled
hidden states of the traffic it saw, and the global monitor is aggregated
with the one-shot FedGenGMM round. Out-of-distribution inputs then score
low under the global GMM.

Features are the final hidden states mean-pooled over every position after
the vision prefix (left pads included, as in the reference; an
encoder-decoder's decoder cross-attends to its batch's ``src_embeds``),
projected to a small fixed random basis shared by all clients. The local
fits run the port's ``fit_gmm``, the server step its ``aggregate``, and
scoring its ``log_prob_chunked``: on the card, the ``kmeans_sweep_stats``,
``estep_stats`` and ``gmm_log_prob`` kernels.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.config import make_generator, resolve_device
from repro_torch.core.em import fit_gmm, log_prob_chunked
from repro_torch.core.fedgen import aggregate
from repro_torch.core.gmm import GMM
from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            _backbone, _encode, _with_prefix)

FEATURE_DIM = 32


class MonitorConfig(NamedTuple):
    feature_dim: int = FEATURE_DIM
    k_local: int = 4
    k_global: int = 8
    h: int = 100
    seed: int = 0


def feature_projection(cfg: ModelConfig, mcfg: MonitorConfig,
                       device="cuda") -> torch.Tensor:
    """Fixed random projection (d_model -> feature_dim), identical on every
    client: drawn on the CPU from the shared seed, then moved to
    ``device``."""
    gen = make_generator(mcfg.seed, "cpu")
    proj = torch.randn((cfg.d_model, mcfg.feature_dim), generator=gen,
                       dtype=torch.float32) / math.sqrt(cfg.d_model)
    return proj.to(resolve_device(device))


def extract_features(params: Transformer, cfg: ModelConfig, batch: dict,
                     proj: torch.Tensor) -> torch.Tensor:
    """Mean-pooled final hidden states -> (B, feature_dim) float32."""
    x, offset = _with_prefix(params, cfg, batch)
    enc_x = _encode(params, cfg, batch)
    positions = torch.arange(x.shape[1], dtype=torch.float32,
                             device=x.device)
    h, _, _ = _backbone(params, cfg, x, positions, enc_x)
    pooled = torch.mean(h[:, offset:].to(torch.float32), dim=1)
    return pooled @ proj


class FedGMMMonitor:
    """One-shot federated anomaly monitor over serving shards, on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, mcfg: MonitorConfig = MonitorConfig(),
                 device="cuda"):
        self.cfg = cfg
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.proj = feature_projection(cfg, mcfg, self.device)
        self._client_feats: dict[int, list[torch.Tensor]] = {}
        self.global_gmm: Optional[GMM] = None

    # -- client side ----------------------------------------------------
    def observe(self, client_id: int, params: Transformer, batch: dict):
        f = extract_features(params, self.cfg, batch, self.proj)
        self._client_feats.setdefault(client_id, []).append(f)

    def local_models(self) -> tuple[list[GMM], list[int]]:
        gmms, sizes = [], []
        for cid, feats in sorted(self._client_feats.items()):
            x = torch.cat(feats)
            res = fit_gmm(1000 + cid, x, self.mcfg.k_local,
                          device=self.device)
            gmms.append(res.gmm)
            sizes.append(len(x))
        return gmms, sizes

    # -- the one-shot round ---------------------------------------------
    def aggregate(self) -> GMM:
        gmms, sizes = self.local_models()
        res, _ = aggregate(self.mcfg.seed, gmms, sizes, h=self.mcfg.h,
                           k_global=self.mcfg.k_global, device=self.device)
        self.global_gmm = res.gmm
        return res.gmm

    # -- serving side ----------------------------------------------------
    def score(self, params: Transformer, batch: dict) -> np.ndarray:
        """Anomaly scores (higher = more anomalous) for a serving batch."""
        if self.global_gmm is None:
            raise RuntimeError("call aggregate() first")
        f = extract_features(params, self.cfg, batch, self.proj)
        lp = log_prob_chunked(self.global_gmm, f, chunk_size=None)
        return -lp.cpu().numpy()
