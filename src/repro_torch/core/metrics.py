"""Evaluation metrics: average log-likelihood (Eq. 2) and AUC-PR for the
anomaly-detection experiments (§5.8); port of ``repro/core/metrics.py``
(the AUC-PR code is copied as it is)."""
from __future__ import annotations

import numpy as np


def _rows(gmm, x):
    """``x`` (numpy or tensor) as float32 rows on the model's device."""
    import torch
    return torch.as_tensor(x, device=gmm.means.device).to(torch.float32)


def average_log_likelihood(gmm, x, chunk_size=None) -> float:
    """The paper's fitness score gamma_G (Eq. 2). ``chunk_size`` scores in
    O(chunk·K) memory via the streaming engine; the engine owns the
    None → full-batch dispatch."""
    from repro_torch.core.em import score_streaming
    return float(score_streaming(gmm, _rows(gmm, x), chunk_size=chunk_size))


def precision_recall_curve(scores: np.ndarray, labels: np.ndarray):
    """PR curve for anomaly scores (higher score = more anomalous).

    labels: 1 = anomaly (positive class), 0 = inlier.
    Returns (precision, recall, thresholds) sklearn-compatible.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels).astype(np.int64)
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]
    distinct = np.r_[np.flatnonzero(np.diff(scores)), len(scores) - 1]
    tp = np.cumsum(labels)[distinct]
    fp = (distinct + 1) - tp
    total_pos = labels.sum()
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / max(total_pos, 1)
    # prepend the (recall=0, precision=1) point
    precision = np.r_[1.0, precision]
    recall = np.r_[0.0, recall]
    return precision, recall, scores[distinct]


def auc_pr(scores: np.ndarray, labels: np.ndarray) -> float:
    """Average precision (step-wise integral of the PR curve)."""
    precision, recall, _ = precision_recall_curve(scores, labels)
    return float(np.sum(np.diff(recall) * precision[1:]))


def anomaly_scores(gmm, x, chunk_size=None) -> np.ndarray:
    """Point-wise anomaly score = negative log-likelihood under the model.

    ``chunk_size`` computes the log density in fixed-size row chunks
    (O(chunk·K) peak memory) — the edge-client scoring mode; the engine
    owns the None → full-batch dispatch."""
    from repro_torch.core.em import log_prob_chunked
    return -log_prob_chunked(gmm, _rows(gmm, x),
                             chunk_size=chunk_size).cpu().numpy()


def auc_pr_for_model(gmm, x_inlier, x_ood, chunk_size=None) -> float:
    import numpy as np
    s_in = anomaly_scores(gmm, x_inlier, chunk_size=chunk_size)
    s_out = anomaly_scores(gmm, x_ood, chunk_size=chunk_size)
    scores = np.concatenate([s_in, s_out])
    labels = np.concatenate([np.zeros(len(s_in)), np.ones(len(s_out))])
    return auc_pr(scores, labels)
