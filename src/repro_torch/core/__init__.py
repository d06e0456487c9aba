"""FedGenGMM core of the port: GMM primitives, EM, k-means, one-shot
federated aggregation, the distributed-EM baseline, and the DP, continual
and split-merge extensions.

The supported public surface is ``repro_torch.api``; the entry points
exported here are the internal and legacy keyword spellings the facades
run on, the names of ``repro.core.__all__``. Three of those names stay
bound to this package's submodules: ``kmeans``, ``dem`` and ``partition``
(the functions are ``kmeans.kmeans``, ``dem.dem`` and
``partition.partition``). In the JAX package the functions shadow the
submodules, so ``from repro.core import kmeans`` gives a function there and
a module here.
"""
from repro_torch.core.config import DEFAULT_SOURCE_CHUNK, FitConfig
from repro_torch.core.gmm import GMM, merge_gmms, merge_gmms_stacked
from repro_torch.core.partition import (ClientSplit, partition_dirichlet,
                                        partition_quantity)
from repro_torch.core import metrics, partition

# Loaded at first use (PEP 562): ``repro_torch.data.sources`` and
# ``repro_torch.fed`` import ``core.config`` and ``core.em``, and the modules
# below import them back, so loading these here would close a cycle.
_LAZY = {
    **{name: "repro_torch.core.em" for name in (
        "EMResult", "SufficientStats", "bic_streaming", "e_step_stats",
        "e_step_stats_chunked", "em_step", "fit_gmm", "fit_gmm_bic",
        "fit_gmm_bic_cfg", "fit_gmm_cfg", "fit_gmm_streaming",
        "init_from_kmeans", "init_from_means", "label_stats",
        "log_prob_chunked", "m_step", "reduce_rows", "resolve_backend",
        "resolve_estep_backend", "resolve_source_chunk", "score_streaming",
        "streaming_map_reduce", "streaming_reduce")},
    **{name: "repro_torch.core.kmeans" for name in (
        "KMeansResult", "federated_kmeans", "federated_kmeans_from_sources",
        "kmeans_fit_cfg", "kmeans_multi", "kmeans_multi_source",
        "kmeans_plusplus_streaming", "kmeans_source")},
    **{name: "repro_torch.core.fedgen" for name in (
        "CommStats", "FedGenResult", "aggregate", "aggregate_cfg",
        "fedgengmm", "fedgengmm_cfg", "fedgengmm_from_sources",
        "payload_floats", "train_locals", "train_locals_bic",
        "train_locals_from_sources", "train_locals_sources_cfg")},
    **{name: "repro_torch.core.dem" for name in (
        "DEMResult", "dem_cfg", "dem_from_sources")},
    **{name: "repro_torch.core.privacy" for name in (
        "DPConfig", "privatize_clients", "privatize_gmm")},
    **{name: "repro_torch.core.continual" for name in (
        "ContinualState", "continual_round", "init_state")},
    "split_merge_fit": "repro_torch.core.splitmerge",
}

__all__ = [
    "FitConfig", "DEFAULT_SOURCE_CHUNK",
    "GMM", "merge_gmms", "merge_gmms_stacked",
    "ClientSplit", "partition_dirichlet", "partition_quantity", "metrics",
    *_LAZY,
]


def __getattr__(name: str):
    import importlib
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name in ("dem", "kmeans"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
