"""Federation runtime of the port: the communication ledger, cohort
sampling, straggler and staleness policies, the uplink-transform seam (DP
noise, stochastic quantization, pairwise secure-aggregation masks), the
round loop (one-shot and iterative) over resident, source or mesh-sharded
clients, and the buffered asynchronous driver with its client executor.
The iterative baselines FedEM and FedKMeans are strategies in
``repro_torch.fed.strategies``; DEM sits beside its numerics in
``repro_torch.core.dem``.

``strategies`` loads lazily: it imports ``repro_torch.core.dem``, which
imports this package's runtime, so loading it here would close a cycle."""
from repro_torch.fed.async_runtime import (AsyncPolicy, ClientExecutor,
                                           run_async)
from repro_torch.fed.cohort import (ArrivalStragglers, CyclicSampler,
                                    PolynomialStaleness, UniformSampler,
                                    make_sampler)
from repro_torch.fed.ledger import (CommStats, RoundPayload, dtype_itemsize,
                                    gmm_payload_floats, label_payload_floats,
                                    payload_floats, stats_payload_floats)
from repro_torch.fed.runtime import (FederationStrategy, ShardedClients,
                                     SourceClients, SplitClients,
                                     make_backend, run_rounds)
from repro_torch.fed.transforms import (Compose, GaussianDP, Identity,
                                        PairwiseMask, PayloadTransform,
                                        StochasticQuantize)

_LAZY = {name: "repro_torch.fed.strategies" for name in (
    "FedEMStrategy", "FedKMeansStrategy", "FedEMResult", "FedKMeansResult",
    "fedem_cfg", "fed_kmeans_cfg")}

__all__ = [
    "AsyncPolicy", "ClientExecutor", "run_async",
    "ArrivalStragglers", "CyclicSampler", "PolynomialStaleness",
    "UniformSampler", "make_sampler",
    "CommStats", "RoundPayload", "dtype_itemsize", "gmm_payload_floats",
    "label_payload_floats", "payload_floats", "stats_payload_floats",
    "FederationStrategy", "SplitClients", "SourceClients", "ShardedClients",
    "make_backend",
    "run_rounds",
    "PayloadTransform", "Identity", "GaussianDP", "StochasticQuantize",
    "PairwiseMask", "Compose",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'repro_torch.fed' has no attribute {name!r}")
