"""Federation runtime of the port: the communication ledger, cohort
sampling and straggler policies, and the round loop (one-shot and
iterative). The iterative baselines FedEM and FedKMeans are strategies in
``repro_torch.fed.strategies``; DEM sits beside its numerics in
``repro_torch.core.dem``."""
from repro_torch.fed.cohort import (ArrivalStragglers, CyclicSampler,
                                    UniformSampler, make_sampler)
from repro_torch.fed.ledger import (CommStats, RoundPayload,
                                    gmm_payload_floats, label_payload_floats,
                                    payload_floats, stats_payload_floats)
from repro_torch.fed.runtime import (FederationStrategy, SplitClients,
                                     make_backend, run_rounds)

__all__ = ["ArrivalStragglers", "CyclicSampler", "UniformSampler",
           "make_sampler", "CommStats", "RoundPayload", "gmm_payload_floats",
           "label_payload_floats", "payload_floats", "stats_payload_floats",
           "FederationStrategy", "SplitClients", "make_backend",
           "run_rounds"]
