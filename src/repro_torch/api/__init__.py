"""repro_torch.api — the port's public estimator surface (main path).

    from repro_torch.api import FedGenGMM, GMMEstimator

    fed = FedGenGMM(k_clients=30, k_global=30, h=50).run(split)  # on cuda
    est = GMMEstimator(30, device="cpu").fit(x)
"""
from repro_torch.core.config import FitConfig
from repro_torch.api.estimators import (FedGenGMM, GMMEstimator, bic,
                                        log_prob, score)

__all__ = ["FitConfig", "GMMEstimator", "FedGenGMM", "score", "log_prob",
           "bic"]
