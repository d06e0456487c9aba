"""repro_torch.api — the port's public estimator surface.

    from repro_torch.api import DEM, FedGenGMM, GMMEstimator

    fed = FedGenGMM(k_clients=30, k_global=30, h=50).run(split)  # on cuda
    bic = FedGenGMM(k_candidates=(10, 20, 30), k_global=30).run(split)
    dem = DEM(30, init="separated").run(split)
    dp = FedGenGMM(k_clients=30, k_global=30, dp=DPConfig(epsilon=1.0))
    est = GMMEstimator(k_candidates=(2, 3, 4), device="cpu").fit(x)
    scorer = Scorer.from_checkpoint("runs/models", "anomaly")  # serving

Every name here is also a name of ``repro.api``.
"""
from repro_torch.core.config import DEFAULT_SOURCE_CHUNK, FitConfig
from repro_torch.core.privacy import DPConfig
from repro_torch.api.estimators import (DEM, FedEM, FedGenGMM, FedKMeans,
                                        GMMEstimator, KMeansEstimator, bic,
                                        fit_federated, log_prob, score)
from repro_torch.api.serving import Scorer

__all__ = ["FitConfig", "DPConfig", "GMMEstimator", "KMeansEstimator", "FedGenGMM",
           "DEM", "FedEM", "FedKMeans", "fit_federated", "score",
           "log_prob", "bic", "Scorer", "DEFAULT_SOURCE_CHUNK"]
