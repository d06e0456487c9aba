"""End-to-end anomaly detection (the paper's §5.8 pipeline) on the
VEHICLE-like dataset: heterogeneous clients, one-shot aggregation, and
AUC-PR evaluation against DEM, the local models and the non-federated
benchmark. The counterpart of ``examples/anomaly_detection.py``: the same
6,000 training rows, Quantity(alpha) splits, seeds and chunk size as the
JAX package's ``benchmarks/common.py`` (``load_quick("vehicle")`` and
``run_methods(ds, alpha, seed=0, chunk_size=1024)``), on the port's
facades.

    PYTHONPATH=src python examples/torch/anomaly_detection.py     # the card
    PYTHONPATH=src python examples/torch/anomaly_detection.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.api import DEM, FedGenGMM, FitConfig, GMMEstimator
from repro_torch.core.config import derive_seed
from repro_torch.core.dem import INIT_SCHEME_NAMES
from repro_torch.core.metrics import (anomaly_scores, auc_pr,
                                      auc_pr_for_model,
                                      average_log_likelihood)
from repro_torch.core.partition import partition
from repro_torch.data import load

N_TRAIN = 6000     # benchmarks/common.py's quick size for "vehicle"
CHUNK = 1024       # streams training AND scoring in O(chunk·K) memory
H = 50


def local_mean_auc(local_gmms, ds, chunk_size) -> float:
    """The local-models baseline: the per-client scores averaged (§5.4)."""
    s_in = np.mean([anomaly_scores(g, ds.x_test_in, chunk_size=chunk_size)
                    for g in local_gmms], axis=0)
    s_out = np.mean([anomaly_scores(g, ds.x_test_ood, chunk_size=chunk_size)
                     for g in local_gmms], axis=0)
    scores = np.concatenate([s_in, s_out])
    labels = np.concatenate([np.zeros(len(s_in)), np.ones(len(s_out))])
    return auc_pr(scores, labels)


def run_methods(ds, alpha, seed, chunk_size, device) -> dict:
    """{method: {loglik, auc_pr, rounds}} for FedGenGMM, the local models,
    DEM with each of its three inits and the central fit, on one
    Quantity(alpha) split of ``ds``."""
    k = ds.k_global
    split = partition(np.random.default_rng(seed), ds.x_train, ds.y_train,
                      ds.n_clients, ds.scheme, alpha)
    x = torch.as_tensor(ds.x_train, device=device)
    cfg = FitConfig.from_legacy(chunk_size=chunk_size, device=device)

    def loglik(gmm):
        return average_log_likelihood(gmm, x, chunk_size=chunk_size)

    def auc(gmm):
        return auc_pr_for_model(gmm, ds.x_test_in, ds.x_test_ood,
                                chunk_size=chunk_size)

    out = {}
    fr = FedGenGMM(k_clients=k, k_global=k, h=H, synthetic="resident",
                   config=cfg).run(split, seed=derive_seed(seed, 0))
    out["fedgen"] = {"loglik": loglik(fr.global_gmm),
                     "auc_pr": auc(fr.global_gmm),
                     "rounds": int(fr.comm.rounds)}
    out["local"] = {"loglik": float(np.mean([loglik(g)
                                             for g in fr.local_gmms])),
                    "auc_pr": local_mean_auc(fr.local_gmms, ds, chunk_size),
                    "rounds": 0}
    for init in (1, 2, 3):
        dr = DEM(k, config=cfg.replace(init=INIT_SCHEME_NAMES[init])).run(
            split, seed=derive_seed(seed, 10 + init))
        out[f"dem{init}"] = {"loglik": loglik(dr.global_gmm),
                             "auc_pr": auc(dr.global_gmm),
                             "rounds": int(dr.n_rounds)}
    central = GMMEstimator(k, config=cfg).fit(
        x, seed=derive_seed(seed, 99)).gmm_
    out["central"] = {"loglik": loglik(central), "auc_pr": auc(central),
                      "rounds": 0}
    return out


def main(argv=None) -> dict:
    """Run the example; return {alpha: {method: numbers}} as printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("anomaly_detection.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    ds = load("vehicle", np.random.default_rng(0), n_train=N_TRAIN)
    print(f"dataset: {ds.name}  train={ds.x_train.shape}  "
          f"anomaly_ratio={ds.anomaly_ratio}")
    out = {}
    for alpha in (1, 2):
        print(f"\n== Quantity(alpha={alpha}) heterogeneity ==")
        res = run_methods(ds, alpha, seed=0, chunk_size=CHUNK,
                          device=args.device)
        for method, r in res.items():
            print(f"  {method:8s} AUC-PR={r['auc_pr']:.3f} "
                  f"loglik={r['loglik']:8.3f} rounds={r['rounds']:>3}")
        out[str(alpha)] = res
    return out


if __name__ == "__main__":
    main()
