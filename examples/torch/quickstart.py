"""Quickstart: one-shot federated GMM learning (FedGenGMM) through the
port's public estimator API (``repro_torch.api``), the counterpart of
``examples/quickstart.py`` with the same data, split and seeds.

    PYTHONPATH=src python examples/torch/quickstart.py            # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.api import FedGenGMM, GMMEstimator
from repro_torch.core.partition import partition


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")

    # 1. a planted 4-component mixture, 3000 points
    rng = np.random.default_rng(0)
    mus = rng.normal(0, 5, (4, 8)).astype(np.float32)
    y = rng.integers(0, 4, 3000)
    x = (mus[y] + rng.normal(0, 0.6, (3000, 8))).astype(np.float32)

    # 2. heterogeneous split over 10 clients (Dirichlet alpha = 0.2)
    split = partition(rng, x, y, n_clients=10, scheme="dirichlet", alpha=0.2)
    print("client sizes:", split.sizes)

    # 3. the one-shot federated pipeline: local EM -> 1 round -> merge ->
    #    synthetic sample -> global EM. The same runner accepts a list of
    #    per-client DataSources for the out-of-core regime (out_of_core.py).
    result = FedGenGMM(k_clients=4, k_global=4, h=100, seed=0,
                       device=args.device).run(split)
    print(f"communication rounds: {result.comm.rounds}")
    print(f"uplink floats:        {result.comm.uplink_floats} "
          f"(raw data would be {x.size})")

    # 4. compare against the non-federated benchmark
    bench = GMMEstimator(4, seed=1, device=args.device).fit(x)
    ll_fed = float(result.global_gmm.score(
        torch.as_tensor(x, device=args.device)))
    ll_central = float(bench.score(x))
    print(f"federated  avg log-likelihood: {ll_fed:.4f}")
    print(f"central    avg log-likelihood: {ll_central:.4f}")
    return {"client_sizes": [int(s) for s in split.sizes],
            "rounds": int(result.comm.rounds),
            "uplink_floats": int(result.comm.uplink_floats),
            "raw_floats": int(x.size), "ll_federated": ll_fed,
            "ll_central": ll_central}


if __name__ == "__main__":
    main()
