"""Continual one-shot federated learning (the paper's stated future work):
windows of drifting client data, one communication round per window,
server-side memory controls the stability/plasticity trade-off. The
counterpart of ``examples/continual_fl.py`` with the same windows and
splits.

    PYTHONPATH=src python examples/torch/continual_fl.py          # the card
    PYTHONPATH=src python examples/torch/continual_fl.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.continual import continual_round, init_state
from repro_torch.core.partition import partition

rng = np.random.default_rng(0)
mus = rng.normal(0, 6, (4, 4)).astype(np.float32)
SCHEDULE = [[0, 1], [0, 1], [2, 3], [2, 3]]  # drift at window 3
MEMORIES = (0.0, 0.6)


def window(active, n=900, seed=0):
    """``n`` rows drawn from the ``active`` modes, and their labels."""
    r = np.random.default_rng(seed)
    y = r.choice(active, size=n)
    x = (mus[y] + r.normal(0, 0.5, (n, 4))).astype(np.float32)
    return x, y.astype(np.int64)


def eval_on(gmm, active, seed=99):
    """Average log-likelihood of 1,500 fresh rows of the ``active`` modes."""
    x, _ = window(active, 1500, seed)
    return float(gmm.score(torch.as_tensor(x, device=gmm.device)))


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed, by memory."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("continual_fl.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    out = {}
    for memory in MEMORIES:
        state = init_state()
        rows = []
        print(f"\n== memory={memory} ==")
        for t, active in enumerate(SCHEDULE):
            x, y = window(active, seed=t)
            split = partition(np.random.default_rng(t), x, y, 4, "dirichlet",
                              1.0)
            state = continual_round(
                t, state, torch.as_tensor(split.data, device=args.device),
                torch.as_tensor(split.mask, device=args.device), split.sizes,
                k_clients=2, k_global=4, h=60, memory=memory,
                device=args.device)
            row = {"ll_old": eval_on(state.global_gmm, [0, 1]),
                   "ll_new": eval_on(state.global_gmm, [2, 3]),
                   "rounds_total": int(state.rounds_total)}
            rows.append(row)
            print(f"window {t} (modes {active}): "
                  f"ll_old={row['ll_old']:7.2f}  "
                  f"ll_new={row['ll_new']:7.2f}  "
                  f"rounds_total={row['rounds_total']}")
        out[str(memory)] = rows
    print("\nmemory=0 forgets the old modes after drift; memory=0.6 retains "
          "them — still one round per window.")
    return out


if __name__ == "__main__":
    main()
