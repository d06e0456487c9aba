"""Where each method of the anomaly-detection example lands, over 12 seeds,
on the CPU: the JAX package's ``examples/anomaly_detection.py`` (through
``benchmarks.common.run_methods``) and the port's
``examples/torch/anomaly_detection.py``, on the split of seed 0 with the
method seeds of seeds 0-11, at alpha 1 and 2. EM on this data lands in one
of a few optima, so the port's example is held to the reference's optima
(``chip_smoke.ANOMALY_OPTIMA``), not to one value.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/anomaly_optima.py jax
    PYTHONPATH=src python tools/anomaly_optima.py torch

Prints one line a run, then each method's log-likelihoods grouped into
optima (values less than 0.03 apart), their range and its AUC-PR range
at each alpha, and its rounds.
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEEDS = range(12)


def runs_jax():
    """{(alpha, method): [(auc_pr, loglik, rounds)]} of the JAX package."""
    import jax
    import benchmarks.common as common
    ds = common.load_quick("vehicle")
    key = jax.random.key
    for s in SEEDS:
        # run_methods seeds both the split and the keys with ``seed``: keep
        # the split of 0 and take the keys of s
        common.jax.random.key = lambda _seed, _s=s: key(_s)
        try:
            for alpha in (1, 2):
                yield s, alpha, common.run_methods(ds, alpha, seed=0,
                                                   chunk_size=1024)
        finally:
            common.jax.random.key = key


def runs_torch():
    """The same of the port, on the CPU."""
    from repro_torch.core.config import derive_seed
    from repro_torch.data import load
    spec = importlib.util.spec_from_file_location(
        "anomaly_detection", ROOT / "examples/torch/anomaly_detection.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    ds = load("vehicle", np.random.default_rng(0), n_train=ex.N_TRAIN)
    for s in SEEDS:
        ex.derive_seed = lambda _seed, *path, _s=s: derive_seed(_s, *path)
        for alpha in (1, 2):
            yield s, alpha, ex.run_methods(ds, alpha, seed=0,
                                           chunk_size=ex.CHUNK, device="cpu")


def optima(values, gap=0.03):
    """Sorted values grouped where neighbours are less than ``gap`` apart,
    as (lowest, highest, count)."""
    groups = []
    for v in sorted(values):
        if groups and v - groups[-1][-1] < gap:
            groups[-1].append(v)
        else:
            groups.append([v])
    return [(g[0], g[-1], len(g)) for g in groups]


def main(argv=None) -> dict:
    which = (argv or sys.argv[1:] or ["torch"])[0]
    runs = runs_jax() if which == "jax" else runs_torch()
    table: dict = {}
    for s, alpha, res in runs:
        print(s, alpha, {m: (round(float(r["auc_pr"]), 4),
                             round(float(r["loglik"]), 4), int(r["rounds"]))
                         for m, r in res.items()}, flush=True)
        for m, r in res.items():
            table.setdefault(m, {}).setdefault(alpha, []).append(
                (float(r["auc_pr"]), float(r["loglik"]), int(r["rounds"])))
    for m, by_alpha in table.items():
        every = [r for rows in by_alpha.values() for r in rows]
        groups = [(round(lo, 4), round(hi, 4), n)
                  for lo, hi, n in optima([r[1] for r in every])]
        spans = {a: (round(min(r[1] for r in rows), 4),
                     round(max(r[1] for r in rows), 4))
                 for a, rows in by_alpha.items()}
        aucs = {a: (round(min(r[0] for r in rows), 4),
                    round(max(r[0] for r in rows), 4))
                for a, rows in by_alpha.items()}
        rounds = [r[2] for r in every]
        print(f"{m}: loglik optima (lo, hi, runs) {groups}; by alpha "
              f"{spans}; AUC-PR by alpha {aucs}; rounds "
              f"{min(rounds)}-{max(rounds)}")
    return table


if __name__ == "__main__":
    main()
