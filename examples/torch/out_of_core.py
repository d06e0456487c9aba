"""Out-of-core training end to end through the port's public estimator
API: the same ``GMMEstimator`` / ``FedGenGMM`` facades dispatch on the
input type, so handing them a DataSource (or a list of per-client sources)
is all it takes to train on data that is never resident: a memory-mapped
``.npy`` file, ragged client shards via ConcatSource, and the full one-shot
FedGenGMM pipeline where the server refit replays the merged mixture as a
seeded synthetic block stream. The counterpart of
``examples/out_of_core.py`` with the same rows, chunks and sizes.

    PYTHONPATH=src python examples/torch/out_of_core.py           # the card
    PYTHONPATH=src python examples/torch/out_of_core.py --device cpu
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.api import FedGenGMM, FitConfig, GMMEstimator, score
from repro_torch.data import (ArraySource, ConcatSource, NpyFileSource,
                              SyntheticGMMSource)


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("out_of_core.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    # one config, every stage streams
    cfg = FitConfig(chunk_size=8192, device=args.device)

    rng = np.random.default_rng(0)
    mus = np.array([[-5, 0, 0, 0], [5, 0, 0, 0], [0, 7, 0, 0]], np.float32)
    comp = rng.integers(0, 3, 60_000)
    x = (mus[comp] + rng.normal(0, 0.7, (60_000, 4))).astype(np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        # 1. mmap'd file: only one (chunk_size, d) block is in memory at a
        #    time.
        path = Path(tmp) / "rows.npy"
        np.save(path, x)
        src = NpyFileSource(path)
        res = GMMEstimator(3, config=cfg).fit(src).result_
        ll_mmap, iters = float(res.log_likelihood), int(res.n_iter)
        print(f"mmap fit:      avg loglik {ll_mmap:+.3f} "
              f"in {iters} EM iters over {src.num_rows} rows")

        # 2. ragged shards, no padding or masks: ConcatSource re-chunks
        #    across boundaries, so this fit is bit-identical to fitting the
        #    union.
        shards = [ArraySource(x[:11_000]), ArraySource(x[11_000:37_500]),
                  ArraySource(x[37_500:])]
        res_cat = GMMEstimator(3, config=cfg).fit(
            ConcatSource(shards)).result_
        same = bool(torch.equal(res_cat.gmm.means, res.gmm.means))
        print(f"concat fit:    bit-identical to mmap fit: {same}")

        # 3. one-shot federated pipeline, everything streamed: run() sees a
        #    list of sources, so local fits stream per client and the
        #    server refit replays a synthetic source (synthetic="auto" ->
        #    "source").
        fr = FedGenGMM(k_clients=3, k_global=3, h=200, seed=1,
                       config=cfg).run(shards)
        ll_fed = float(score(fr.global_gmm, src, config=cfg))
        print(f"fedgen (src):  global avg loglik {ll_fed:+.3f}; replay set "
              f"|S|={fr.synthetic.num_rows} rows, never materialized "
              f"({type(fr.synthetic).__name__})")

        # 4. the replay trick standalone: a 10M-row virtual dataset from the
        #    fitted model, regenerated block by block from one seed.
        replay = SyntheticGMMSource(fr.global_gmm, 10_000_000, 2)
        ll10m = float(score(fr.global_gmm, replay,
                            config=cfg.replace(chunk_size=65536)))
        print(f"replay score:  avg loglik {ll10m:+.3f} over "
              f"{replay.num_rows:,} virtual rows, O(chunk) memory")
    return {"ll_mmap": ll_mmap, "em_iters": iters,
            "rows": int(src.num_rows), "concat_bit_identical": same,
            "ll_fedgen": ll_fed, "synthetic_rows": int(fr.synthetic.num_rows),
            "synthetic_kind": type(fr.synthetic).__name__,
            "ll_replay": ll10m, "replay_rows": int(replay.num_rows)}


if __name__ == "__main__":
    main()
