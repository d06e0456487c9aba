"""Readings that set the limits of ``correct``, on the card at a cell's own
size: the program's numbers over many seeds, the control's (the plain
pipeline in the program's place at TF32, the precision below the
configuration's), and each planted fault's.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--what program,control,float32,unchanged,half,altered] \\
        [--fits 3] [--extra-seeds 3]

prints one JSON line a fit: the cell, seed, fit, what ran, its numbers and
whether the cell's limits pass them. ``float32`` runs the plain pipeline at
the configuration's own precision, a witness beside the program."""
import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from perfbench import check, data, faults, harness, reference as ref  # noqa


def reading(runner, cell, split, rows, seed: int, fit: int, what: str,
            device: str) -> dict:
    """One fit of ``what`` on the window's fit seed ``fit`` of ``seed``."""
    import torch
    s = harness.fit_seed(seed, fit)
    t0 = time.perf_counter()
    if what in ("control", "float32"):
        prec = ref.Precision("tf32" if what == "control" else "float32")
        form = runner.plain(torch.as_tensor(split.data, device=device),
                            torch.as_tensor(split.mask, device=device),
                            split.sizes, cell.config, s, prec)
        iters = form.get("n_iter", form.get("n_rounds"))
    else:
        with (faults.planted(what) if what != "program" else nullcontext()):
            res = runner.fit(split, s)
        form, iters = runner.form(res), runner.iterations(res)
    wall = time.perf_counter() - t0
    nums = runner.numbers(form, rows, split)
    ok, _ = check.decide(nums, cell.limits)
    return {"workload": cell.name, "seed": seed, "fit": fit, "what": what,
            "iters": iters, "wall_s": wall, "numbers": nums,
            "passes_limits": ok}


def readings(cell, seeds, whats, fits: int, device: str = "cuda",
             extra_seeds: int = 0):
    """Yield one record a fit: ``whats[0]`` on every seed, the others on
    the first ``extra_seeds`` seeds only (all of them where that is 0)."""
    import importlib
    entry = importlib.import_module(
        f"perfbench.entries.{cell.traffic['entry']}")
    runner = entry.Runner(cell.config, cell.traffic, device)
    for n, seed in enumerate(seeds):
        split = data.make_split(cell.config, seed)
        rows = check.client_rows(split, device)
        todo = whats if not extra_seeds or n < extra_seeds else whats[:1]
        for what in todo:
            for i in range(1, fits + 1):
                yield reading(runner, cell, split, rows, seed, i, what,
                              device)


def main(argv) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program")
    p.add_argument("--fits", type=int, default=1)
    p.add_argument("--extra-seeds", type=int, default=0)
    args = p.parse_args(argv)
    harness.use_cache_dirs()
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(cell, seeds, args.what.split(","), args.fits,
                        extra_seeds=args.extra_seeds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
