"""Host walls of the PyTorch port's hot substrate steps on one card, to
compare two trees of the port in one run:

- internlm2-1.8b in bfloat16: a 64-token prefill of 8 prompts, then
  decode steps (ms a step, median of 32 after 4 warm-up steps);
- internlm2-1.8b trained: float32 masters, AdamW, B = 4, S = 1,024 (s a
  step, median of 4 after one warm-up step);
- xlstm-350m cut to one mLSTM and one sLSTM layer at full width, trained
  at B = 8, S = 512 (s a step, median of 3 after one warm-up step).

Every step is timed on the host around ``torch.cuda.synchronize()``. The
inputs are drawn from a seeded numpy generator, the weights from seed 0.

Usage (from the repository root; ``--src`` names the tree whose
``repro_torch`` is timed, ``./src`` by default):

    python3 step_walls.py [--src PATH] [--label NAME]

Prints one JSON line: the label, the card, and each wall.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed(fn, warm: int, reps: int) -> list:
    import torch
    for _ in range(warm):
        fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def decode_walls(rng) -> list:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    cfg = get_config("internlm2-1.8b")
    model = init_params(0, cfg, "cuda")
    b, prompt, n = 8, 64, 36
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, prompt)),
                             device="cuda")
    with torch.no_grad():
        logits, cache = steps.make_prefill_step(cfg, prompt + n)(
            model, {"tokens": tokens})
        decode = steps.make_decode_step(cfg)
        state = {"tok": torch.argmax(logits, -1), "pos": prompt}

        def one():
            out, _ = decode(model, cache, state["tok"], state["pos"])
            state["tok"] = torch.argmax(out, -1)
            state["pos"] += 1

        walls = timed(one, 4, n - 4)
    del model, cache
    torch.cuda.empty_cache()
    return walls


def train_walls(rng, arch: str, b: int, s: int, reps: int,
                layers=None) -> list:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = init_params(0, cfg, "cuda", master=True)
    opt_state = init_opt_state(model)
    step = steps.make_train_step(cfg, AdamWConfig())
    batch = {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                  device="cuda"),
        "targets": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                   device="cuda"),
        "mask": torch.ones((b, s), device="cuda")}
    walls = timed(lambda: step(model, opt_state, batch), 1, reps)
    del model, opt_state
    torch.cuda.empty_cache()
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).parent / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("step_walls.py needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    dec = decode_walls(rng)
    lm = train_walls(rng, "internlm2-1.8b", 4, 1024, 4)
    xl = train_walls(rng, "xlstm-350m", 8, 512, 3, layers=2)
    print(json.dumps({
        "label": args.label or args.src, "card": card(),
        "torch": torch.__version__,
        "decode_ms_median": 1e3 * statistics.median(dec),
        "decode_ms": [round(1e3 * w, 3) for w in dec],
        "train_s_median": statistics.median(lm),
        "train_s": [round(w, 4) for w in lm],
        "xlstm2_train_s_median": statistics.median(xl),
        "xlstm2_train_s": [round(w, 4) for w in xl]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
