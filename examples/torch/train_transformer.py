"""Train a reduced-config architecture end to end on the synthetic token
pipeline (a few hundred steps) and verify the loss drops. The counterpart
of ``examples/train_transformer.py`` with the same config, batch, sequence
length and steps; the checkpoint goes to a temporary directory.

    PYTHONPATH=src python examples/torch/train_transformer.py     # the card
    PYTHONPATH=src python examples/torch/train_transformer.py --device cpu \\
        [--arch yi-6b] [--steps 200]
"""
import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.launch.train import train


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_transformer.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "model"
        _, losses = train(args.arch, "smoke", steps=args.steps, batch_size=8,
                          seq_len=128, checkpoint_path=str(ckpt),
                          device=args.device)
        written = sorted(p.name for p in Path(tmp).iterdir())
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    assert losses[-1] < losses[0]
    return {"arch": args.arch, "steps": len(losses),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "checkpoint_files": written}


if __name__ == "__main__":
    main()
