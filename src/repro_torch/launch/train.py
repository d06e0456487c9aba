"""The trainer: runs real steps of a registered architecture (port of
``repro/launch/train.py``).

The masters are float32 on ``device`` from ``seed``; each step casts them
to the config's compute dtype (``launch/steps.py``). Batches come from the
synthetic token stream (``data/tokens.py``, the JAX package's stream from
the same seed), a vision prefix and an encoder-decoder's ``src_embeds``
(frame embeddings at ``seq_len // src_ratio``) from
``numpy.random.default_rng(seed)`` in the reference's order, so both
trainers see the same data. The checkpoint is written in the JAX package's
tree layout (``convert.model_params_to_jax``), so
``repro.checkpoint.load_checkpoint`` restores it into that package's
``init_params`` tree.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --variant smoke --steps 20 --batch 8 --seq 128 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_jax
from repro_torch.core.config import resolve_device
from repro_torch.data.tokens import batches
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state


def train(arch: str, variant: str = "smoke", steps: int = 50,
          batch_size: int = 8, seq_len: int = 128, lr: float = 3e-4,
          seed: int = 0, log_every: int = 10,
          checkpoint_path: str | None = None, device="cuda"):
    """Train ``arch`` for ``steps`` steps -> (the float32 master model, the
    losses a step)."""
    cfg = get_config(arch, variant)
    device = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    model = init_params(seed, cfg, device=device, master=True)
    opt_state = init_opt_state(model)
    step_fn = make_train_step(cfg, opt_cfg)

    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.time()
    for i, b in enumerate(batches(seed, cfg.vocab_size, batch_size, seq_len,
                                  steps)):
        batch = {"tokens": torch.as_tensor(b.tokens, device=device),
                 "targets": torch.as_tensor(b.targets, device=device),
                 "mask": torch.as_tensor(b.mask, device=device)}
        if cfg.frontend == "vision":
            batch["prefix"] = torch.as_tensor(
                rng.normal(0, 0.02, (batch_size, cfg.n_prefix, cfg.d_model)),
                dtype=torch.float32, device=device).to(cfg.dtype)
        if cfg.n_enc_layers:
            batch["src_embeds"] = torch.as_tensor(
                rng.normal(0, 0.02, (batch_size, seq_len // cfg.src_ratio,
                                     cfg.d_model)),
                dtype=torch.float32, device=device).to(cfg.dtype)
        metrics = step_fn(model, opt_state, batch)
        losses.append(metrics["loss"])
        if (i + 1) % log_every == 0 or i == 0:
            print(f"step {i + 1:4d} loss {losses[-1]:.4f} "
                  f"lr {metrics['lr']:.2e} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, model_params_to_jax(model),
                        {"step": steps, "arch": arch, "variant": variant})
        print(f"checkpoint -> {checkpoint_path}")
    return model, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses = train(args.arch, args.variant, args.steps, args.batch,
                      args.seq, args.lr, checkpoint_path=args.checkpoint,
                      device=args.device)
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
