"""Batched serving loop: queue -> batch -> prefill -> greedy decode ->
retire, with per-request latency stats and optional FedGenGMM activation
monitoring of the served traffic (port of ``repro/launch/serve.py``).

Batching model: slot-synchronous static batching. Up to ``max_batch``
requests are left-padded with token 0 to a common prompt length (there is
no pad mask, as in the reference), prefilled together, then decoded in
lockstep at positions ``lmax + i`` until every request has its token
budget; a request whose budget is spent keeps its slot. The monitor, when
attached, observes each batch once as client 0. The repo's
continuous-batching engine is ``repro_torch.serve.ScoringEngine``, which
serves the paper's GMM scoring path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --variant smoke --requests 12 --max-new 8 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.config import resolve_device
from repro_torch.models import decode_step, init_params, prefill_forward


class Request(NamedTuple):
    rid: int
    prompt: np.ndarray          # (L,) int32
    max_new: int


class Result(NamedTuple):
    rid: int
    tokens: list[int]
    ttft_s: float               # time to first token (batch-level)
    latency_s: float


class ServeEngine:
    """Static-batching greedy server of ``params`` (a
    ``repro_torch.models.Transformer`` on ``device``)."""

    def __init__(self, cfg, params, max_batch: int = 8,
                 max_context: int = 256, monitor=None, device="cuda"):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"the model is on {params.device}, the engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_context = max_context
        self.monitor = monitor
        self._prefill = (
            lambda p, b: prefill_forward(p, cfg, b, capacity=max_context))
        self._step = (
            lambda p, c, t, pos: decode_step(p, cfg, c, t, pos))

    def _pad_batch(self, reqs: list[Request]):
        b = len(reqs)
        lmax = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, lmax), np.int32)
        for i, r in enumerate(reqs):
            toks[i, lmax - len(r.prompt):] = r.prompt  # left-pad
        return torch.as_tensor(toks, device=self.device), lmax

    def serve(self, queue: list[Request]) -> list[Result]:
        results: list[Result] = []
        qi = 0
        while qi < len(queue):
            reqs = queue[qi: qi + self.max_batch]
            qi += len(reqs)
            t0 = time.perf_counter()
            tokens, lmax = self._pad_batch(reqs)
            batch = {"tokens": tokens}
            if self.monitor is not None:
                self.monitor.observe(0, self.params, batch)
            logits, cache = self._prefill(self.params, batch)
            tok = torch.argmax(logits, -1)
            outs = [[t] for t in tok.tolist()]
            ttft = time.perf_counter() - t0
            max_new = max(r.max_new for r in reqs)
            for i in range(max_new - 1):
                logits, cache = self._step(self.params, cache, tok, lmax + i)
                tok = torch.argmax(logits, -1)
                step_tokens = tok.tolist()
                for j in range(len(reqs)):
                    if len(outs[j]) < reqs[j].max_new:
                        outs[j].append(step_tokens[j])
            dt = time.perf_counter() - t0
            for j, r in enumerate(reqs):
                results.append(Result(r.rid, outs[j], ttft, dt))
        return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, args.variant)
    params = init_params(0, cfg, device=args.device)
    rng = np.random.default_rng(0)
    queue = [Request(i, rng.integers(0, min(cfg.vocab_size, 100),
                                     rng.integers(8, 33)).astype(np.int32),
                     args.max_new)
             for i in range(args.requests)]
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         device=args.device)
    t0 = time.perf_counter()
    results = engine.serve(queue)
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests / {total_toks} tokens in "
          f"{dt:.1f}s ({total_toks / dt:.1f} tok/s) on {engine.device}")
    for r in results[:3]:
        print(f"  rid={r.rid} ttft={r.ttft_s:.2f}s "
              f"latency={r.latency_s:.2f}s tokens={r.tokens}")


if __name__ == "__main__":
    main()
