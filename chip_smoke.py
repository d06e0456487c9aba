#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (each failure makes the exit code non-zero):
  1. device and build: the card's name and power limit, versions, and the
     three CUDA sources built from ``src/repro_torch/kernels/csrc`` with one
     ``nvcc`` each, all started together, with each kernel's registers and
     shared memory;
  2. every kernel against its plain PyTorch version on the card, at the
     kernel test shapes and at the main path's shapes, with the tolerances of
     ``tests/test_kernels.py``; tie cases; the log-prob, E-step and sweep
     kernels giving the same bits in two launches; a row's log density
     giving the same bits alone, in a 128-row request, in the 60,000-row
     call and through ``log_prob`` at chunk 4096 and None; the sweep's
     statistics against the one-hot formula on its own labels, with
     zero-weight rows, an empty cluster and duplicated centers;
  3. the main path at the paper's MNIST width: FedGenGMM (20 clients, 60,000
     rows, d = 24, K = 30, |S| = 30,000), then scoring requests through
     ``gmm_log_prob`` (avg log-likelihood, AUC-PR), with every kernel's launch
     count read around the run; a central GMM for comparison;
  4. EM agreement on the card: from one injected init, the fused and the
     reference backends reach final avg log-likelihoods within 1e-4 on the
     central fit and on the 20 local fits at the default tol; the local
     fits at tol 0 are reported beside a float64 witness;
  5. kernel times at the main path's shapes against their bounds, each
     timed twice in turns with its plain version; the sweep kernel beside
     the assignment kernel + one-hot ops it replaces; both log-density
     entries at 60,000 and 128 rows, and the fused ``_log_prob_block`` at
     60,000 and 1,000,000 rows beside the per-component kernel +
     ``torch.logsumexp`` and beside cuBLAS (``torch.addmm`` on pre-built
     operands) + ``torch.logsumexp``;
  6. the main path's device time by kernel (``torch.profiler``), with the
     count of cuBLAS GEMM launches; the device work of each 128-row anomaly
     request;
  7. the paper's comparison on phase 3's split: DEM with its three inits,
     FedEM (participation 0.5, 2 local epochs), FedKMeans and FedGenGMM with
     per-client BIC selection (K_c in 10, 20, 30, 40), each with its rounds,
     communication, log-likelihood, AUC-PR (FedKMeans: inertia), wall time,
     device busy time and kernel launches, every round's launches checked;
     the rounds and uplink of FedGenGMM against each DEM init (Table 4);
     fused DEM held to reference DEM within 1e-4 from one injected init;
     per-client and server-side BIC on planted clients with ragged K_c,
     on the card against the same run on the CPU;
  8. serving: phase 3's global model behind ``repro_torch.serve``'s
     ``ScoringEngine`` (each micro-batch one CUDA-graph replay of the
     log-density kernel) for a stream of 400 anomaly requests of
     ``benchmarks/serve_bench.py``'s sizes drawn from phase 3's test and OOD
     rows, 4 arrivals a step, at 8 x 512 and at 8 x 1024 rows, the second
     with phase 3's central GMM published mid-stream through a
     ``ModelStore`` the engine follows; every result the bits of
     ``api.log_prob`` under the version that scored it and within phase
     2's tolerance of the plain version, no request dropped, one version
     boundary, one replay and no launch, capture or packing from the host
     a steady step, replay equal to the eager step, other pool geometries
     equal; a ``responsibilities`` run through ``gmm_logpdf`` held to the
     plain version and to ``GMM.responsibilities`` at fixed limits; under
     ``torch.profiler``, one log-density kernel on the device a step; device
     ops a step, a step's replay time, the wall of a replayed and an eager
     micro-batch, latency, throughput, swap pause and capture time.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``. A kernel's ``launches`` there is phase
3's main-path count; ``launches_by_path`` adds phase 8's serving runs (the
wrapper's launches: a warm-up and a capture at each install, since a replay
does not call it), and ``serving_device_launches`` the kernel's launches
that the profiler saw on the device in phase 8's traced runs (one a
micro-batch). Without CUDA, or without the repository beside it, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tests/test_kernels.py SHAPES, (N, d, K)
KERNEL_SHAPES = [(64, 4, 2), (256, 24, 30), (1000, 11, 15), (513, 84, 10),
                 (100, 38, 10), (2048, 128, 64), (17, 3, 1)]
# The main path: mnist_like(n_train=60000) over 20 Dirichlet(0.5) clients
# pads to (20, 7320, 24); K = 30; the refit runs on |S| = 50 * 20 * 30 rows.
N_TRAIN, CLIENTS, N_PAD, D, K, H = 60000, 20, 7320, 24, 30, 50
N_SYNTH = H * CLIENTS * K

KERNELS = {
    "gmm_logpdf": ("src/repro_torch/kernels/csrc/gmm_logpdf.cu",
                   "src/repro/kernels/gmm_logpdf.py:31"),
    "gmm_log_prob": ("src/repro_torch/kernels/csrc/gmm_logpdf.cu",
                     "src/repro/kernels/gmm_logpdf.py:31"),
    "estep_stats": ("src/repro_torch/kernels/csrc/estep_stats.cu",
                    "src/repro/kernels/estep_stats.py:25"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign.py:18"),
    "kmeans_sweep_stats": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                           "src/repro/kernels/kmeans_assign.py:18"),
}
# The kernels the fused main path launches (kmeans_assign's assignment core
# runs there inside kmeans_sweep_stats, gmm_logpdf's core inside
# gmm_log_prob), and the entries it must not launch.
PATH_KERNELS = ("gmm_log_prob", "estep_stats", "kmeans_sweep_stats")
OFF_PATH_KERNELS = ("gmm_logpdf", "kmeans_assign")
REQUEST_ROWS = 128  # rows of one anomaly-scoring request
SERVE_SLABS = (8 * 512, 8 * 1024)  # rows of phase 8's micro-batches
# The main path's Lloyd sweep shapes (problems, rows): the local pilots (20
# clients x 4 restarts), the local fits, the refit's pilots on its
# SEED_ROWS subsample, the refit's full-data polish.
SWEEP_SHAPES = [(CLIENTS * 4, N_PAD), (CLIENTS, N_PAD), (4, 16384),
                (1, N_SYNTH)]


class Failed(Exception):
    pass


def check(cond, what: str):
    if not cond:
        raise Failed(what)


def log(*args):
    print(*args, flush=True)


def close(a, b, rtol, atol, what):
    """``a`` within ``atol + rtol*|b|`` of ``b`` everywhere; returns the
    largest absolute difference."""
    import torch
    a, b = a.double(), b.double()
    err = float((a - b).abs().max()) if a.numel() else 0.0
    ok = bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))
    check(ok and bool(torch.isfinite(a).all()),
          f"{what}: max abs err {err} beyond rtol={rtol} atol={atol}")
    return err


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls, between
    CUDA events: the host's launch cost where it exceeds the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``: the call captured once in a
    CUDA graph, which is replayed ``reps`` times between CUDA events, so
    the host's launch cost is not in it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns(kern, plain):
    """``kern`` and ``plain`` timed in turns (kern, plain, kern, plain) by
    :func:`graph_ms`: (both kern times, both plain times)."""
    ks, ps = [], []
    for _ in range(2):
        ks.append(graph_ms(kern))
        ps.append(graph_ms(plain))
    return ks, ps


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``flops`` f32 operations, and which bounds it."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def model_inputs(rng, n, d, k, dev, batch=None):
    """The inputs of tests/test_kernels.py::make_inputs (optionally with a
    leading batch axis), as float32 tensors on ``dev``."""
    import numpy as np
    import torch
    lead = () if batch is None else (batch,)
    x = rng.normal(0, 2, lead + (n, d))
    mu = rng.normal(0, 2, lead + (k, d))
    var = rng.uniform(0.05, 3.0, lead + (k, d))
    lw = np.log(rng.dirichlet(np.ones(k), size=lead or None))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (x, mu, var, lw))


def kernel_counts() -> dict:
    """Every kernel entry's launch count."""
    from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
    return {"gmm_logpdf": gmm_logpdf.launches,
            "gmm_log_prob": gmm_logpdf.log_prob_launches,
            "estep_stats": estep_stats.launches,
            "kmeans_assign": kmeans_assign.launches,
            "kmeans_sweep_stats": kmeans_assign.sweep_launches}


def reset_counts():
    from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
    gmm_logpdf.launches = gmm_logpdf.log_prob_launches = 0
    estep_stats.launches = 0
    kmeans_assign.launches = kmeans_assign.sweep_launches = 0


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def phase_kernels(dev, report):
    import numpy as np
    import torch
    from repro_torch.api import FitConfig, log_prob
    from repro_torch.core.gmm import GMM
    from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ops import pack_params

    def logpdf_case(n, d, k, seed):
        """Both entries of csrc/gmm_logpdf.cu: the per-component densities
        against the oracle and the plain version, the row log density
        against its plain version, and two launches of it bit-equal."""
        x, mu, var, lw = model_inputs(np.random.default_rng(seed), n, d, k,
                                      dev)
        a, b, c = pack_params(mu, var, lw)
        out = gmm_logpdf.gmm_logpdf(x, a, b, c)
        lp = gmm_logpdf.gmm_log_prob(x, a, b, c)
        again = gmm_logpdf.gmm_log_prob(x, a, b, c)
        torch.cuda.synchronize()
        check(torch.equal(lp, again),
              f"gmm_log_prob not bit-reproducible at {(n, d, k)}")
        close(out, ref.gmm_logpdf_ref(x, mu, var, lw), 2e-4, 2e-4,
              f"gmm_logpdf vs oracle at {(n, d, k)}")
        return (close(out, ref.gmm_logpdf_packed(x, a, b, c), 2e-4, 2e-4,
                      f"gmm_logpdf vs plain at {(n, d, k)}"),
                close(lp, ref.gmm_log_prob_packed(x, a, b, c), 2e-4, 2e-4,
                      f"gmm_log_prob vs plain at {(n, d, k)}"))

    def rows_stable(seed):
        """A row's fused log density has the same bits alone, in 128-row
        requests, inside the 60,000-row call, and through ``api.log_prob``
        at chunk 4096 (a ragged last chunk) and at None."""
        x, mu, var, lw = model_inputs(np.random.default_rng(seed), N_TRAIN,
                                      D, K, dev)
        g = GMM(torch.exp(lw), mu, var)
        args = (g.means, g.covs, torch.log(g.weights))
        full = ops.gmm_log_prob(x, *args)
        requests = torch.cat([ops.gmm_log_prob(x[i:i + REQUEST_ROWS], *args)
                              for i in range(0, N_TRAIN, REQUEST_ROWS)])
        picks = [0, 1, 127, 128, 255, 256, N_TRAIN - 1] + [
            int(i) for i in np.random.default_rng(seed).integers(0, N_TRAIN,
                                                                 25)]
        alone = torch.cat([ops.gmm_log_prob(x[i:i + 1], *args)
                           for i in picks])
        cfg = FitConfig(backend="fused", device=dev.type)
        chunked = log_prob(g, x, cfg.replace(chunk_size=4096))
        whole = log_prob(g, x, cfg)
        torch.cuda.synchronize()
        check(torch.equal(requests, full), "gmm_log_prob: 128-row requests "
              "differ from the 60,000-row call")
        check(torch.equal(alone, full[picks]), "gmm_log_prob: rows scored "
              "alone differ from the 60,000-row call")
        check(torch.equal(chunked, full) and torch.equal(whole, full),
              "log_prob at chunk 4096 or None differs from the kernel")

    def estep_case(c_, n, d, k, seed):
        rng = np.random.default_rng(seed)
        x, mu, var, lw = model_inputs(rng, n, d, k, dev, batch=c_)
        w = torch.as_tensor(rng.uniform(0, 1, (c_, n)), dtype=torch.float32,
                            device=dev)
        a, b, c = pack_params(mu, var, lw)
        got = estep_stats.estep_stats(x, w, a, b, c)
        exp = ref.estep_stats_packed(x, w, a, b, c)
        torch.cuda.synchronize()
        tol = [(1e-3, 1e-4), (1e-3, 1e-3), (1e-3, 1e-3), (1e-4, 0.0)]
        errs = [close(g, e, rt, at, f"estep_stats[{i}] at {(c_, n, d, k)}")
                for i, (g, e, (rt, at)) in enumerate(zip(got, exp, tol))]
        again = estep_stats.estep_stats(x, w, a, b, c)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"estep_stats not bit-reproducible at {(c_, n, d, k)}")
        return max(errs)

    def sweep_case(bsz, n, d, k, seed):
        """Zero-weight rows (a padded tail and every 7th row), centers
        k-2 and k-1 duplicating centers 0 and 1 (ties go to the first
        index), and center k-3 far away (an empty cluster)."""
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.normal(0, 2, (bsz, n, d)),
                            dtype=torch.float32, device=dev)
        mu = rng.normal(0, 2, (bsz, k, d))
        if k >= 5:
            mu[:, k - 2:] = mu[:, :2]
            mu[:, k - 3] = 1e3
        mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
        w = rng.uniform(0, 1, (bsz, n))
        w[:, ::7] = 0.0
        w[:, n - n // 10:] = 0.0
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        ct = mu.transpose(-1, -2).contiguous()
        c2 = (mu * mu).sum(-1).contiguous()
        got = kmeans_assign.kmeans_sweep_stats(x, w, ct, c2, with_idx=True)
        again = kmeans_assign.kmeans_sweep_stats(x, w, ct, c2, with_idx=True)
        eidx, _ = ref.kmeans_assign_packed(x, ct, c2)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"kmeans_sweep_stats not bit-reproducible at {(bsz, n, d, k)}")
        counts, sums, inertia, idx = got
        x2 = (x * x).sum(-1, keepdim=True)
        dist = torch.clamp(x2 - 2.0 * (x @ ct) + c2.unsqueeze(-2), min=0.0)
        top2 = torch.topk(dist, min(2, k), dim=-1, largest=False).values
        clear = (top2[..., -1] - top2[..., 0] > 1e-4) if k > 1 else \
            torch.ones_like(idx, dtype=torch.bool)
        check(bool(torch.all((idx == eidx) | ~clear)),
              f"kmeans_sweep_stats label mismatch at {(bsz, n, d, k)}")
        if k >= 5:
            check(not bool(torch.any(idx >= k - 2)),
                  f"kmeans_sweep_stats sends ties past the first index at "
                  f"{(bsz, n, d, k)}")
            check(bool(torch.all(counts[:, k - 3] == 0)),
                  f"kmeans_sweep_stats: the far center is not empty at "
                  f"{(bsz, n, d, k)}")
        # the one-hot formula on the kernel's own labels
        lab = idx.long()
        oh = (lab.unsqueeze(-1) == torch.arange(k, device=dev)).float() \
            * w.unsqueeze(-1)
        d2 = torch.gather(dist, -1, lab.unsqueeze(-1)).squeeze(-1)
        return max(
            close(counts, oh.sum(-2), 2e-4, 2e-4,
                  f"kmeans_sweep_stats counts at {(bsz, n, d, k)}"),
            close(sums, oh.transpose(-1, -2) @ x, 2e-4, 2e-4,
                  f"kmeans_sweep_stats sums at {(bsz, n, d, k)}"),
            close(inertia, (d2 * w).sum(-1), 2e-4, 2e-4,
                  f"kmeans_sweep_stats inertia at {(bsz, n, d, k)}"))

    def assign_case(bsz, n, d, k, seed, centers=None):
        x, mu, _, _ = model_inputs(np.random.default_rng(seed), n, d, k, dev,
                                   batch=bsz)
        if centers is not None:
            mu = centers
        ct = mu.transpose(-1, -2).contiguous()
        c2 = (mu * mu).sum(-1).contiguous()
        idx, d2 = kmeans_assign.kmeans_assign(x, ct, c2)
        eidx, ed2 = ref.kmeans_assign_packed(x, ct, c2)
        torch.cuda.synchronize()
        err = close(d2, ed2, 1e-4, 1e-4, f"kmeans_assign d2 at {(n, d, k)}")
        x2 = (x * x).sum(-1, keepdim=True)
        dist = torch.clamp(x2 - 2.0 * (x @ ct) + c2.unsqueeze(-2), min=0.0)
        top2 = torch.topk(dist, min(2, k), dim=-1, largest=False).values
        clear = (top2[..., -1] - top2[..., 0] > 1e-4) if k > 1 else \
            torch.ones_like(idx, dtype=torch.bool)
        check(bool(torch.all((idx == eidx) | ~clear)),
              f"kmeans_assign index mismatch at {(n, d, k)}")
        return err, idx, eidx

    errs = {name: 0.0 for name in KERNELS}
    for i, (n, d, k) in enumerate(KERNEL_SHAPES):
        logpdf_case(n, d, k, 100 + i)
        estep_case(1, n, d, k, 200 + i)
        assign_case(1, n, d, k, 300 + i)
        sweep_case(2, n, d, k, 400 + i)
    # K above 128 (16 components a thread in the E-step's logit blocks)
    estep_case(1, 3000, 8, 200, 10)
    sweep_case(1, 3000, 8, 200, 11)
    # K over one 32-component chunk of the log-prob entry, d = 128, one row
    for i, (n, d, k) in enumerate([(700, 24, 64), (700, 24, 100),
                                   (300, 128, 100), (1, D, K)]):
        logpdf_case(n, d, k, 110 + i)
    # main-path shapes: scoring the training rows and a 128-row request;
    # the batched local E-step and the refit E-step; the batched local Lloyd
    # sweep and the refit's
    full_errs = logpdf_case(N_TRAIN, D, K, 1)
    request_errs = logpdf_case(REQUEST_ROWS, D, K, 14)
    # phase 8's serving slabs, 8 x 512 and 8 x 1024 rows
    slab_errs = [logpdf_case(n, D, K, 16 + i)
                 for i, n in enumerate(SERVE_SLABS)]
    cases = [full_errs, request_errs] + slab_errs
    errs["gmm_logpdf"] = max(e[0] for e in cases)
    errs["gmm_log_prob"] = max(e[1] for e in cases)
    rows_stable(15)
    errs["estep_stats"] = max(estep_case(CLIENTS, N_PAD, D, K, 2),
                              estep_case(1, N_SYNTH, D, K, 3),
                              # tile edges: 64 rows a tile
                              estep_case(2, 64 * 70, D, K, 12),
                              estep_case(3, 64 * 70 + 1, D, K, 13))
    errs["kmeans_assign"] = max(assign_case(CLIENTS, N_PAD, D, K, 4)[0],
                                assign_case(1, N_SYNTH, D, K, 5)[0])
    errs["kmeans_sweep_stats"] = max(
        sweep_case(bsz, n, D, K, 20 + i)
        for i, (bsz, n) in enumerate(SWEEP_SHAPES))
    # ties: every center duplicated, so each row has two nearest centers
    rng = np.random.default_rng(6)
    base = torch.as_tensor(rng.normal(0, 2, (1, 8, D)), dtype=torch.float32,
                           device=dev)
    dup = torch.cat([base, base], dim=1)
    _, idx, eidx = assign_case(1, 4096, D, 16, 7, centers=dup)
    check(bool(torch.all(idx < 8)) and torch.equal(idx, eidx),
          "kmeans_assign does not resolve ties to the first index")
    log(f"phase 2: kernels match their plain versions; main-path max abs "
        f"err {errs}; gmm_log_prob, estep_stats and kmeans_sweep_stats "
        f"bit-reproducible; gmm_log_prob rows the same bits alone, in "
        f"requests, in one call and chunked; ties to first index")
    report["errs"] = errs


# ----------------------------------------------------------------------
# Phase 3: the main path
# ----------------------------------------------------------------------

def phase_main_path(dev, report):
    import numpy as np
    import torch
    from repro_torch.api import (FedGenGMM, FitConfig, GMMEstimator,
                                 log_prob, score)
    from repro_torch.core.metrics import auc_pr
    from repro_torch.core.partition import partition
    from repro_torch.data.datasets import mnist_like
    from repro_torch.fed.ledger import gmm_payload_floats

    t0 = time.perf_counter()
    ds = mnist_like(np.random.default_rng(0), n_train=N_TRAIN)
    split = partition(np.random.default_rng(0), ds.x_train, ds.y_train,
                      CLIENTS, "dirichlet", 0.5)
    log(f"phase 3: data {ds.x_train.shape}, split {split.data.shape}, client "
        f"sizes {int(split.sizes.min())}..{int(split.sizes.max())} "
        f"({time.perf_counter() - t0:.1f} s on the host)")
    check(split.data.shape == (CLIENTS, N_PAD, D), "unexpected split shape")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = FedGenGMM(k_clients=K, k_global=K, h=H,
                    device=dev.type).run(split, seed=0)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    # scoring: the fitness score, then anomaly requests of 128 rows each
    cfg = FitConfig(device=dev.type)
    ll = float(score(fed.global_gmm, ds.x_train, config=cfg))
    rows = np.concatenate([ds.x_test_in, ds.x_test_ood])
    scores = np.concatenate([
        -log_prob(fed.global_gmm, rows[i:i + REQUEST_ROWS], cfg).cpu().numpy()
        for i in range(0, len(rows), REQUEST_ROWS)])
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = kernel_counts()
    labels = np.r_[np.zeros(len(ds.x_test_in)), np.ones(len(ds.x_test_ood))]
    auc = auc_pr(scores, labels)
    comm = fed.comm
    iters = [int(r.n_iter) for r in fed.local_results]
    log(f"phase 3: FedGenGMM fit {t_fit:.3f} s, fit + scoring "
        f"{t_total:.3f} s (host clock, synchronized)")
    log(f"phase 3: global avg loglik {ll:.6f}, AUC-PR {auc:.6f}, |S| "
        f"{fed.synthetic.shape[0]}, local EM iterations {iters}")
    log(f"phase 3: comm {comm._asdict()}, {comm.total_mb:.4f} MiB")
    requests = -(-len(rows) // REQUEST_ROWS)
    log(f"phase 3: launches on the main path {launches} (the fused Lloyd "
        f"sweeps launch kmeans_sweep_stats, which holds kmeans_assign's "
        f"assignment core; scoring launches gmm_log_prob, which holds "
        f"gmm_logpdf's core: 1 for the fitness score, {requests} for the "
        f"{REQUEST_ROWS}-row anomaly requests; the assignment-only and "
        f"per-component entries are off this path)")
    up = CLIENTS * (gmm_payload_floats(K, D, True) + 1)
    check(comm.rounds == 1 and comm.uplink_floats == up,
          f"uplink_floats {comm.uplink_floats} != closed form {up}")
    check(fed.synthetic.shape == (N_SYNTH, D), "unexpected |S|")
    check(np.isfinite(ll) and np.isfinite(scores).all() and 0 <= auc <= 1,
          "non-finite scores")
    for t in (fed.global_gmm.weights, fed.global_gmm.means,
              fed.global_gmm.covs):
        check(bool(torch.isfinite(t).all()), "non-finite global model")
    for name in PATH_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    for name in OFF_PATH_KERNELS:
        check(launches[name] == 0,
              f"kernel {name} was launched on the main path")
    check(launches["gmm_log_prob"] == 1 + requests,
          f"gmm_log_prob launched {launches['gmm_log_prob']} times, not once "
          f"for the score and once per request ({1 + requests})")

    t0 = time.perf_counter()
    central = GMMEstimator(K, device=dev.type).fit(ds.x_train, seed=0)
    torch.cuda.synchronize()
    t_central = time.perf_counter() - t0
    ll_central = float(central.score(ds.x_train))
    check(np.isfinite(ll_central), "non-finite central log-likelihood")
    log(f"phase 3: central GMM({K}) avg loglik {ll_central:.6f} "
        f"({t_central:.3f} s, {int(central.result_.n_iter)} EM iterations)")
    report.update(launches=launches, fit_s=t_fit, total_s=t_total, ll=ll,
                  auc=auc, ll_central=ll_central, split=split, ds=ds,
                  gmm=fed.global_gmm, central_gmm=central.gmm_,
                  requests=rows)


# ----------------------------------------------------------------------
# Phase 4: fused and reference EM from one injected init
# ----------------------------------------------------------------------

def phase_em_agreement(dev, report):
    """From one injected init, fused and reference EM must end within 1e-4
    in avg log-likelihood: the central fit (60,000 rows, one model) at 30
    iterations with tol 0 and at the default tol, and the 20 local fits at
    the default tol, the main path's setting. The local fits at tol 0 over
    30 iterations are reported with a float64 witness (ROADMAP Queue C, R5):
    the same 30 iterations in float64 from the same init, the local
    variances at the reg_covar floor, and the float32 identity's error per
    log density at the fused fit's model against a float64 direct form."""
    import torch
    from repro_torch.core.config import FitConfig
    from repro_torch.core.em import _em_loop, fit_gmm_cfg, init_from_kmeans
    from repro_torch.core.gmm import GMM, LOG_2PI
    from repro_torch.convert import split_to_clients

    clients = split_to_clients(report["split"], dev)
    x = torch.as_tensor(report["ds"].x_train, device=dev)
    g_central = init_from_kmeans(2, x, K, assign_backend="reference")
    g_local = init_from_kmeans(1, clients.data, K, clients.mask,
                               assign_backend="reference")
    cases = (("central fit", x, None, g_central, 0.0, 30, True),
             ("central fit", x, None, g_central, "auto", "auto", True),
             ("20 local fits", clients.data, clients.mask, g_local, "auto",
              "auto", True),
             ("20 local fits", clients.data, clients.mask, g_local, 0.0, 30,
              False))
    for name, data, w, g0, tol, max_iter, held in cases:
        res = {}
        for backend in ("fused", "reference"):
            cfg = FitConfig(backend=backend, tol=tol, max_iter=max_iter,
                            device=dev.type)
            res[backend] = fit_gmm_cfg(0, data, K, cfg, w, init_gmm=g0)
        lls = {b: r.log_likelihood for b, r in res.items()}
        diff = float((lls["fused"] - lls["reference"]).abs().max())
        log(f"phase 4: {name}, tol={tol}, max_iter={max_iter}: max |ll "
            f"fused - ll reference| = {diff:.3e}"
            + (" (held to 1e-4)" if held else " (reported)"))
        report.setdefault("em_diff", {})[f"{name} tol={tol}"] = diff
        if held:
            check(diff <= 1e-4, f"{name} at tol={tol}: fused and reference "
                  f"EM differ by {diff} > 1e-4")
            continue
        # the float64 witness of the reported case
        reg = cfg.reg_covar
        g64 = GMM(g0.weights.double(), g0.means.double(), g0.covs.double())
        w64 = w.double()
        gm64, ll64, _, _ = _em_loop(g64, data.double(), w64, 0.0, reg,
                                    max_iter, "reference", None)
        for b in ("fused", "reference"):
            covs = res[b].gmm.covs
            log(f"phase 4:   {b}: max |ll - ll float64| = "
                f"{float((lls[b].double() - ll64).abs().max()):.3e}; "
                f"variances <= 2*reg_covar: {int((covs <= 2 * reg).sum())} "
                f"of {covs.numel()}, smallest {float(covs.min()):.3e}")
        log(f"phase 4:   float64: variances <= 2*reg_covar: "
            f"{int((gm64.covs <= 2 * reg).sum())}, smallest "
            f"{float(gm64.covs.min()):.3e}")
        g = res["fused"].gmm
        lp32 = g.component_log_prob(data).double()
        x64, mu, var = data.double(), g.means.double(), g.covs.double()
        maha = torch.stack([((x64 - mu[:, k:k + 1]) ** 2
                             / var[:, k:k + 1]).sum(-1) for k in range(K)],
                           dim=-1)
        lp64 = -0.5 * (maha + torch.log(var).sum(-1).unsqueeze(-2)
                       + D * LOG_2PI)
        err = (lp32 - lp64).abs() * (w64 > 0).unsqueeze(-1)
        floor = (var <= 2 * reg).any(-1).unsqueeze(-2).expand_as(err)
        log(f"phase 4:   float32 identity vs float64 direct log density at "
            f"the fused fit's model: max err {float(err.max()):.3e}, on "
            f"components with a variance at the floor "
            f"{float(err[floor].max()) if floor.any() else 0.0:.3e}, on the "
            f"others {float(err[~floor].max()):.3e}")


# ----------------------------------------------------------------------
# Phase 5: times at the main path's shapes
# ----------------------------------------------------------------------

def phase_times(dev, report):
    """Each kernel and its plain version timed in turns (kernel, plain,
    kernel, plain), each the device time of one call from 30 replays of a
    CUDA graph; both kernel times are kept to show the spread, and the
    smaller is the row's time. The kernel's eager call (host launch cost
    included) is timed beside it."""
    import numpy as np
    import torch
    from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import pack_params

    def onehot_sweep(x, w, ct, c2):
        """The fused sweep as an assignment kernel and one-hot ops (what
        kmeans_sweep_stats replaces): idx and d2 from kmeans_assign, then
        the weighted one-hot matrix, its column sums and ``oh.T @ x``."""
        idx, d2 = kmeans_assign.kmeans_assign(x, ct, c2)
        oh = (idx.unsqueeze(-1) == torch.arange(ct.shape[-1], device=dev)
              ).to(x.dtype) * w.unsqueeze(-1)
        return oh.sum(dim=-2), oh.transpose(-1, -2) @ x, torch.sum(d2 * w,
                                                                   dim=-1)

    rng = np.random.default_rng(9)
    rows = {}
    # gmm_logpdf and gmm_log_prob: scoring the 60,000 training rows
    x, mu, var, lw = model_inputs(rng, N_TRAIN, D, K, dev)
    a, b, c = pack_params(mu, var, lw)
    n = N_TRAIN
    rows["gmm_logpdf"] = (
        lambda: gmm_logpdf.gmm_logpdf(x, a, b, c),
        lambda: ref.gmm_logpdf_packed(x, a, b, c),
        n * (D + K) * 4, 4 * n * D * K)
    rows["gmm_log_prob"] = (
        lambda: gmm_logpdf.gmm_log_prob(x, a, b, c),
        lambda: ref.gmm_log_prob_packed(x, a, b, c),
        n * (D + 1) * 4, 4 * n * D * K)
    # estep_stats: one iteration of the 20 batched local fits
    xe, mue, vare, lwe = model_inputs(rng, N_PAD, D, K, dev, batch=CLIENTS)
    we = torch.as_tensor(report["split"].mask, device=dev)
    ae, be, ce = pack_params(mue, vare, lwe)
    n = CLIENTS * N_PAD
    rows["estep_stats"] = (
        lambda: estep_stats.estep_stats(xe, we, ae, be, ce),
        lambda: ref.estep_stats_packed(xe, we, ae, be, ce),
        n * (D + 1) * 4, 8 * n * D * K)
    # kmeans_assign and kmeans_sweep_stats: one Lloyd sweep of the 20
    # batched local k-means
    ct = mue.transpose(-1, -2).contiguous()
    c2 = (mue * mue).sum(-1).contiguous()
    rows["kmeans_assign"] = (
        lambda: kmeans_assign.kmeans_assign(xe, ct, c2),
        lambda: ref.kmeans_assign_packed(xe, ct, c2),
        n * (D + 2) * 4, 2 * n * D * K)
    rows["kmeans_sweep_stats"] = (
        lambda: kmeans_assign.kmeans_sweep_stats(xe, we, ct, c2),
        lambda: ref.kmeans_sweep_packed(xe, we, ct, c2),
        n * (D + 1) * 4, 2 * n * D * K + n * D)
    out = []
    for name, (kern, plain, nbytes, flops) in rows.items():
        ks, ps = turns(kern, plain)
        b_ms, b_by = bound(nbytes, flops)
        source, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": report["launches"][name],
            "max_abs_err": report["errs"][name], "ms": min(ks),
            "plain_ms": min(ps), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "ms_runs": ks})
        log(f"phase 5: {name}: {ks[0]:.5f} / {ks[1]:.5f} ms (plain "
            f"{ps[0]:.5f} / {ps[1]:.5f} ms, bound {b_ms:.5f} ms by {b_by}; "
            f"eager call {cuda_ms(kern):.5f} ms)")
    ks, ps = turns(rows["kmeans_sweep_stats"][0],
                   lambda: onehot_sweep(xe, we, ct, c2))
    out[-1]["composite_ms"] = min(ps)
    phase_log_prob_times(dev, x, a, b, c, mu, var, lw,
                         next(e for e in out if e["name"] == "gmm_log_prob"))
    log(f"phase 5: kmeans_sweep_stats at ({CLIENTS}, {N_PAD}): {ks[0]:.5f} / "
        f"{ks[1]:.5f} ms; the assignment kernel + one-hot ops it replaces "
        f"{ps[0]:.5f} / {ps[1]:.5f} ms")
    # the other main-path shapes, beside the table
    xs, mus, vars_, lws = model_inputs(rng, N_SYNTH, D, K, dev, batch=1)
    ws = torch.ones((1, N_SYNTH), device=dev)
    as_, bs, cs = pack_params(mus, vars_, lws)
    ks, ps = turns(lambda: estep_stats.estep_stats(xs, ws, as_, bs, cs),
                   lambda: ref.estep_stats_packed(xs, ws, as_, bs, cs))
    b_ms, b_by = bound(N_SYNTH * (D + 1) * 4, 8 * N_SYNTH * D * K)
    log(f"phase 5: estep_stats at the refit shape (1, {N_SYNTH}, {D}, {K}): "
        f"{ks[0]:.5f} / {ks[1]:.5f} ms (plain {ps[0]:.5f} / {ps[1]:.5f} ms, "
        f"bound {b_ms:.5f} ms by {b_by})")
    for bsz, n in SWEEP_SHAPES:
        if (bsz, n) == (CLIENTS, N_PAD):
            continue
        xk = torch.as_tensor(rng.normal(0, 2, (bsz, n, D)),
                             dtype=torch.float32, device=dev)
        wk = torch.ones((bsz, n), device=dev)
        mk = torch.as_tensor(rng.normal(0, 2, (bsz, K, D)),
                             dtype=torch.float32, device=dev)
        ctk = mk.transpose(-1, -2).contiguous()
        c2k = (mk * mk).sum(-1).contiguous()
        ks, ps = turns(
            lambda: kmeans_assign.kmeans_sweep_stats(xk, wk, ctk, c2k),
            lambda: onehot_sweep(xk, wk, ctk, c2k))
        b_ms, b_by = bound(bsz * n * (D + 1) * 4,
                           bsz * n * (2 * D * K + D))
        log(f"phase 5: kmeans_sweep_stats at ({bsz}, {n}): {ks[0]:.5f} / "
            f"{ks[1]:.5f} ms; assignment kernel + one-hot ops {ps[0]:.5f} / "
            f"{ps[1]:.5f} ms; bound {b_ms:.5f} ms by {b_by}")
    report["kernels"] = out


def phase_log_prob_times(dev, x, a, b, c, mu, var, lw, entry):
    """The row log density against what it replaces, each timed twice in
    turns: the kernel beside the per-component kernel + ``torch.logsumexp``
    (the earlier scoring) and beside cuBLAS (``torch.addmm`` of [x*x, x] and
    [A; B], built beforehand, TF32 off) + ``torch.logsumexp``; both entries
    at one 128-row request; then the whole fused ``_log_prob_block``
    (packing included) at 60,000 and 1,000,000 rows against the same two."""
    import torch
    from repro_torch.core.em import _log_prob_block
    from repro_torch.core.gmm import GMM
    from repro_torch.kernels import gmm_logpdf, ops

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    def composites(xs, a, b, c):
        xcat = torch.cat([xs * xs, xs], dim=1)
        wcat = torch.cat([a, b], dim=0)
        return (lambda: torch.logsumexp(gmm_logpdf.gmm_logpdf(xs, a, b, c),
                                        dim=-1),
                lambda: torch.logsumexp(torch.addmm(c, xcat, wcat), dim=-1))

    two_pass, cublas = composites(x, a, b, c)
    ks, ps = turns(lambda: gmm_logpdf.gmm_log_prob(x, a, b, c), two_pass)
    _, cs = turns(lambda: gmm_logpdf.gmm_log_prob(x, a, b, c), cublas)
    entry.update(composite_ms=min(ps), cublas_ms=min(cs))
    log(f"phase 5: gmm_log_prob at ({N_TRAIN}, {D}, {K}): {ks[0]:.5f} / "
        f"{ks[1]:.5f} ms; gmm_logpdf + torch.logsumexp {ps[0]:.5f} / "
        f"{ps[1]:.5f} ms; cuBLAS addmm + torch.logsumexp {cs[0]:.5f} / "
        f"{cs[1]:.5f} ms")
    xr = x[:REQUEST_ROWS]
    t = [graph_ms(lambda: torch.neg(xr)) for _ in range(2)]
    log(f"phase 5: the replay floor, one elementwise kernel on a "
        f"({REQUEST_ROWS}, {D}) tensor: {t[0]:.5f} / {t[1]:.5f} ms")
    for name, fn, nbytes in (
            ("gmm_logpdf", gmm_logpdf.gmm_logpdf, (D + K) * 4),
            ("gmm_log_prob", gmm_logpdf.gmm_log_prob, (D + 1) * 4)):
        t = [graph_ms(lambda: fn(xr, a, b, c)) for _ in range(2)]
        b_ms, b_by = bound(REQUEST_ROWS * nbytes, 4 * REQUEST_ROWS * D * K)
        log(f"phase 5: {name} at ({REQUEST_ROWS}, {D}, {K}): {t[0]:.5f} / "
            f"{t[1]:.5f} ms, bound {b_ms:.6f} ms by {b_by}")
    g = GMM(torch.exp(lw), mu, var)
    for n in (N_TRAIN, 1_000_000):
        gen = torch.Generator(device=dev).manual_seed(n)
        xs = 2.0 * torch.randn((n, D), generator=gen, device=dev)
        pa, pb, pc = ops.pack_params(g.means, g.covs, torch.log(g.weights))
        two_pass_block = lambda: torch.logsumexp(
            ops.gmm_logpdf(xs, g.means, g.covs, torch.log(g.weights)), dim=-1)
        _, cublas = composites(xs, pa, pb, pc)
        fused = lambda: _log_prob_block(g, xs, "fused")
        got, want = fused(), cublas()
        torch.cuda.synchronize()
        close(got, want, 2e-4, 2e-4, f"fused _log_prob_block vs cuBLAS at {n}")
        ks, ps = turns(fused, two_pass_block)
        _, cs = turns(fused, cublas)
        b_ms, b_by = bound(n * (D + 1) * 4, 4 * n * D * K)
        log(f"phase 5: fused _log_prob_block at ({n}, {D}, {K}): {ks[0]:.5f} "
            f"/ {ks[1]:.5f} ms (bound {b_ms:.5f} ms by {b_by}); "
            f"gmm_logpdf + torch.logsumexp {ps[0]:.5f} / {ps[1]:.5f} ms; "
            f"cuBLAS addmm + torch.logsumexp on pre-built operands "
            f"{cs[0]:.5f} / {cs[1]:.5f} ms")
        del xs, got, want


# ----------------------------------------------------------------------
# Phase 6: where the main path's device time goes
# ----------------------------------------------------------------------

def phase_trace(dev, report):
    """A second (warm) FedGenGMM run timed on the host clock, then the
    device time by kernel of a third under ``torch.profiler``. The runs
    fail the phase like any other; only an error of the profiler itself, or
    a trace with no device time, leaves the breakdown "not measured"."""
    import torch
    from repro_torch.api import FedGenGMM
    t0 = time.perf_counter()
    FedGenGMM(k_clients=K, k_global=K, h=H, device=dev.type).run(
        report["split"], seed=0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"phase 6: FedGenGMM fit, second (warm) run {warm:.3f} s")
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # the profiler only: report, do not fail
        log(f"phase 6: trace not measured ({type(err).__name__}: {err})")
        prof = None
    fed = FedGenGMM(k_clients=K, k_global=K, h=H, device=dev.type).run(
        report["split"], seed=0)
    torch.cuda.synchronize()
    for t in (fed.global_gmm.weights, fed.global_gmm.means,
              fed.global_gmm.covs):
        check(bool(torch.isfinite(t).all()), "non-finite global model in "
              "the profiled run")
    if prof is None:
        return
    try:
        prof.stop()
        by_name: dict = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us() / 1e3)
    except Exception as err:  # the profiler only: report, do not fail
        log(f"phase 6: trace not measured ({type(err).__name__}: {err})")
        return
    busy = sum(by_name.values())
    if busy <= 0:
        log("phase 6: trace not measured (no device time recorded)")
        return
    gemm = {name: ms for name, ms in by_name.items() if "gemm" in name.lower()}
    n_gemm = sum(1 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and "gemm" in ev.name.lower())
    log(f"phase 6: cuBLAS GEMM launches in the profiled fit: {n_gemm}, "
        f"{sum(gemm.values()):.3f} ms (on the fused path only label_stats' "
        f"one-hot products are matmuls)")
    log(f"phase 6: FedGenGMM fit device busy {busy:.3f} ms of "
        f"{warm * 1e3:.3f} ms warm unprofiled wall (idle share "
        f"{1 - busy / (warm * 1e3):.4f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"phase 6:   {ms:10.3f} ms  {name[:100]}")


def phase_request_trace(dev, report):
    """The device work of one 128-row anomaly request: phase 3's requests
    run again under ``torch.profiler``, their device events counted by
    name. Only an error of the profiler itself, or a trace with no device
    time, leaves it "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import FitConfig, log_prob
    rows, gmm = report["requests"], report["gmm"]
    cfg = FitConfig(device=dev.type)
    starts = range(0, len(rows), REQUEST_ROWS)

    def run():  # as phase 3 sends them; the scores are checked on the host
        for i in starts:
            scores = -log_prob(gmm, rows[i:i + REQUEST_ROWS], cfg).cpu()
            check(bool(torch.isfinite(scores).all()),
                  "non-finite request scores")

    run()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as err:  # the profiler only: report, do not fail
        log(f"phase 6: request trace not measured ({type(err).__name__}: "
            f"{err})")
        return
    run()
    torch.cuda.synchronize()
    try:
        prof.stop()
        by_name: dict = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                cnt, us = by_name.get(ev.name, (0, 0.0))
                by_name[ev.name] = (cnt + 1, us + ev.time_range.elapsed_us())
    except Exception as err:  # the profiler only: report, do not fail
        log(f"phase 6: request trace not measured ({type(err).__name__}: "
            f"{err})")
        return
    if not by_name:
        log("phase 6: request trace not measured (no device events)")
        return
    m = len(starts)
    kernels = sum(cnt for name, (cnt, _) in by_name.items()
                  if not name.startswith(("Memcpy", "Memset")))
    log(f"phase 6: {m} anomaly requests of {REQUEST_ROWS} rows: "
        f"{kernels / m:.2f} kernel launches and "
        f"{sum(us for _, us in by_name.values()) / m:.3f} us of device time "
        f"per request")
    for name, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"phase 6:   {cnt / m:5.2f} a request, {us / m:8.3f} us a "
            f"request  {name[:100]}")


# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# Phase 7: the paper's comparison on the card
# ----------------------------------------------------------------------

K_CANDIDATES = (10, 20, 30, 40)
ROUND_KERNELS = ("estep_stats", "kmeans_sweep_stats")
# BIC where it binds: a planted mixture of 6 components, 8 sigma and more
# apart, at d = 24; client c holds PLANTED_KC[c] of them (a window starting
# at component c), 250 rows each, so the true K_c are ragged.
PLANTED_K, PLANTED_ROWS, PLANTED_KC = 6, 250, (1, 2, 3, 4, 5, 6, 3, 2)
PLANTED_CANDIDATES = tuple(range(1, 8))


def planted_split(seed: int):
    """The planted clients as a padded ``ClientSplit``, and their rows."""
    import numpy as np
    from repro_torch.core.partition import ClientSplit

    rng = np.random.default_rng(seed)
    mus = rng.normal(0, 1.0, (PLANTED_K, D))
    parts, counts = [], []
    for c, kc in enumerate(PLANTED_KC):
        y = np.repeat((np.arange(kc) + c) % PLANTED_K, PLANTED_ROWS)
        parts.append((mus[y] + rng.normal(0, 0.4, (len(y), D)))
                     .astype(np.float32))
        counts.append(np.bincount(y, minlength=PLANTED_K))
    n = max(len(p) for p in parts)
    data = np.zeros((len(parts), n, D), np.float32)
    mask = np.zeros((len(parts), n), np.float32)
    for c, p in enumerate(parts):
        data[c, :len(p)], mask[c, :len(p)] = p, 1.0
    return (ClientSplit(data, mask, np.array([len(p) for p in parts]),
                        np.array(counts)), np.concatenate(parts))


def bic_where_it_binds(dev):
    """FedGenGMM with per-client and server-side BIC on the planted clients,
    on the card and on the CPU from the same seed: the card must select the
    planted, ragged K_c as the CPU does, merge and count them, and launch
    one ``gmm_log_prob`` per client and candidate. The synthetic rows are
    drawn on the model's device, so the two global models are held to each
    other only within 0.05 nats a row."""
    import numpy as np
    import torch
    from repro_torch.api import FedGenGMM, FitConfig, score
    from repro_torch.core.config import derive_seed
    from repro_torch.core.fedgen import train_locals_bic_cfg
    from repro_torch.fed.ledger import gmm_payload_floats

    split, x = planted_split(0)
    c = len(PLANTED_KC)
    out, took = {}, {}
    for where in (dev.type, "cpu"):
        t0 = time.perf_counter()
        cfg = FitConfig(device=where)
        reset_counts()
        fed = FedGenGMM(k_candidates=PLANTED_CANDIDATES, k_global=PLANTED_K,
                        h=H, config=cfg).run(split, seed=0)
        launches = kernel_counts()
        _, bics = train_locals_bic_cfg(
            derive_seed(0, "local"), torch.as_tensor(split.data).to(where),
            torch.as_tensor(split.mask).to(where), PLANTED_CANDIDATES, cfg)
        server = FedGenGMM(k_candidates=PLANTED_CANDIDATES, h=H,
                           config=cfg).run(split, seed=0)
        out[where] = (fed, bics, float(score(fed.global_gmm, x, config=cfg)),
                      server.global_gmm.n_components, launches)
        took[where] = time.perf_counter() - t0
    fed, bics, ll, k_server, launches = out[dev.type]
    cfed, cbics, cll, ck_server, _ = out["cpu"]
    ks = [g.n_components for g in fed.local_gmms]
    cks = [g.n_components for g in cfed.local_gmms]
    rel = max(abs(b[k] - cb[k]) / abs(cb[k])
              for b, cb in zip(bics, cbics) for k in PLANTED_CANDIDATES)
    rel_sel = max(abs(b[k] - cb[k]) / abs(cb[k])
                  for b, cb, k in zip(bics, cbics, ks))
    up = sum(gmm_payload_floats(k, D, True) + 1 for k in ks)
    log(f"phase 7: BIC where it binds (planted K_c {list(PLANTED_KC)}, "
        f"candidates {PLANTED_CANDIDATES}): card K_c {ks}, CPU K_c {cks}; "
        f"uplink {fed.comm.uplink_floats} floats (closed form {up}), |S| "
        f"{fed.synthetic.shape[0]}; BIC card against CPU: at the selected K "
        f"{rel_sel:.3e} relative (held to 1e-4), over every candidate "
        f"{rel:.3e}; global avg loglik card {ll:.6f}, CPU {cll:.6f}; "
        f"server-side K card {k_server}, CPU {ck_server}; gmm_log_prob "
        f"launches {launches['gmm_log_prob']}; took {took[dev.type]:.1f} s "
        f"on the card, {took['cpu']:.1f} s on the CPU")
    check(ks == cks == list(PLANTED_KC),
          f"BIC selected {ks} on the card, {cks} on the CPU, planted "
          f"{list(PLANTED_KC)}")
    check(len(set(ks)) > 1, "the planted K_c are not ragged")
    check(fed.comm.rounds == 1 and fed.comm.uplink_floats == up,
          f"uplink {fed.comm.uplink_floats} != closed form {up}")
    check(fed.synthetic.shape == (H * sum(ks), D)
          and fed.global_gmm.n_components == PLANTED_K,
          "the merged model does not follow the selected K_c")
    check(rel_sel <= 1e-4, f"selected-K BIC card against CPU {rel_sel}")
    check(abs(ll - cll) <= 0.05 and np.isfinite(ll),
          f"global avg loglik card {ll} against CPU {cll}")
    check(k_server == ck_server == PLANTED_K,
          f"server-side BIC chose {k_server} on the card, {ck_server} on the "
          f"CPU")
    check(launches["gmm_log_prob"] == c * len(PLANTED_CANDIDATES)
          and launches["estep_stats"] > 0,
          f"launches of the card's BIC run {launches}")


def device_busy_ms(fn):
    """Device busy time (ms) of ``fn()`` under ``torch.profiler``, summed
    over its device events; None where the profiler fails or records
    nothing (``fn`` itself fails the phase like any other call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception:  # the profiler only: report, do not fail
        return None
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
            busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        except Exception:  # the profiler only: report, do not fail
            busy = 0.0
    return busy / 1e3 or None


def counting_clients(split, dev):
    """Phase 3's split on the card as ``SplitClients`` whose
    ``reduce_clients`` (one call a round, plus FedKMeans' rescore) records
    the round kernels' launches of each call in ``per_call``."""
    from repro_torch.convert import split_to_clients
    from repro_torch.fed.runtime import SplitClients

    class Counting(SplitClients):
        def reduce_clients(self, *args, **kwargs):
            before = kernel_counts()
            out = super().reduce_clients(*args, **kwargs)
            after = kernel_counts()
            self.per_call.append({k: after[k] - before[k]
                                  for k in ROUND_KERNELS})
            return out

    base = split_to_clients(split, dev)
    clients = Counting(base.data, base.mask, base.sizes, split)
    clients.per_call = []
    return clients


def phase_paper_comparison(dev, report):
    """DEM (three inits), FedEM, FedKMeans and FedGenGMM with per-client BIC
    on phase 3's split, each run once timed and counted, then once under
    the profiler for its device busy time; then fused against reference
    DEM from one injected init."""
    import numpy as np
    import torch
    from repro_torch.api import (DEM, FedEM, FedGenGMM, FedKMeans,
                                 FitConfig, fit_federated, log_prob, score)
    from repro_torch.core.config import derive_seed
    from repro_torch.core.dem import DEMStrategy, _broadcast
    from repro_torch.core.fedgen import train_locals_bic_cfg
    from repro_torch.core.metrics import auc_pr
    from repro_torch.fed.runtime import run_rounds
    from repro_torch.fed.strategies import FedKMeansStrategy
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ds, split = report["ds"], report["split"]
    clients = counting_clients(split, dev)
    cfg = FitConfig(device=dev.type)
    rows = report["requests"]
    labels = np.r_[np.zeros(len(ds.x_test_in)), np.ones(len(ds.x_test_ood))]
    runs = [
        ("DEM separated", lambda: DEM(K, init="separated", config=cfg)),
        ("DEM pilot", lambda: DEM(K, init="pilot", config=cfg)),
        ("DEM fed-kmeans", lambda: DEM(K, init="fed-kmeans", config=cfg)),
        ("FedEM p=0.5 e=2", lambda: FedEM(K, participation=0.5,
                                          local_epochs=2, config=cfg)),
        ("FedKMeans", lambda: FedKMeans(K, config=cfg)),
        ("FedGenGMM BIC", lambda: FedGenGMM(k_candidates=K_CANDIDATES,
                                            k_global=K, h=H, config=cfg)),
    ]
    table = {}
    for name, make in runs:
        clients.per_call = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = make().run(clients, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        per_call, clients.per_call = clients.per_call, []
        busy = device_busy_ms(lambda: make().run(clients, seed=0))
        comm = res.comm
        line = (f"phase 7: {name}: {comm.rounds} rounds, uplink "
                f"{comm.uplink_floats} floats, downlink "
                f"{comm.downlink_floats} floats, {comm.total_mb:.4f} MiB; ")
        if name == "FedKMeans":
            inertia = float(res.inertia)
            check(np.isfinite(inertia), f"{name}: non-finite inertia")
            line += f"inertia {inertia:.6f}; "
            gmm = None
        else:
            gmm = res.global_gmm
            for t in (gmm.weights, gmm.means, gmm.covs):
                check(bool(torch.isfinite(t).all()),
                      f"{name}: non-finite global model")
            ll = float(score(gmm, ds.x_train, config=cfg))
            auc = auc_pr(-log_prob(gmm, rows, cfg).cpu().numpy(), labels)
            check(np.isfinite(ll) and 0 <= auc <= 1, f"{name}: bad scores")
            line += f"avg loglik {ll:.6f}, AUC-PR {auc:.6f}; "
        idle = ("not measured" if busy is None
                else f"{1 - busy / (wall * 1e3):.4f}")
        busy_s = "not measured" if busy is None else f"{busy:.3f} ms"
        log(line + f"wall {wall:.3f} s; device busy of a second, profiled "
            f"run {busy_s} (idle share of the wall {idle}); launches "
            f"{launches}")
        if name.startswith(("DEM", "FedEM", "FedKMeans")):
            kern = ("kmeans_sweep_stats" if name == "FedKMeans"
                    else "estep_stats")
            post = 1 if name == "FedKMeans" else 0
            check(len(per_call) == comm.rounds + post,
                  f"{name}: {len(per_call)} client reductions for "
                  f"{comm.rounds} rounds")
            per = [c[kern] for c in per_call]
            check(min(per) > 0, f"{name}: a round launched no {kern}")
            budget = 100 if name == "FedKMeans" else 200
            log(f"phase 7:   {kern} launches a round: {min(per)}..{max(per)}"
                f"; converged {res.converged}"
                + (" (ran to max_iter)" if comm.rounds >= budget else ""))
        else:
            ks = [g.n_components for g in res.local_gmms]
            check(all(k in K_CANDIDATES for k in ks),
                  f"{name}: a K_c outside {K_CANDIDATES}: {ks}")
            log(f"phase 7:   selected K_c {ks} (sum {sum(ks)}, |S| "
                f"{res.synthetic.shape[0]})")
            report["fedgen_bic_gmm"] = gmm
            # the same local fits again (FedGenStrategy's seed path), for
            # every client's BIC at every candidate
            _, bics = train_locals_bic_cfg(derive_seed(0, "local"),
                                           clients.data, clients.mask,
                                           K_CANDIDATES, cfg)
            falling = sum(all(b[u] > b[v] for u, v in zip(
                K_CANDIDATES, K_CANDIDATES[1:])) for b in bics)
            small, large = (int(np.argmin(split.sizes)),
                            int(np.argmax(split.sizes)))
            log(f"phase 7:   BIC falls through every candidate for "
                f"{falling} of {CLIENTS} clients; BIC by K of the smallest "
                f"client ({split.sizes[small]} rows) "
                f"{ {k: round(v, 1) for k, v in bics[small].items()} }, of "
                f"the largest ({split.sizes[large]} rows) "
                f"{ {k: round(v, 1) for k, v in bics[large].items()} }")
        table[name] = (comm, wall)
    fg, fg_wall = table["FedGenGMM BIC"]
    log("phase 7: Table 4 on the card: FedGenGMM (BIC) 1 round, "
        f"{fg.uplink_floats} uplink floats, {fg_wall:.3f} s; " + "; ".join(
            f"{n}: {c.rounds} rounds ({c.rounds}x), {c.uplink_floats} uplink "
            f"floats ({c.uplink_floats / fg.uplink_floats:.1f}x), {w:.3f} s"
            for n, (c, w) in table.items() if n.startswith("DEM")))

    # a FedKMeansStrategy built directly, with its default backend
    clients.per_call = []
    direct = fit_federated(clients, strategy=FedKMeansStrategy(k=K), seed=0,
                           config=cfg, max_rounds=100)
    per = [c["kmeans_sweep_stats"] for c in clients.per_call]
    clients.per_call = []
    log(f"phase 7: FedKMeansStrategy(k={K}) through fit_federated: "
        f"{direct.comm.rounds} rounds, inertia {float(direct.inertia):.6f}, "
        f"kmeans_sweep_stats launches a round {min(per)}..{max(per)}")
    check(len(per) == direct.comm.rounds + 1 and min(per) > 0,
          "a directly built FedKMeansStrategy round launched no "
          "kmeans_sweep_stats")

    # the broadcast: the global model expanded to the 20 clients and packed
    gb = _broadcast(report["fedgen_bic_gmm"], CLIENTS)
    pack = graph_ms(lambda: ops.pack_params(gb.means, gb.covs,
                                            torch.log(gb.weights)))
    log(f"phase 7: packing the broadcast model for one E-step launch at "
        f"({CLIENTS}, {K}, {D}): {pack:.5f} ms by graph replay")

    # fused against reference DEM from one injected init
    gmm0 = DEMStrategy(k=K, backend="reference").init_state(0, clients).gmm
    for tol, max_rounds, held in ((1e-3, 200, True), (0.0, 30, False)):
        out = {}
        for backend in ("fused", "reference"):
            strat = DEMStrategy(k=K, backend=backend, tol=tol)
            out[backend] = run_rounds(strat, clients, device=dev,
                                      max_rounds=max_rounds,
                                      state0=strat.state_from_gmm(gmm0))
        diff = abs(float(out["fused"].log_likelihood)
                   - float(out["reference"].log_likelihood))
        log(f"phase 7: DEM from one injected init, tol={tol}, max "
            f"{max_rounds} rounds: rounds fused {out['fused'].n_rounds}, "
            f"reference {out['reference'].n_rounds}; |ll fused - ll "
            f"reference| = {diff:.3e}"
            + (" (held to 1e-4)" if held else " (reported)"))
        if held:
            check(diff <= 1e-4, f"fused and reference DEM differ by {diff} "
                  f"> 1e-4 at tol={tol}")
    bic_where_it_binds(dev)
    log(f"phase 7: took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 8: serving
# ----------------------------------------------------------------------

# benchmarks/serve_bench.py's stream: request sizes drawn uniformly, the
# number of requests, arrivals a micro-batch
SERVE_SIZES = (16, 64, 200, 512, 3000)
SERVE_REQUESTS, SERVE_ARRIVALS, RESP_REQUESTS = 400, 4, 40
SERVE_KERNELS = ("gmm_log_prob", "gmm_logpdf")
# Limits of the responsibilities on the card (max abs), against softmax of
# the plain per-component version on the same packed operands, and against
# GMM.responsibilities, which sums the same f32 terms in another arrangement.
# Log densities are of order 1e3 at MNIST width, so the f32 sums differ by
# ~1e-4: on an H100 the two read 1.185e-4 and 1.297e-4.
RESP_ATOL_PLAIN, RESP_ATOL_GMM = 5e-4, 5e-4


def serve_stream(rows, seed: int, n: int):
    """``n`` requests of sizes drawn uniformly from SERVE_SIZES, each of
    rows drawn with replacement from ``rows``."""
    import numpy as np
    from repro_torch.serve import ScoreRequest
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(SERVE_SIZES), size=n)
    return [ScoreRequest(i, rows[rng.integers(0, len(rows), SERVE_SIZES[p])])
            for i, p in enumerate(picks)]


class PackCounter:
    """While entered, counts the calls of ``ops.pack_params`` (the engine
    and ``api.log_prob`` both reach it through the module)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._orig = 0, ops.pack_params

        def counted(*args):
            self.calls += 1
            return self._orig(*args)
        ops.pack_params = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.pack_params = self._orig


def drive_serving(eng, reqs, kernel, publish_at=None, publish=None):
    """Trickle ``reqs`` into ``eng``, SERVE_ARRIVALS a micro-batch (calling
    ``publish()`` once ``publish_at`` requests are in), stepping until every
    request retires. Returns (results by rid, submit-to-retire seconds by
    rid, wall seconds, one (wrapper launches of ``kernel``, replays,
    captures, packings, installs) tuple a step); every step here has
    requests in its slots."""
    from repro_torch.serve import engine as serve_engine
    results, lat, steps, submitted_at = {}, {}, [], {}

    def state(packs):
        return (kernel_counts()[kernel], eng.replays, serve_engine.captures,
                packs.calls, eng.swaps)

    with PackCounter() as packs:
        t0 = time.perf_counter()
        submitted = 0
        while submitted < len(reqs) or eng.pending_requests:
            for req in reqs[submitted:submitted + SERVE_ARRIVALS]:
                eng.submit(req)
                submitted_at[req.rid] = time.perf_counter()
            submitted = min(submitted + SERVE_ARRIVALS, len(reqs))
            if publish_at is not None and submitted >= publish_at:
                publish()
                publish_at = None
            before = state(packs)
            done = eng.step()
            now = time.perf_counter()
            steps.append(tuple(a - b for a, b in zip(state(packs), before)))
            for res in done:
                results[res.rid] = res
                lat[res.rid] = now - submitted_at[res.rid]
        wall = time.perf_counter() - t0
    return results, lat, wall, steps


def check_steps(steps, what):
    """Every step without an install replayed the graph once and launched,
    captured and packed nothing from the host; an install step also packed
    and captured once, the wrapper called twice (the warm-up and the
    capture)."""
    steady = [s for s in steps if s[4] == 0]
    installs = [s for s in steps if s[4] > 0]
    check(all(s[:4] == (0, 1, 0, 0) for s in steady),
          f"{what}: a steady step did not replay once without launching, "
          f"capturing or packing: {sorted(set(s[:4] for s in steady))}")
    check(all(s[:4] == (2, 1, 1, 1) for s in installs),
          f"{what}: an install step did not warm up, capture and pack once: "
          f"{installs}")
    return len(steady), installs


def profiled(fn):
    """Run ``fn`` under ``torch.profiler`` -> (its result, {device event
    name: (count, us)}). A profiler that fails or sees no device event
    fails the phase: the serving path's device launches are read here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            cnt, us = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (cnt + 1, us + ev.time_range.elapsed_us())
    check(by_name, "the profiler saw no device events")
    return out, by_name


def device_launches(by_name) -> int:
    """Launches of the log-density kernel (either entry) in a trace."""
    return sum(cnt for name, (cnt, _) in by_name.items()
               if "logpdf_kernel" in name)


def slab_walls(eng, reps: int = 200):
    """Host wall (ms) of one micro-batch's device round trip (copy in,
    score, copy out, sync) through ``eng``'s graph replay and through the
    same step run eagerly, timed in turns (replay, eager, replay, eager)
    over ``reps`` calls each -> (replay ms, eager ms), two values each."""
    graph = eng._graph
    walls = {"replay": [], "eager": []}
    for _ in range(2):
        for route in ("replay", "eager"):
            eng._graph = graph if route == "replay" else None
            eng._run_slab()
            t0 = time.perf_counter()
            for _ in range(reps):
                eng._run_slab()
            walls[route].append((time.perf_counter() - t0) / reps * 1e3)
    eng._graph = graph
    return walls["replay"], walls["eager"]


def replay_ms(graph, reps: int = 50) -> float:
    """Mean device time of one replay of ``graph`` between CUDA events."""
    import torch
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_stats(results, lat, wall):
    import numpy as np
    ms = np.array(list(lat.values())) * 1e3
    admit = np.array([r.latency_s for r in results.values()]) * 1e3
    rows = sum(r.num_rows for r in results.values())
    return (f"submit-to-retire p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms (admission-to-retire, the "
            f"engine's latency_s: p50 {np.percentile(admit, 50):.3f} ms, p99 "
            f"{np.percentile(admit, 99):.3f} ms); {len(results) / wall:.1f} "
            f"requests/s, {rows / wall:.1f} rows/s ({len(results)} requests, "
            f"{rows} rows in {wall:.4f} s)")


def serving_trace(dev, gmm, rows):
    """The device work of steady micro-batches: a fresh 8 x 512 engine
    serves 60 requests of the stream under ``torch.profiler``; its device
    events are counted by name per step, and the log-density kernel must
    run once a step. Returns its device launches."""
    from repro_torch.serve import ScoreConfig, ScoringEngine
    eng = ScoringEngine(gmm, ScoreConfig(mode="anomaly", backend="fused",
                                         device=dev.type))
    reqs = serve_stream(rows, 81, 60)
    (_, _, _, steps), by_name = profiled(
        lambda: drive_serving(eng, reqs, "gmm_log_prob"))
    check_steps(steps, "profiled serving run")
    m = len(steps)
    check(device_launches(by_name) == m,
          f"profiled serving run: {device_launches(by_name)} log-density "
          f"kernels on the device in {m} micro-batches")
    log(f"phase 8: {m} steady micro-batches at 8 x 512 under the profiler: "
        f"{sum(c for c, _ in by_name.values()) / m:.2f} device operations "
        f"and {sum(us for _, us in by_name.values()) / m:.3f} us of device "
        f"time a step")
    for name, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        log(f"phase 8:   {cnt / m:5.2f} a step, {us / m:8.3f} us a step  "
            f"{name[:100]}")
    return device_launches(by_name)


def phase_serving(dev, report):
    """Phase 3's global model served to the stream at 8 x 512, then at
    8 x 1024 with phase 3's central GMM published mid-stream into a
    ``ModelStore`` the engine follows; the geometry, replay and
    responsibilities checks; the step's device work and times."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.api import FitConfig, log_prob
    from repro_torch.kernels import gmm_logpdf, ops, ref
    from repro_torch.serve import (ModelStore, ScoreConfig, ScoreRequest,
                                   ScoringEngine)

    t_phase = time.perf_counter()
    rows = np.concatenate([report["ds"].x_test_in, report["ds"].x_test_ood])
    gmm, central = report["gmm"], report["central_gmm"]
    reqs = serve_stream(rows, 8, SERVE_REQUESTS)
    fused = FitConfig(backend="fused", device=dev.type)
    served = {name: 0 for name in KERNELS}

    def config(slots, rows_per_slot, mode="anomaly"):
        return ScoreConfig(mode=mode, slots=slots, rows_per_slot=rows_per_slot,
                           backend="fused", device=dev.type)

    def read_counts():
        for name, n in kernel_counts().items():
            served[name] += n

    def packed(g):
        return ops.pack_params(g.means, g.covs, torch.log(g.weights))

    def bits(results, gmms, what):
        """Each result has the bits of -api.log_prob under its version, and
        lies within phase 2's tolerance of the plain version."""
        operands = {v: packed(g) for v, g in gmms.items()}
        err = 0.0
        for rid, res in results.items():
            g = gmms[res.model_version]
            want = -log_prob(g, reqs[rid].rows, fused).cpu().numpy()
            check(np.array_equal(res.scores, want),
                  f"{what}: request {rid} differs from -api.log_prob")
            x = torch.as_tensor(reqs[rid].rows, device=dev)
            plain = -ref.gmm_log_prob_packed(x, *operands[res.model_version])
            err = max(err, close(torch.as_tensor(res.scores), plain.cpu(),
                                 2e-4, 2e-4, f"{what}: request {rid} vs "
                                 f"the plain version"))
        return err

    total_rows = sum(r.num_rows for r in reqs)
    log(f"phase 8: stream of {len(reqs)} anomaly requests, {total_rows} "
        f"rows (sizes {SERVE_SIZES}, {SERVE_ARRIVALS} arrivals a step), "
        f"d = {D}, K = {K}")

    # each geometry serves phase 3's global model alone
    step_ms, res512 = {}, None
    for slots, rps in ((8, 512), (8, 1024)):
        reset_counts()
        eng = ScoringEngine(gmm, config(slots, rps), version=1)
        check(eng.graph is not None, "the fused engine on the card captured "
              "no graph")
        res, lat, wall, steps = drive_serving(eng, reqs, "gmm_log_prob")
        read_counts()
        check_steps(steps, f"{slots} x {rps}")
        check(sorted(res) == list(range(len(reqs))),
              f"{slots} x {rps} dropped a request")
        err = bits(res, {1: gmm}, f"{slots} x {rps}")
        log(f"phase 8: {slots} x {rps}: {len(steps)} micro-batches, each one "
            f"replay and no launch, capture or packing from the host; "
            f"capture at install {eng.capture_s[0] * 1e3:.3f} ms; max abs "
            f"err against the plain version {err:.3e}; "
            f"{serve_stats(res, lat, wall)}")
        step_ms[slots * rps] = replay_ms(eng.graph)
        replay_wall, eager_wall = slab_walls(eng)
        log(f"phase 8: {slots} x {rps}: a micro-batch's device round trip "
            f"(copy in, score, copy out, sync), host wall by replay "
            f"{replay_wall[0]:.5f} / {replay_wall[1]:.5f} ms, run eagerly "
            f"{eager_wall[0]:.5f} / {eager_wall[1]:.5f} ms (in turns)")
        if rps == 512:
            res512, eng512 = res, eng
    # one full step, replayed and eager
    pick = np.random.default_rng(9).integers(0, len(rows), (8, 512))
    for i in range(8):
        eng512.submit(ScoreRequest(10_000 + i, rows[pick[i]]))
    eng512.step()
    torch.cuda.synchronize()
    check(torch.equal(eng512._out, eng512._score()), "the replayed step "
          "differs from the same step run eagerly")

    # other pool geometries give the same bits
    for slots, rps in ((3, 64), (1, 256)):
        got = {r.rid: r.scores for r in ScoringEngine(
            gmm, config(slots, rps)).run(reqs[:40])}
        check(all(np.array_equal(got[i], res512[i].scores)
                  for i in range(40)),
              f"a {slots} x {rps} pool gives other bits than 8 x 512")

    # 8 x 1024 following a store, a second model published mid-stream
    with tempfile.TemporaryDirectory() as root:
        publisher = ModelStore(root, device=dev.type)
        publisher.publish(gmm, {"model": "FedGenGMM"})
        reset_counts()
        eng2 = ScoringEngine.from_store(ModelStore(root, device=dev.type),
                                        config(8, 1024))
        res1024, lat2, wall2, steps2 = drive_serving(
            eng2, reqs, "gmm_log_prob", publish_at=len(reqs) // 2,
            publish=lambda: publisher.publish(central, {"model": "central"}))
        read_counts()
    n_steady2, installs = check_steps(steps2, "8 x 1024 with a swap")
    check(sorted(res1024) == list(range(len(reqs))), "8 x 1024 dropped a "
          "request across the swap")
    versions = [res1024[rid].model_version for rid in range(len(reqs))]
    check(versions == sorted(versions) and set(versions) == {1, 2},
          f"the version does not flip at one admission boundary: "
          f"{sorted(set(versions))}")
    check(eng2.swaps == 1 and len(eng2.swap_pauses) == 1 and len(installs)
          == 1, f"8 x 1024: {eng2.swaps} swaps, {len(installs)} install "
          f"steps")
    err = bits(res1024, {1: gmm, 2: central}, "8 x 1024 with a swap")
    boundary = versions.index(2)
    log(f"phase 8: 8 x 1024 following a store, with a swap: {len(steps2)} "
        f"micro-batches ({n_steady2} steady: one replay, no launch, capture "
        f"or packing; the install step {installs[0]} wrapper launches, "
        f"replays, captures, packings, installs); max abs err against the "
        f"plain version {err:.3e}; version 1 for requests 0..{boundary - 1}, 2 "
        f"from {boundary}; swap pause {eng2.swap_pauses[0] * 1e3:.3f} ms; "
        f"captures {[round(c * 1e3, 3) for c in eng2.capture_s]} ms; "
        f"{serve_stats(res1024, lat2, wall2)}")

    # responsibilities through the per-component kernel, under the profiler
    rreqs = reqs[:RESP_REQUESTS]
    reset_counts()
    eng3 = ScoringEngine(gmm, config(8, 512, "responsibilities"))
    (res_r, _, _, steps3), trace3 = profiled(
        lambda: drive_serving(eng3, rreqs, "gmm_logpdf"))
    read_counts()
    check_steps(steps3, "responsibilities")
    served_device = {"gmm_logpdf": device_launches(trace3)}
    check(served_device["gmm_logpdf"] == len(steps3),
          f"responsibilities: {served_device['gmm_logpdf']} gmm_logpdf "
          f"kernels on the device in {len(steps3)} micro-batches")
    # held to softmax of the plain version on the engine's packed operands,
    # and to GMM.responsibilities, each at a fixed limit
    operands = packed(gmm)
    err_plain = err_gmm = 0.0
    for rid, res in res_r.items():
        x = torch.as_tensor(rreqs[rid].rows, device=dev)
        plain = torch.softmax(ref.gmm_logpdf_packed(x, *operands), dim=1)
        want = gmm.responsibilities(x).cpu().numpy()
        check(res.scores.shape == want.shape, "responsibilities shape")
        check(np.abs(res.scores.sum(1) - 1.0).max() <= 1e-5,
              "responsibilities rows do not sum to 1 within 1e-5")
        err_plain = max(err_plain, float(np.abs(
            res.scores - plain.cpu().numpy()).max()))
        err_gmm = max(err_gmm, float(np.abs(res.scores - want).max()))
    log(f"phase 8: responsibilities, {len(rreqs)} requests at 8 x 512: "
        f"{len(steps3)} micro-batches, {served_device['gmm_logpdf']} "
        f"gmm_logpdf kernels on the device; max abs err against softmax of "
        f"the plain version {err_plain:.3e} (limit {RESP_ATOL_PLAIN}), "
        f"against GMM.responsibilities {err_gmm:.3e} (limit "
        f"{RESP_ATOL_GMM}); rows sum to 1 within 1e-5")
    check(len(res_r) == len(rreqs) and err_plain <= RESP_ATOL_PLAIN
          and err_gmm <= RESP_ATOL_GMM,
          f"responsibilities: {err_plain} from the plain version (limit "
          f"{RESP_ATOL_PLAIN}), {err_gmm} from GMM.responsibilities (limit "
          f"{RESP_ATOL_GMM})")

    # the step's device work and times
    served_device["gmm_log_prob"] = serving_trace(dev, gmm, rows)
    a, b, c = ops.pack_params(gmm.means, gmm.covs, torch.log(gmm.weights))
    for n, ms in step_ms.items():
        x = torch.as_tensor(
            rows[np.random.default_rng(n).integers(0, len(rows), n)],
            device=dev)
        kern = [graph_ms(lambda: gmm_logpdf.gmm_log_prob(x, a, b, c))
                for _ in range(2)]
        b_ms, b_by = bound(n * (D + 1) * 4, 4 * n * D * K)
        log(f"phase 8: a {n}-row step by graph replay {ms:.5f} ms; the "
            f"gmm_log_prob kernel alone at ({n}, {D}, {K}) {kern[0]:.5f} / "
            f"{kern[1]:.5f} ms, bound {b_ms:.5f} ms by {b_by}")
    for name in SERVE_KERNELS:
        check(served[name] > 0, f"kernel {name} was not launched on the "
              f"serving path")
    for entry in report["kernels"]:
        entry.update(
            launches_by_path={"fedgengmm": entry["launches"],
                              "serving": served[entry["name"]]},
            serving_device_launches=served_device.get(entry["name"], 0))
    log(f"phase 8: wrapper launches on the serving runs {served}; on the "
        f"device in the traced runs {served_device}; took "
        f"{time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the repository (src/repro_torch) is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.config import fused_native, resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"phase 1: python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}")
    failures = []
    report: dict = {}
    try:
        check(fused_native(dev), "the card is not a compute-capability 9.x "
              "(Hopper) device")
        t0 = time.perf_counter()
        seconds = _build.build()
        log(f"phase 1: built {list(seconds)} in "
            f"{time.perf_counter() - t0:.1f} s (per nvcc: "
            f"{ {k: round(v, 1) for k, v in seconds.items()} })")
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line):
                    log(f"phase 1: {name}: {line.strip()[:160]}")
    except Exception:
        traceback.print_exc()
        failures.append("build")
    phases = [("kernels", phase_kernels), ("main path", phase_main_path),
              ("em agreement", phase_em_agreement), ("times", phase_times),
              ("trace", phase_trace), ("request trace", phase_request_trace),
              ("paper comparison", phase_paper_comparison),
              ("serving", phase_serving)]
    for name, fn in phases:
        if failures:
            log(f"skipping phase {name!r} after a failure")
            continue
        try:
            fn(dev, report)
        except Exception:
            traceback.print_exc()
            failures.append(name)
    if failures:
        print(f"chip_smoke.py: FAILED phases: {failures}", file=sys.stderr)
        return 1
    log(f"main path wall time {report['total_s']:.3f} s (fit "
        f"{report['fit_s']:.3f} s); global ll {report['ll']:.6f}, central ll "
        f"{report['ll_central']:.6f}, AUC-PR {report['auc']:.6f}")
    log(json.dumps({"kernels": report["kernels"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
