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
     kernel test shapes, at the main path's shapes and at phases 8's and
     9's (serving slabs; out-of-core blocks as a batch of one under a 0/1
     mask with a ragged tail, the restarts' pilot sweeps, a 2-D label-pass
     block through ``ops.kmeans_assign``), with the tolerances of
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
     micro-batch, latency, throughput, swap pause and capture time;
  9. out of core, at phase 3's width: (a) FedGenGMM over phase 3's 20
     clients as unpadded ``.npy`` files, S replayed from a
     ``SyntheticGMMSource``, its quality held to phase 3's resident run
     (avg log-likelihood within 1%, AUC-PR within 0.02) and its global
     model bit-identical over ``ArraySource``s and over ``ConcatSource``s
     of uneven shards; (b) a ``GMMEstimator`` over an ``NpyFileSource`` of
     the 60,000 rows at chunk 8192 from phase 4's init against the
     resident fit, on both backends (the same iterations, within 1e-4);
     (c) synthetic streams of 2^22 and 2^20 rows fitted in peak memory
     within 10% of each other, with their passes, wall and device time;
     (d) a 384 MiB ``.npy`` file scored and fitted at prefetch depth 0
     and 2, at chunks 65,536 and 8,192, bit-identical to each other and to
     an ``ArraySource`` on the card, with the wall a pass, host-to-device
     GB/s and the idle share of a profiled pass (busy and wall of one run;
     a profiler that fails or sees no device time fails the phase);
 10. uplink transforms and async rounds on phase 3's data: (a)
     ``FedGenGMM(dp=DPConfig(eps))`` at eps 0.25, 1 and 4 (quality,
     ``epsilon_spent``, every released client model a valid GMM and the
     bits of its own round-0 stream, over the split and over 20
     ``ArraySource``s); (b) DEM (fed-kmeans) and FedEM under
     ``GaussianDP(1, rounds=30)``, one ``estep_stats`` a round a local
     epoch; (c) ``StochasticQuantize(8)`` at one byte an element,
     ``PairwiseMask`` bit-identical to no transform (DEM, FedEM), one
     masked round's int32 channel equal to the unmasked lattice sum,
     ``Compose`` spending as ``GaussianDP``, FedKMeans quantized, and the
     round wall of DEM under each transform; (d) ``run_async`` with
     buffer = cohort and no lookahead bit-identical to ``run_rounds`` on
     the split, on 20 ArraySources and with a ``CyclicSampler``; (e) the
     comm bench's async knobs over 1,000 Dirichlet(0.5) clients, 400
     buffered combines against 40 synchronous rounds from one state, with
     the staleness histogram, final quality, wall and idle share; (f) DEM
     over 20 single-block ``.npy`` clients and over 4 clients of 2^20
     rows in 16 blocks each, serially and on a ``ClientExecutor`` of one
     and of four workers, bit-identical, the walls in turns. Phase 2 also
     holds ``estep_stats`` at (e)'s batches (16 and 64 clients padded to
     the largest client, each under its own 0/1 mask);
 11. the mesh runtime at world size 1 (``torch.distributed`` with NCCL over
     a ``file://`` store, a one-rank ``"data"`` ``DeviceMesh``), continual
     FedGenGMM and split-merge EM on phase 3's data: (a) ``fedgen_sharded``
     bit-identical to ``fedgengmm_cfg`` with one all-gather; (b) DEM from
     phase 7's fed-kmeans centers, FedEM (participation 0.5, 2 local
     epochs) and FedKMeans sharded, each timed in turns with its
     single-process run, with phase 7's rounds, bits and Table 4 ledger,
     one all-reduce a round (read from ``ShardedClients.collectives``) and
     one ``estep_stats`` a round a local epoch (DEM, FedEM) or one
     ``kmeans_sweep_stats`` a round (FedKMeans); (c) sharded DEM over 4
     rounds under ``Identity`` and ``PairwiseMask`` bit-identical to no
     transform, under ``GaussianDP(2, rounds=4)`` not; (d) ``run_async
     (mesh=)`` sync-equivalent bit-identical to ``run_rounds(mesh=)``; (e)
     continual FedGenGMM over three windows of the 60,000 rows, each split
     over 20 clients, memory 0.5, one round a window, each window scored;
     (f) ``split_merge_fit`` on each of the 20 clients at K = 30, never
     below the plain fit by more than 1e-5, both walls, and the
     split-merge locals aggregated and scored. The sharded walls are
     printed beside the single-process ones and the card's name and power
     limit;
 12. the transformer substrate's serving path at internlm2-1.8b's full
     width (24 layers, d_model 2048, GQA 16/8, vocab 92,544; weights from
     seed 0, bf16 matrices, an f32 copy from the same draw): (a) the build
     and its 1,889,110,016 parameters; (b) decode against prefill in f32
     (TF32 off, bound 1e-3) and bf16 (reported), ring-buffer decode
     against windowed full-cache decode in f32; (c)
     ``repro_torch.launch.serve.ServeEngine`` on the JAX serve CLI's stream
     with the FedGenGMM activation monitor attached (one ``observe`` a
     batch) and on a heavier stream, every request served with its
     budget, a request with same-length peers against its solo run in f32,
     TTFT, latency, decode ms a step, tokens/s, peak memory and one
     profiled batch's idle share; (d) the monitor at full width: four
     clients' local fits, one FedGenGMM round, 64 ID against 64 OOD
     sequences scored, through ``kmeans_sweep_stats``, ``estep_stats`` and
     ``gmm_log_prob`` (phase 2 holds them at these shapes), the scores
     against the plain version;
 13. the substrate's training path and its MoE family: (a) internlm2-1.8b
     trained at full width and depth (f32 masters from seed 0, bf16
     compute, remat on) for 10 steps of ``batches(0, 92544, 4, 1024, 10)``
     at lr 3e-4, every step's loss, nll, grad_norm and lr (the port's
     ``schedule``), the median step wall, tokens/s, model TFLOP/s as
     6 N tokens / step wall, peak memory and one profiled step's idle
     share, the loss falling; (b) the smoke configs of internlm2-1.8b,
     deepseek-moe-16b and mixtral-8x7b in f32 (TF32 off), masters built on
     the CPU and copied to the card, three ``train_step``s on each device,
     loss, grad_norm and the parameters after step 1 within 1e-4
     relative; (c) remat on against off and the chunked loss against the
     single shot, one step's loss and gradients within 1e-5 (f32, smoke
     width, S = 1,024); (d) deepseek-moe-16b whole (28 layers, 16.4e9
     parameters, bf16) behind ``ServeEngine`` on phase 12's two streams,
     the monitor attached to the cli stream's engine (one ``observe`` a
     batch), the monitor's fits, round and scoring at its width through
     the three kernels, and f32 decode against prefill on a 4-layer copy
     at the drop-free capacity factor; (e) deepseek-moe-16b cut to 2
     layers (its dense layer and one MoE layer) trained 5 steps, every
     expert, the router and the shared experts given gradients, and
     mixtral-8x7b cut to 2 layers in f32: a 4,160-token prompt past its
     4,096 window, then 8 decode steps through the ring cache against the
     full cache with the window mask;
 14. the RG-LRU, xLSTM and encoder-decoder families: (a)
     recurrentgemma-9b whole (38 layers, 11,712,739,328 parameters, bf16
     with ``log_lambda`` f32) behind ``ServeEngine`` on the JAX CLI's
     stream with the monitor attached and on a stream past its 2,048-token
     local window (8 requests of 2,100-2,600 tokens, 16 new, batch 4,
     context 2,688), then the monitor at its width (scores within 2e-4 of
     the plain version; OOD against ID reported, not gated); (b) the same
     model in f32 (TF32 off) at full depth on a 2,100-token prompt:
     decode against the full forward and ring decode (capacity 2,048)
     against windowed decode, within 1e-3; (c) recurrentgemma-9b cut to
     one pattern group (3 layers, full width) trained 10 steps of
     ``batches(0, 256000, 2, 1024, 10)``, losses falling, every RG-LRU
     leaf given a gradient; (d) xlstm-350m whole served on the CLI stream
     with the monitor, trained 10 steps of ``batches(0, 50304, 8, 512,
     10)`` (the chunked mLSTM) with one profiled step, and cut to two
     layers in f32: one step on the card against the CPU within 1e-4 in
     loss and grad norm; (e) seamless-m4t-medium whole trained 10 steps
     through ``launch.train.train`` with its ``src_embeds``, f32 decode
     with the cross-attention cache against the full forward within 1e-3,
     and the monitor on batches with ``src_embeds``; (f) one RG-LRU (B =
     1, S = 2,048), mLSTM and sLSTM (B = 8, S = 1,024) cell at full width,
     forward and forward+backward under the profiler: device busy against
     wall, device ops a call, the largest device items;
 15. the sharding context, the production mesh and the dry-run: (a)
     internlm2-1.8b at full width and depth on a (data=1, model=1) NCCL
     mesh from ``launch.mesh.make_host_mesh``, its parameters laid out by
     ``param_specs`` through ``to_shardings`` as ``DTensor``s with the
     ``sharding_ctx`` axes set: phase 12's CLI batch prefilled and 8
     decode steps, and one train step on phase 13's first batch, against
     the plain path on the same weights (the same bits, or the
     substrate's bounds), both timed; (b) ``python -m
     repro_torch.launch.dryrun`` on 13 cells (internlm2-1.8b's four shapes
     on both meshes, deepseek-moe-16b train_4k, mixtral-8x7b long_500k,
     recurrentgemma-9b decode_32k, seamless-m4t-medium prefill_32k,
     xlstm-350m train_4k) in 7 subprocesses over fake groups of 256 and
     512 ranks, every cell exiting 0 with its argument bytes the specs'
     sum; (c) the dry-run's live-bytes tracker over phase 13's train step
     at world size 1, its peak within 25% of the card's.

The last two lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``. A kernel's ``launches`` there is phase
3's main-path count; ``launches_by_path`` adds phase 8's serving runs (the
wrapper's launches: a warm-up and a capture at each install, since a replay
does not call it), phase 9 (a)'s out-of-core run with its scoring over
sources, phase 10's runs (``uplink_async``) and phase 11's
(``mesh_continual_splitmerge``), phase 12's (``transformer_serving``) and
phase 13's (``transformer_training_moe``) and phase 14's
(``transformer_recurrent_encdec``; phase 15 launches none of the five),
and ``serving_device_launches``
the kernel's launches that the profiler saw on the device in phase 8's
traced runs (one a micro-batch). Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
import json
import math
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
# Phase 9's block shapes. A source block is padded to pad_target rows with a
# 0/1 mask: 65,536 (DEFAULT_SOURCE_CHUNK) in a multi-block stream, 8,192 in
# (b), a multiple of 64 for a one-block stream (a client of 7,320 rows pads
# to 7,360; the 60,000 training rows to 60,032). E-step blocks as (rows,
# valid rows); the 4 restarts' pilot sweeps as (restarts, rows); the score
# blocks' rows.
OOC_ESTEP_BLOCKS = [(65536, 65536), (65536, 40000), (8192, 8192),
                    (8192, 60000 - 7 * 8192), (7360, 7320), (60032, 60000)]
OOC_SWEEP_SHAPES = [(4, 65536), (4, 7360)]
OOC_LOGPDF_ROWS = (65536, 60032)


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

    def estep_case(c_, n, d, k, seed, valid=None):
        """Uniform row weights, or with ``valid`` a padded block's 0/1 mask:
        ``valid`` leading ones (one count, or one per client), then a
        zero-weight pad."""
        rng = np.random.default_rng(seed)
        x, mu, var, lw = model_inputs(rng, n, d, k, dev, batch=c_)
        w = (rng.uniform(0, 1, (c_, n)) if valid is None else
             np.broadcast_to(np.arange(n) < np.reshape(valid, (-1, 1)),
                             (c_, n)).astype(np.float32))
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
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
        """``bsz`` None: one 2-D block through ``ops.kmeans_assign``, as
        the out-of-core label pass calls it."""
        x, mu, _, _ = model_inputs(np.random.default_rng(seed), n, d, k, dev,
                                   batch=bsz or 1)
        if centers is not None:
            mu = centers
        ct = mu.transpose(-1, -2).contiguous()
        c2 = (mu * mu).sum(-1).contiguous()
        if bsz is None:
            idx, d2 = (t[None] for t in ops.kmeans_assign(x[0], mu[0]))
        else:
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
    # phase 9's scoring blocks: a full 65,536-row block and the 60,000
    # training rows as one block padded to 60,032
    ooc_errs = [logpdf_case(n, D, K, 40 + i)
                for i, n in enumerate(OOC_LOGPDF_ROWS)]
    # phase 11 (e)'s scoring of one window's 20,000 rows
    window_errs = logpdf_case(N_TRAIN // CONTINUAL_WINDOWS, D, K, 60)
    cases = [full_errs, request_errs, window_errs] + slab_errs + ooc_errs
    errs["gmm_logpdf"] = max(e[0] for e in cases)
    errs["gmm_log_prob"] = max(e[1] for e in cases)
    rows_stable(15)
    errs["estep_stats"] = max(estep_case(CLIENTS, N_PAD, D, K, 2),
                              estep_case(1, N_SYNTH, D, K, 3),
                              # tile edges: 64 rows a tile
                              estep_case(2, 64 * 70, D, K, 12),
                              estep_case(3, 64 * 70 + 1, D, K, 13),
                              # phase 9's blocks: a batch of one under the
                              # source's 0/1 mask, full and ragged
                              *(estep_case(1, n, D, K, 50 + i, valid=v)
                                for i, (n, v) in enumerate(OOC_ESTEP_BLOCKS)))
    # phase 10 (e)'s batches: the 1,000-client split padded to its largest
    # client, each client under its own 0/1 mask
    width, batches = async_estep_batches()
    errs["estep_stats"] = max(errs["estep_stats"], *(
        estep_case(len(v), width, D, K, 500 + i, valid=v)
        for i, v in enumerate(batches)))
    # phase 11's fits. (e): each window's 20 clients at the window's padded
    # width, each under its own 0/1 mask (the local E-step; the 4 restarts'
    # pilot sweeps and the local Lloyd sweeps), and the refit with the old
    # global model as one more client, h(CK + K) rows. (f): the unmasked
    # 2-D fit of each client's own |D_c| rows (the E-step; the pilot sweeps
    # and the Lloyd sweeps of its k-means init)
    sweeps = []
    for i, (_, split_w) in enumerate(continual_windows()):
        width = split_w.data.shape[1]
        errs["estep_stats"] = max(errs["estep_stats"], estep_case(
            CLIENTS, width, D, K, 600 + i, valid=split_w.sizes))
        sweeps += [(CLIENTS * 4, width), (CLIENTS, width)]
    errs["estep_stats"] = max(errs["estep_stats"],
                              estep_case(1, CONTINUAL_SYNTH, D, K, 610))
    sweeps.append((1, CONTINUAL_SYNTH))
    client_rows = [int(n) for n in main_split().sizes]
    for i, n in enumerate(client_rows):
        errs["estep_stats"] = max(errs["estep_stats"],
                                  estep_case(1, n, D, K, 700 + i, valid=n))
        sweeps += [(4, n), (1, n)]
    # phase 12's monitor: a local fit's and the server refit's E-step and
    # sweeps at d = 32, and a scoring call of MON_SCORED sequences
    errs["estep_stats"] = max(errs["estep_stats"], *(
        estep_case(1, n, d, k, 800 + i)
        for i, (n, d, k) in enumerate(MON_ESTEP_SHAPES)))
    sweeps_d = [(bsz, n, d, k, 810 + i)
                for i, (bsz, n, d, k) in enumerate(MON_SWEEP_SHAPES)]
    errs["gmm_log_prob"] = max(errs["gmm_log_prob"], logpdf_case(
        MON_SCORED, MON_DIM, MON_K_GLOBAL, 820)[1])
    errs["kmeans_assign"] = max(assign_case(CLIENTS, N_PAD, D, K, 4)[0],
                                assign_case(1, N_SYNTH, D, K, 5)[0],
                                # phase 9's label pass: one 2-D block
                                assign_case(None, BIG_CHUNK, D, K, 8)[0])
    errs["kmeans_sweep_stats"] = max(
        [sweep_case(bsz, n, D, K, 20 + i)
         for i, (bsz, n) in enumerate(SWEEP_SHAPES + OOC_SWEEP_SHAPES
                                      + sweeps)]
        + [sweep_case(*shape) for shape in sweeps_d])
    # ties: every center duplicated, so each row has two nearest centers
    rng = np.random.default_rng(6)
    base = torch.as_tensor(rng.normal(0, 2, (1, 8, D)), dtype=torch.float32,
                           device=dev)
    dup = torch.cat([base, base], dim=1)
    _, idx, eidx = assign_case(1, 4096, D, 16, 7, centers=dup)
    check(bool(torch.all(idx < 8)) and torch.equal(idx, eidx),
          "kmeans_assign does not resolve ties to the first index")
    log(f"phase 2: estep_stats held at phase 10 (e)'s {len(batches)} "
        f"batches: {sorted({len(v) for v in batches})} clients x {width} "
        f"padded rows, {min(int(v.min()) for v in batches)}.."
        f"{max(int(v.max()) for v in batches)} valid rows a client")
    log(f"phase 2: estep_stats and kmeans_sweep_stats held at phase 11's "
        f"shapes: (e)'s windows "
        + ", ".join(f"{CLIENTS} x {sp.data.shape[1]} ({int(sp.sizes.min())}"
                    f"..{int(sp.sizes.max())} valid)"
                    for _, sp in continual_windows())
        + f" and the {CONTINUAL_SYNTH:,}-row refit; (f)'s {CLIENTS} unmasked "
        f"clients of {min(client_rows)}..{max(client_rows)} rows; "
        f"gmm_log_prob at (e)'s {N_TRAIN // CONTINUAL_WINDOWS:,} rows")
    log(f"phase 2: estep_stats, kmeans_sweep_stats and gmm_log_prob held "
        f"at phase 12's monitor shapes: E-steps (rows, d, K) "
        f"{MON_ESTEP_SHAPES}, sweeps (batch, rows, d, K) {MON_SWEEP_SHAPES}, "
        f"scoring ({MON_SCORED}, {MON_DIM}, {MON_K_GLOBAL})")
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
    from repro_torch.fed.ledger import gmm_payload_floats

    t0 = time.perf_counter()
    ds, split = mnist_data(), main_split()
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
    report["g_central"] = g_central
    g_local = init_from_kmeans(1, clients.data, K, clients.mask,
                               assign_backend="reference")
    report["g_local"] = g_local
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
    # the one PyTorch call that computes gmm_logpdf's (N, K) output: cuBLAS
    # addmm on the pre-built [x*x, x] and [A; B] with c as the bias, TF32
    # off (kernel and library call in turns)
    xcat = torch.cat([x * x, x], dim=1)
    wcat = torch.cat([a, b], dim=0)
    close(torch.addmm(c, xcat, wcat), gmm_logpdf.gmm_logpdf(x, a, b, c),
          2e-4, 2e-4, "torch.addmm against gmm_logpdf")
    ks, ls = turns(rows["gmm_logpdf"][0], lambda: torch.addmm(c, xcat, wcat))
    out[0]["library_ms"] = min(ls)
    log(f"phase 5: gmm_logpdf at ({N_TRAIN}, {D}, {K}): {ks[0]:.5f} / "
        f"{ks[1]:.5f} ms; torch.addmm on pre-built [x*x, x], [A; B] + c "
        f"(TF32 off) {ls[0]:.5f} / {ls[1]:.5f} ms")
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
        report.setdefault("paper_runs", {})[name] = res
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


# The kernel of ``torch.cuda._sleep``: the markers that open and close a
# profiled window. They tell a trace cut short at either end apart from a
# kernel that never launched (ROADMAP Queue C, R7)
PROFILER_MARKER = "spin_kernel"
# Markers that open a profiled window, a millisecond apart. A trace drops a
# prefix of its window's device events: the first one as a rule, at times a
# few steps' worth (phase 8's serving run once counted 20, once 7, of its 23
# steps' events, every kind short alike; ROADMAP Queue C, R7). The markers
# take that prefix, and one of them must survive it
PROFILER_OPENING = 32


def profiled(fn):
    """Run ``fn`` under ``torch.profiler`` -> (its result, {device event
    name: (count, us)}), the markers left out. The window opens on a
    drained device and ``PROFILER_OPENING`` markers (``torch.cuda._sleep``),
    each drained; then ``fn`` runs and the device is drained; a closing
    marker runs and is drained in turn, and only then does the window
    close. A profiler that fails, sees no device event, or whose trace
    does not begin with an opening marker and end with the closing one
    fails the phase: the serving path's device launches are read here, and
    a lost marker says the trace, not the path, fell short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_OPENING):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(1e-3)
        out = fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = sorted((ev.time_range.start, ev.name, ev.time_range.elapsed_us())
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA)
    check(events, "the profiler saw no device events")
    check(PROFILER_MARKER in events[0][1], "the profiler's trace lost every "
          "marker that opens its window")
    check(PROFILER_MARKER in events[-1][1], "the profiler's trace lost the "
          "marker that closes its window")
    by_name: dict = {}
    for _, name, us in events:
        if PROFILER_MARKER not in name:
            cnt, total = by_name.get(name, (0, 0.0))
            by_name[name] = (cnt + 1, total + us)
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


# ----------------------------------------------------------------------
# Phase 9: out of core
# ----------------------------------------------------------------------

OOC_CHUNK = 8192          # (b): 60,000 rows in 8 blocks, a ragged tail
BIG_ROWS = (1 << 22, 1 << 20)   # (c): above SyntheticGMMSource's cache
BIG_CHUNK = 65536         # DEFAULT_SOURCE_CHUNK
BIG_ITERS = 20            # (c): EM iterations after the streamed init
FILE_ROWS = 1 << 22       # (d): 384 MiB of f32 rows at d = 24
# (d): EM iterations at each chunk (64 and 512 blocks a pass)
FILE_EM_ITERS = {BIG_CHUNK: 5, OOC_CHUNK: 1}


def counting_source(inner):
    """``inner`` wrapped in a DataSource that counts the blocks it yields
    (``.blocks``)."""
    from repro_torch.data.sources import DataSource

    class Counting(DataSource):
        blocks = 0
        num_rows = property(lambda self: inner.num_rows)
        dim = property(lambda self: inner.dim)
        dtype = property(lambda self: inner.dtype)
        device = property(lambda self: inner.device)

        def iter_blocks(self, chunk_size):
            for block in inner.iter_blocks(chunk_size):
                self.blocks += 1
                yield block

    return Counting()


def drain(source, chunk_size):
    """One pass over ``source``'s blocks, nothing kept."""
    for _ in source.iter_blocks(chunk_size):
        pass


def same_bits(a, b) -> bool:
    """Equal models, bit for bit (GMMs or tensors)."""
    import torch
    if hasattr(a, "means"):
        return all(torch.equal(u, v) for u, v in zip(
            (a.weights, a.means, a.covs), (b.weights, b.means, b.covs)))
    return torch.equal(a, b)


def profiled_busy(fn):
    """(device busy ms, wall ms, {kernel name: ms}, device ops) of one run
    of ``fn()``
    under ``torch.profiler``, tracing the device only (recording every host
    op of a fit slows it many times over). Busy is the union of the device
    events' intervals (a copy on its own stream may overlap a kernel), wall
    the same run's, so the idle share 1 - busy / wall is read from one
    window; device ops counts the device events. A profiler that fails or
    records no device time fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    spans = []
    # the raw trace: building ``prof.events()``' tree in Python takes
    # minutes for a training step of the sLSTM loop
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0.0) \
                + ev.duration_ns() / 1e6
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    busy, reach = 0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    check(busy > 0, "the profiler recorded no device time")
    return busy / 1e6, wall, by_name, len(spans)


# The entries the out-of-core path launches: the E-step and the Lloyd sweeps
# block by block, the assignment entry in the init's label pass, the row log
# density in scoring over sources.
OOC_KERNELS = ("gmm_log_prob", "estep_stats", "kmeans_assign",
               "kmeans_sweep_stats")
OUR_KERNELS = ("estep_kernel", "logpdf_kernel", "sweep_kernel",
               "reduce_kernel")


def ooc_federated(dev, report, workdir):
    """(a) FedGenGMM over phase 3's 20 clients as unpadded .npy files, the
    replay set S a SyntheticGMMSource; the same run over ArraySources and
    over ConcatSources of uneven shards; quality against phase 3."""
    import numpy as np
    import torch
    from repro_torch.api import FedGenGMM, FitConfig, log_prob, score
    from repro_torch.core.metrics import auc_pr
    from repro_torch.data.sources import (ArraySource, ConcatSource,
                                          DataSource, NpyFileSource)
    from repro_torch.fed.ledger import gmm_payload_floats

    split, ds = report["split"], report["ds"]
    shards = [np.ascontiguousarray(split.data[c, :int(split.sizes[c])])
              for c in range(split.data.shape[0])]
    paths = []
    for c, rows in enumerate(shards):
        paths.append(workdir / f"client{c:02d}.npy")
        np.save(paths[-1], rows)
    cfg = FitConfig(device=dev.type)

    def run(clients):
        return FedGenGMM(k_clients=K, k_global=K, h=H,
                         device=dev.type).run(clients, seed=0)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = run([NpyFileSource(p) for p in paths])
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    # scoring over sources: the training rows as the clients' files, the
    # anomaly rows as one ArraySource
    ll = float(score(fed.global_gmm,
                     ConcatSource([NpyFileSource(p) for p in paths]),
                     config=cfg))
    rows = report["requests"]
    scores = -log_prob(fed.global_gmm, ArraySource(rows), cfg).cpu().numpy()
    torch.cuda.synchronize()
    launches = kernel_counts()
    labels = np.r_[np.zeros(len(ds.x_test_in)), np.ones(len(ds.x_test_ood))]
    auc = auc_pr(scores, labels)
    t0 = time.perf_counter()
    warm = run([NpyFileSource(p) for p in paths])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    comm = fed.comm
    up = CLIENTS * (gmm_payload_floats(K, D, True) + 1)
    iters = [int(r.n_iter) for r in fed.local_results]
    log(f"phase 9 (a): FedGenGMM over {CLIENTS} NpyFileSources: first run "
        f"{first:.3f} s, warm run {warm_s:.3f} s; global avg loglik "
        f"{ll:.6f} (resident, phase 3: {report['ll']:.6f}), AUC-PR "
        f"{auc:.6f} (resident {report['auc']:.6f}); |S| "
        f"{fed.synthetic.num_rows} replayed from a "
        f"{type(fed.synthetic).__name__}; local EM iterations {iters}")
    log(f"phase 9 (a): comm {comm._asdict()}; launches on the out-of-core "
        f"path (the first run and its scoring) {launches}")
    check(isinstance(fed.synthetic, DataSource)
          and fed.synthetic.num_rows == N_SYNTH, "S is not a replay source")
    check(comm.rounds == 1 and comm.uplink_floats == up,
          f"uplink_floats {comm.uplink_floats} != closed form {up}")
    check(same_bits(fed.global_gmm, warm.global_gmm),
          "the warm run's global model differs from the first run's")
    check(np.isfinite(ll) and np.isfinite(scores).all(), "non-finite scores")
    for name in OOC_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the out-of-core path")
    for what, clients in (
            ("ArraySources", [ArraySource(r) for r in shards]),
            ("ConcatSources of 3 uneven shards", [ConcatSource(
                [ArraySource(r[:len(r) // 7]),
                 ArraySource(r[len(r) // 7:len(r) // 2]),
                 ArraySource(r[len(r) // 2:])]) for r in shards])):
        other = run(clients)
        check(same_bits(fed.global_gmm, other.global_gmm),
              f"FedGenGMM over {what} differs from the .npy run")
        log(f"phase 9 (a): FedGenGMM over {what}: global model bit-identical "
            f"to the .npy run")
    ll_gap = abs(ll - report["ll"]) / abs(report["ll"])
    auc_gap = abs(auc - report["auc"])
    log(f"phase 9 (a): against the resident run: avg loglik {ll_gap:.4%} "
        f"apart (held to 1%), AUC-PR {auc_gap:.6f} apart (held to 0.02)")
    check(ll_gap <= 0.01 and auc_gap <= 0.02,
          f"out-of-core FedGenGMM quality: avg loglik {ll_gap:.4%} and "
          f"AUC-PR {auc_gap:.6f} from the resident run")
    report["ooc_launches"] = launches


def ooc_parity(dev, report, workdir):
    """(b) GMMEstimator over an NpyFileSource of the 60,000 training rows at
    chunk 8192 from phase 4's injected init, against the resident
    fit_gmm_cfg at the same chunk, on both backends; then the 20 clients'
    files (written by (a)), one block each, against the resident local
    fits from phase 4's local init."""
    import numpy as np
    import torch
    from repro_torch.api import FitConfig, GMMEstimator
    from repro_torch.convert import split_to_clients
    from repro_torch.core.em import fit_gmm_cfg
    from repro_torch.data.sources import NpyFileSource

    path = workdir / "train.npy"
    np.save(path, report["ds"].x_train.astype(np.float32))
    x = torch.as_tensor(report["ds"].x_train, device=dev)
    g0 = report["g_central"]
    for backend in ("fused", "reference"):
        cfg = FitConfig(backend=backend, chunk_size=OOC_CHUNK,
                        device=dev.type)
        src = GMMEstimator(K, config=cfg).fit(NpyFileSource(path),
                                              init_gmm=g0).result_
        res = fit_gmm_cfg(0, x, K, cfg, init_gmm=g0)
        diff = abs(float(src.log_likelihood) - float(res.log_likelihood))
        bits = same_bits(src.gmm, res.gmm)
        log(f"phase 9 (b): {backend}: source fit {int(src.n_iter)} "
            f"iterations, avg loglik {float(src.log_likelihood):.6f}; "
            f"resident {int(res.n_iter)} iterations, "
            f"{float(res.log_likelihood):.6f}; |diff| {diff:.3e} (held to "
            f"1e-4); models bit-identical: {bits}")
        check(int(src.n_iter) == int(res.n_iter) and diff <= 1e-4,
              f"(b) {backend}: the source fit and the resident fit differ")
    # single-block clients: each of phase 3's clients is one block of its
    # .npy file (padded to a multiple of 64), fitted from phase 4's local
    # init, against the 20 resident local fits as one batch
    clients = split_to_clients(report["split"], dev)
    g_local = report["g_local"]
    cfg = FitConfig(backend="fused", device=dev.type)
    res = fit_gmm_cfg(0, clients.data, K, cfg, clients.mask,
                      init_gmm=g_local)
    worst, bits, iters = 0.0, 0, []
    for c in range(CLIENTS):
        src = fit_gmm_cfg(0, NpyFileSource(workdir / f"client{c:02d}.npy"),
                          K, cfg, init_gmm=g_local[c])
        check(int(src.n_iter) == int(res.n_iter[c]),
              f"(b) client {c}: {int(src.n_iter)} source iterations against "
              f"{int(res.n_iter[c])} resident")
        iters.append(int(src.n_iter))
        worst = max(worst, abs(float(src.log_likelihood)
                               - float(res.log_likelihood[c])))
        bits += same_bits(src.gmm, res.gmm[c])
    log(f"phase 9 (b): {CLIENTS} single-block client fits over .npy files "
        f"against the resident batch, fused, from phase 4's local init: "
        f"iterations {iters} in both, max |diff| {worst:.3e} (held to "
        f"1e-4), {bits} of {CLIENTS} models bit-identical")
    check(worst <= 1e-4, f"(b) single-block client fits differ by {worst}")


def ooc_constant_memory(dev, report):
    """(c) GMMEstimator(30, max_iter=20) over SyntheticGMMSources of 2^22
    and 2^20 rows drawn from phase 3's global model (regenerated every
    pass): peak memory, passes, device busy share, the device time of
    seeding and generation beside the kernels'."""
    import numpy as np
    import torch
    from repro_torch.api import FitConfig, GMMEstimator, score
    from repro_torch.core.kmeans import kmeans_plusplus_streaming
    from repro_torch.data.sources import SyntheticGMMSource

    gmm = report["gmm"]
    cfg = FitConfig(chunk_size=BIG_CHUNK, max_iter=BIG_ITERS,
                    device=dev.type)
    peaks = {}
    for n in BIG_ROWS:
        src = counting_source(SyntheticGMMSource(gmm, n, seed=n))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        est = GMMEstimator(K, config=cfg).fit(src, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        peaks[n] = peak
        blocks = src.blocks
        nb = src.num_blocks(BIG_CHUNK)
        fit_ll = float(est.result_.log_likelihood)
        own = float(score(gmm, SyntheticGMMSource(gmm, n, seed=n),
                          config=cfg))
        log(f"phase 9 (c): {n} rows ({nb} blocks of {BIG_CHUNK}): fit "
            f"{wall:.3f} s, {blocks} blocks read ({blocks / nb:.0f} passes), "
            f"{int(est.result_.n_iter)} EM iterations; peak memory above "
            f"the start {peak / 2**20:.1f} MiB; fit avg loglik {fit_ll:.6f}, "
            f"the generating model's own {own:.6f}")
        check(blocks >= 2 * nb, f"(c) only {blocks} blocks read")
        check(bool(torch.isfinite(est.gmm_.means).all())
              and np.isfinite(fit_ll), "(c) non-finite fit")
        report.setdefault("ooc_big", {})[n] = (wall, blocks // nb, fit_ll)
    big, small = peaks[BIG_ROWS[0]], peaks[BIG_ROWS[1]]
    log(f"phase 9 (c): peak memory {big / 2**20:.1f} MiB at {BIG_ROWS[0]} "
        f"rows against {small / 2**20:.1f} MiB at {BIG_ROWS[1]} (held "
        f"within 10%)")
    check(abs(big - small) <= 0.1 * max(big, small),
          f"(c) peak memory grows with N: {big} against {small} bytes")
    # the same 2^20 rows materialized on the card and fitted by the
    # resident path, for the optimum the k-means init and tol reach there
    n = BIG_ROWS[1]
    x = SyntheticGMMSource(gmm, n, seed=n).materialize(BIG_CHUNK)
    res = GMMEstimator(K, config=cfg).fit(x, seed=0).result_
    log(f"phase 9 (c): the same {n} rows resident on the card: avg loglik "
        f"{float(res.log_likelihood):.6f} after {int(res.n_iter)} EM "
        f"iterations (the source fit {report['ooc_big'][n][2]:.6f})")
    del x, res

    # where the device time goes, at 2^20 rows: busy and wall of one
    # profiled fit, beside the unprofiled wall above
    n = BIG_ROWS[1]
    src = SyntheticGMMSource(gmm, n, seed=n)
    busy, wall, by_name, _ = profiled_busy(
        lambda: GMMEstimator(K, config=cfg).fit(src, seed=0))
    gen, _, _, _ = profiled_busy(lambda: drain(src, BIG_CHUNK))
    seed_busy, _, _, _ = profiled_busy(lambda: kmeans_plusplus_streaming(
        0, src, K, BIG_CHUNK, dev, n_init=4))
    ours = sum(ms for name, ms in by_name.items()
               if any(k in name for k in OUR_KERNELS))
    passes = report["ooc_big"][n][1]
    log(f"phase 9 (c): {n} rows, one profiled fit: device busy {busy:.3f} "
        f"ms of its {wall:.3f} ms wall (idle share {1 - busy / wall:.4f}; "
        f"unprofiled wall {report['ooc_big'][n][0] * 1e3:.3f} ms); the "
        f"CUDA kernels {ours:.3f} ms; generating one pass {gen:.3f} ms "
        f"(x {passes} passes = {gen * passes:.3f} ms); the streamed "
        f"k-means++ seeding of 4 restarts, {K} passes, {seed_busy:.3f} ms, "
        f"of which generation {gen * K:.3f} ms")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"phase 9 (c):   {ms:10.3f} ms  {name[:100]}")


def ooc_host_file(dev, report, workdir):
    """(d) an NpyFileSource of 2^22 x 24 f32 rows (384 MiB): one score pass
    and EM from an injected init (5 iterations at chunk 65,536, 1 at 8,192,
    where a block's host work on the consumer's side is no longer small
    beside its copy) at prefetch depth 0 and 2, bit-identical between the
    depths and to an ArraySource over the same rows on the card; wall a
    pass, host-to-device GB/s, idle share."""
    import numpy as np
    import torch
    from repro_torch.api import FitConfig, score
    from repro_torch.core.em import fit_gmm_cfg
    from repro_torch.data import sources
    from repro_torch.data.sources import (ArraySource, NpyFileSource,
                                          SyntheticGMMSource)

    gmm = report["gmm"]
    path = workdir / "big.npy"
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(FILE_ROWS, D))
    gen = SyntheticGMMSource(gmm, FILE_ROWS, seed=3, cache_rows=0)
    at = 0
    for block in gen.iter_blocks(BIG_CHUNK):
        out[at:at + block.shape[0]] = block.cpu().numpy()
        at += block.shape[0]
    out.flush()
    del out
    nbytes = FILE_ROWS * D * 4
    x = torch.as_tensor(np.load(path), device=dev)
    walls = {}
    saved = sources.PREFETCH_DEPTH
    try:
        for chunk, iters in FILE_EM_ITERS.items():
            cfg = FitConfig(chunk_size=chunk, device=dev.type)
            em_cfg = cfg.replace(tol=0.0, max_iter=iters)
            results = {}
            for depth in (0, 2, 0, 2):
                sources.PREFETCH_DEPTH = depth
                src = NpyFileSource(path)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s = score(gmm, src, config=cfg)
                torch.cuda.synchronize()
                t_pass = time.perf_counter() - t0
                t0 = time.perf_counter()
                res = fit_gmm_cfg(0, src, K, em_cfg, init_gmm=gmm)
                torch.cuda.synchronize()
                t_em = time.perf_counter() - t0
                busy, wall, _, _ = profiled_busy(
                    lambda: score(gmm, src, config=cfg))
                log(f"phase 9 (d): chunk {chunk}, depth {depth}: score pass "
                    f"{t_pass:.3f} s ({nbytes / t_pass / 1e9:.2f} GB/s host "
                    f"to device), {iters} EM iterations {t_em:.3f} s "
                    f"({t_em / iters:.3f} s a pass); one profiled "
                    f"score pass: device busy {busy:.3f} ms of its "
                    f"{wall:.3f} ms wall (idle share {1 - busy / wall:.4f})")
                walls.setdefault((chunk, depth), []).append(t_pass + t_em)
                results.setdefault(depth, (s, res))
            s_res = score(gmm, ArraySource(x), config=cfg)
            r_res = fit_gmm_cfg(0, ArraySource(x), K, em_cfg, init_gmm=gmm)
            for depth, (s, res) in results.items():
                check(torch.equal(s, s_res),
                      f"(d) the score at chunk {chunk}, depth {depth} "
                      f"differs")
                check(same_bits(res.gmm, r_res.gmm)
                      and torch.equal(res.log_likelihood,
                                      r_res.log_likelihood),
                      f"(d) the EM fit at chunk {chunk}, depth {depth} "
                      f"differs")
            log(f"phase 9 (d): chunk {chunk}: score {float(s_res):.6f} and "
                f"the {iters}-iteration fit (avg loglik "
                f"{float(r_res.log_likelihood):.6f}) bit-identical at depth "
                f"0, depth 2 and from an ArraySource on the card")
    finally:
        sources.PREFETCH_DEPTH = saved
    for chunk, iters in FILE_EM_ITERS.items():
        d0, d2 = min(walls[(chunk, 0)]), min(walls[(chunk, 2)])
        log(f"phase 9 (d): chunk {chunk}: a score pass and {iters} EM "
            f"iterations, best of two, {d0:.3f} s at depth 0 and "
            f"{d2:.3f} s at depth 2 (depth 2 / depth 0 = {d2 / d0:.4f})")


def phase_out_of_core(dev, report):
    """Phase 9: the out-of-core path at phase 3's width, (a)-(d)."""
    import tempfile
    from pathlib import Path as _Path
    import torch

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workdir = _Path(tmp)
        for part, fn in (("a", ooc_federated), ("b", ooc_parity),
                         ("c", lambda dev, report, _: ooc_constant_memory(
                             dev, report)),
                         ("d", ooc_host_file)):
            t0 = time.perf_counter()
            fn(dev, report, workdir)
            log(f"phase 9 ({part}): took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    for entry in report["kernels"]:
        entry["launches_by_path"]["out_of_core"] = \
            report["ooc_launches"][entry["name"]]
    log(f"phase 9: took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 10: uplink transforms and async rounds
# ----------------------------------------------------------------------

DP_EPSILONS = (0.25, 1.0, 4.0)     # BENCH_comm.json's privacy epsilons
DP_DELTA = 1e-5
DP_ROUNDS = 30                     # the iterative arms' round budget
TIMED_ROUNDS = 10                  # (c): rounds of one timed DEM run
# (e): benchmarks/fed_bench.py's async knobs at MNIST width
ASYNC_CLIENTS, ASYNC_COHORT, ASYNC_BUFFER = 1000, 64, 16
ASYNC_LOOKAHEAD, ASYNC_ALPHA = 240, 0.5
ASYNC_COMBINES, SYNC_ROUNDS = 400, 40
EXECUTOR_WORKERS = 4
# (f)'s second workload: clients whose step is many blocks out of a file
EXECUTOR_FILE_CLIENTS, EXECUTOR_FILE_ROWS, EXECUTOR_FILE_ROUNDS = \
    4, 1 << 20, 3


@functools.lru_cache(maxsize=None)
def mnist_data():
    """Phase 3's data: mnist_like with 60,000 training rows from seed 0."""
    import numpy as np
    from repro_torch.data.datasets import mnist_like
    return mnist_like(np.random.default_rng(0), n_train=N_TRAIN)


@functools.lru_cache(maxsize=None)
def main_split():
    """Phase 3's split: the 60,000 rows over 20 Dirichlet(0.5) clients."""
    import numpy as np
    from repro_torch.core.partition import partition
    ds = mnist_data()
    return partition(np.random.default_rng(0), ds.x_train, ds.y_train,
                     CLIENTS, "dirichlet", 0.5)


@functools.lru_cache(maxsize=None)
def continual_windows():
    """Phase 11 (e)'s windows: (rows, split) of each of CONTINUAL_WINDOWS
    consecutive slices of the 60,000 rows, window w split over the 20
    clients by Dirichlet(0.5) from seed w."""
    import numpy as np
    from repro_torch.core.partition import partition
    ds = mnist_data()
    n = N_TRAIN // CONTINUAL_WINDOWS
    out = []
    for w in range(CONTINUAL_WINDOWS):
        x, y = ds.x_train[w * n:(w + 1) * n], ds.y_train[w * n:(w + 1) * n]
        out.append((x, partition(np.random.default_rng(w), x, y, CLIENTS,
                                 "dirichlet", 0.5)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def async_population():
    """(e)'s padded split: the 60,000 rows over 1,000 Dirichlet(0.5)
    clients."""
    import numpy as np
    from repro_torch.core.partition import partition
    ds = mnist_data()
    return partition(np.random.default_rng(0), ds.x_train, ds.y_train,
                     ASYNC_CLIENTS, "dirichlet", 0.5)


def async_estep_batches():
    """(padded rows, [valid rows of each client of a batch]) of (e)'s E-step
    launches over one cycle of CyclicSampler(1000, 64): every 64-client
    cohort (the sync arm) and its 16-client buffer groups (the async
    arm)."""
    from repro_torch.fed import CyclicSampler
    pop = async_population()
    sampler = CyclicSampler(ASYNC_CLIENTS, ASYNC_COHORT)
    batches = []
    for rnd in range(-(-ASYNC_CLIENTS // ASYNC_COHORT)):
        ids = sampler.cohort(rnd)
        batches.append(pop.sizes[ids])
        batches += [pop.sizes[ids[i:i + ASYNC_BUFFER]]
                    for i in range(0, ASYNC_COHORT, ASYNC_BUFFER)]
    return pop.data.shape[1], batches


def synced(fn):
    """(result, wall s) of ``fn()``, the wall ended by a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def quality(gmm, report, cfg):
    """(avg log-likelihood over the training rows, AUC-PR of phase 3's
    anomaly rows) of a global model."""
    import numpy as np
    from repro_torch.api import log_prob, score
    from repro_torch.core.metrics import auc_pr
    ds = report["ds"]
    labels = np.r_[np.zeros(len(ds.x_test_in)), np.ones(len(ds.x_test_ood))]
    ll = float(score(gmm, ds.x_train, config=cfg))
    auc = auc_pr(-log_prob(gmm, report["requests"], cfg).cpu().numpy(),
                 labels)
    check(np.isfinite(ll) and 0 <= auc <= 1, "non-finite quality")
    return ll, auc


def round_launches(clients, kern, per_round, rounds, what, post=0):
    """Every round of a counted run launched ``kern`` ``per_round``
    times."""
    per = [c[kern] for c in clients.per_call]
    clients.per_call = []
    check(len(per) == rounds + post,
          f"{what}: {len(per)} client reductions for {rounds} rounds")
    check(all(p == per_round for p in per[:rounds]),
          f"{what}: {kern} launches a round {sorted(set(per))}, not "
          f"{per_round}")
    return per


def uplink_dp_one_shot(dev, report, clients):
    """(a) FedGenGMM(dp=DPConfig(eps)) at the privacy epsilons: quality,
    epsilon spent, a valid released GMM per client, and each release the
    client's own round-0 stream over the split and over ArraySources."""
    import numpy as np
    import torch
    from repro_torch.api import DPConfig, FedGenGMM, FitConfig
    from repro_torch.data.sources import ArraySource
    from repro_torch.fed.transforms import VAR_MAX, VAR_MIN, uplink_key

    cfg = FitConfig(device=dev.type)
    split = report["split"]

    def released_from_own_stream(res, dp, what):
        t = dp.transform()
        members = np.arange(len(res.local_gmms))
        for i, (r, g) in enumerate(zip(res.local_results, res.local_gmms)):
            check(bool(torch.isclose(g.weights.sum(), torch.ones(
                (), device=dev), atol=1e-5)) and bool((g.weights > 0).all()),
                f"(a) {what}: client {i}'s released weights leave the "
                f"simplex")
            check(bool(((g.means >= 0) & (g.means <= 1)).all()),
                  f"(a) {what}: client {i}'s released means leave [0, 1]")
            check(bool(((g.covs >= VAR_MIN) & (g.covs <= VAR_MAX)).all()),
                  f"(a) {what}: client {i}'s released variances leave "
                  f"[{VAR_MIN}, {VAR_MAX}]")
            want, _ = t.apply(uplink_key(t, 0), t.traced(),
                              (r.gmm, float(split.sizes[i])), i, members)
            check(same_bits(g, want), f"(a) {what}: client {i}'s release "
                  f"is not its own round-0 stream")

    for eps in DP_EPSILONS:
        dp = DPConfig(epsilon=eps, delta=DP_DELTA)
        res, wall = synced(lambda: FedGenGMM(
            k_clients=K, k_global=K, h=H, dp=dp, config=cfg).run(
                clients, seed=0))
        ll, auc = quality(res.global_gmm, report, cfg)
        check(res.comm.epsilon_spent == eps and res.comm.rounds == 1,
              f"(a) epsilon_spent {res.comm.epsilon_spent} != {eps}")
        released_from_own_stream(res, dp, f"split, eps {eps}")
        log(f"phase 10 (a): FedGenGMM dp eps={eps}: avg loglik {ll:.6f}, "
            f"AUC-PR {auc:.6f}, epsilon_spent {res.comm.epsilon_spent}, "
            f"wall {wall:.3f} s (no DP, phase 3: {report['ll']:.6f}, "
            f"{report['auc']:.6f})")
    dp = DPConfig(epsilon=1.0, delta=DP_DELTA)
    shards = [ArraySource(torch.as_tensor(
        split.data[c, :int(split.sizes[c])], device=dev))
        for c in range(CLIENTS)]
    res, wall = synced(lambda: FedGenGMM(
        k_clients=K, k_global=K, h=H, dp=dp, synthetic="resident",
        config=cfg).run(shards, seed=0))
    released_from_own_stream(res, dp, "ArraySources, eps 1.0")
    ll, auc = quality(res.global_gmm, report, cfg)
    log(f"phase 10 (a): FedGenGMM dp eps=1.0 over {CLIENTS} ArraySources: "
        f"avg loglik {ll:.6f}, AUC-PR {auc:.6f}, wall {wall:.3f} s; every "
        f"client's release over the split and over the sources is the "
        f"bits of its round-0 stream on its own model")


def uplink_dp_depletion(dev, report, clients):
    """(b) DEM (fed-kmeans init) and FedEM (participation 0.5, 2 local
    epochs) under GaussianDP(epsilon=1, rounds=30): rounds, epsilon spent,
    quality; estep_stats launches once a round a local epoch."""
    from repro_torch.api import DEM, FedEM, FitConfig
    from repro_torch.fed import GaussianDP

    cfg = FitConfig(device=dev.type, max_iter=DP_ROUNDS)
    t = GaussianDP(epsilon=1.0, delta=DP_DELTA, rounds=DP_ROUNDS, seed=0)
    for name, make, epochs in (
            ("DEM fed-kmeans", lambda: DEM(K, init="fed-kmeans",
                                           transform=t, config=cfg), 1),
            ("FedEM p=0.5 e=2", lambda: FedEM(
                K, participation=0.5, local_epochs=2, transform=t,
                config=cfg), 2)):
        clients.per_call = []
        res, wall = synced(lambda: make().run(clients, seed=0))
        rounds = res.comm.rounds
        round_launches(clients, "estep_stats", epochs, rounds, f"(b) {name}")
        check(res.comm.epsilon_spent == rounds * (1.0 / DP_ROUNDS),
              f"(b) {name}: epsilon_spent {res.comm.epsilon_spent}")
        ll, auc = quality(res.global_gmm, report, cfg)
        log(f"phase 10 (b): {name} under GaussianDP(1, rounds="
            f"{DP_ROUNDS}): {rounds} rounds (converged {res.converged}, "
            f"last round's loglik {float(res.log_likelihood):.6f}), "
            f"epsilon_spent {res.comm.epsilon_spent:.6f} (= {rounds} x "
            f"1/{DP_ROUNDS}), avg loglik {ll:.6f}, AUC-PR {auc:.6f}, wall "
            f"{wall:.3f} s; estep_stats {epochs} a round")


def uplink_quantize_mask(dev, report, clients):
    """(c) StochasticQuantize(8) at one byte an element, PairwiseMask
    bit-identical to no transform for DEM and FedEM, one masked round's
    int32 channel against the unmasked lattice sum, Compose spending like
    GaussianDP alone, FedKMeans under quantization, and the round wall of
    DEM under each transform."""
    import numpy as np
    import torch
    from repro_torch.api import DEM, FedEM, FedKMeans, FitConfig
    from repro_torch.core.dem import DEMStrategy
    from repro_torch.core.em import wrap_int32
    from repro_torch.fed import (Compose, GaussianDP, PairwiseMask,
                                 StochasticQuantize, run_rounds)
    from repro_torch.fed.transforms import uplink_key

    cfg = FitConfig(device=dev.type)
    base = DEM(K, config=cfg).run(clients, seed=0)
    q8 = DEM(K, transform=StochasticQuantize(8), config=cfg).run(clients,
                                                                 seed=0)
    check(q8.comm.uplink_itemsize == 1
          and q8.comm.uplink_bytes == q8.comm.uplink_floats
          and q8.comm.downlink_bytes == 4 * q8.comm.downlink_floats,
          f"(c) quantized ledger {q8.comm}")
    ll_q8, _ = quality(q8.global_gmm, report, cfg)
    masked = DEM(K, transform=PairwiseMask(), config=cfg).run(clients,
                                                              seed=0)
    check(same_bits(masked.global_gmm, base.global_gmm)
          and masked.comm.rounds == base.comm.rounds,
          "(c) masked DEM differs from DEM")
    kw = dict(participation=0.5, local_epochs=2, config=cfg)
    f_base = FedEM(K, **kw).run(clients, seed=0)
    f_mask = FedEM(K, transform=PairwiseMask(), **kw).run(clients, seed=0)
    check(same_bits(f_mask.global_gmm, f_base.global_gmm),
          "(c) masked FedEM differs from FedEM")
    log(f"phase 10 (c): DEM {base.comm.rounds} rounds; StochasticQuantize(8)"
        f" {q8.comm.rounds} rounds, uplink {q8.comm.uplink_bytes} bytes for "
        f"{q8.comm.uplink_floats} elements (no transform "
        f"{base.comm.uplink_bytes} bytes), avg loglik {ll_q8:.6f}; "
        f"PairwiseMask bit-identical to no transform for DEM "
        f"({masked.comm.rounds} rounds) and FedEM ({f_mask.comm.rounds} "
        f"rounds)")

    # one masked round on the card: the summed int32 channel against the
    # sum of the clients' unmasked lattices
    strat = DEMStrategy(k=K)
    state0 = strat.init_state(0, clients)
    t = PairwiseMask(seed=1)
    total = clients.reduce_clients(strat.local_step, state0, transform=t,
                                   tparams=(), tkey=uplink_key(t, 0))
    idx = torch.arange(CLIENTS, device=dev)
    per = strat.local_step(state0, clients.data, clients.mask, idx)
    for f, leaf in enumerate(total["secagg"]):
        want = wrap_int32(torch.sum(t._lattice(per[f]).to(torch.int64),
                                    dim=0))
        check(leaf.dtype == torch.int32 and torch.equal(leaf, want),
              f"(c) the masked channel's leaf {f} differs from the "
              f"unmasked lattice sum")
    clients.per_call = []
    log(f"phase 10 (c): one masked round over {CLIENTS} clients "
        f"({CLIENTS * (CLIENTS - 1) // 2} pair streams a leaf): the summed "
        f"int32 channel equals the unmasked lattice sum exactly")

    dp = GaussianDP(epsilon=1.0, delta=DP_DELTA, rounds=DP_ROUNDS)
    comp = Compose((dp, StochasticQuantize(8), PairwiseMask()))
    c_res = DEM(K, transform=comp, config=cfg.replace(
        max_iter=DP_ROUNDS)).run(clients, seed=0)
    check(c_res.comm.epsilon_spent == c_res.comm.rounds * (1.0 / DP_ROUNDS)
          and c_res.comm.uplink_itemsize == 4,
          f"(c) Compose ledger {c_res.comm}")
    log(f"phase 10 (c): Compose(GaussianDP, StochasticQuantize(8), "
        f"PairwiseMask) {c_res.comm.rounds} rounds, epsilon_spent "
        f"{c_res.comm.epsilon_spent:.6f} (as GaussianDP alone), uplink "
        f"itemsize {c_res.comm.uplink_itemsize}")

    clients.per_call = []
    fk = FedKMeans(K, transform=StochasticQuantize(8), config=cfg).run(
        clients, seed=0)
    round_launches(clients, "kmeans_sweep_stats", 1, fk.comm.rounds,
                   "(c) FedKMeans, StochasticQuantize(8)", post=1)
    log(f"phase 10 (c): FedKMeans under StochasticQuantize(8): "
        f"{fk.comm.rounds} rounds, inertia {float(fk.inertia):.6f}, "
        f"kmeans_sweep_stats once a round")

    # the round wall: DEM from one init at tol 0, TIMED_ROUNDS rounds
    walls = {}
    strat0 = DEMStrategy(k=K, tol=0.0)
    for name, tr in (("none", None), ("GaussianDP", dp),
                     ("StochasticQuantize(8)", StochasticQuantize(8)),
                     ("PairwiseMask", PairwiseMask()),
                     ("Compose", comp), ("none", None)):
        clients.per_call = []
        res, wall = synced(lambda: run_rounds(
            strat0, clients, device=dev, state0=state0,
            max_rounds=TIMED_ROUNDS, transform=tr))
        round_launches(clients, "estep_stats", 1, TIMED_ROUNDS,
                       f"(c) timed DEM, {name}")
        walls.setdefault(name, []).append(wall / TIMED_ROUNDS * 1e3)
    report["uplink_round_ms"] = walls
    log("phase 10 (c): DEM round wall (ms, " + str(TIMED_ROUNDS)
        + " rounds from one init, synchronized): " + "; ".join(
            f"{n} {' / '.join(f'{w:.3f}' for w in ws)}"
            for n, ws in walls.items()))


def uplink_async_sync_equivalent(dev, report, clients):
    """(d) run_async(buffer = cohort, lookahead = 0) against run_rounds,
    bit for bit, on the split, on 20 ArraySources and with a
    CyclicSampler; its staleness histogram all zeros."""
    import torch
    from repro_torch.core.dem import DEMStrategy
    from repro_torch.data.sources import ArraySource
    from repro_torch.fed import CyclicSampler, run_async, run_rounds

    split = report["split"]
    strat = DEMStrategy(k=K, tol=0.0)
    state0 = strat.init_state(0, clients)
    shards = [ArraySource(torch.as_tensor(
        split.data[c, :int(split.sizes[c])], device=dev))
        for c in range(CLIENTS)]
    for what, cl, sampler in (
            ("the split", clients, None),
            (f"{CLIENTS} ArraySources", shards, None),
            ("the split, CyclicSampler(20, 10)", clients,
             CyclicSampler(CLIENTS, 10))):
        kw = dict(device=dev, state0=state0, max_rounds=TIMED_ROUNDS,
                  sampler=sampler)
        rs, t_sync = synced(lambda: run_rounds(strat, cl, **kw))
        ra, t_async = synced(lambda: run_async(strat, cl, **kw))
        clients.per_call = []
        m = CLIENTS if sampler is None else sampler.cohort_size
        check(same_bits(rs.global_gmm, ra.global_gmm)
              and rs.n_rounds == ra.n_rounds,
              f"(d) run_async differs from run_rounds on {what}")
        check(ra.comm.staleness == ((0, ra.n_rounds * m),),
              f"(d) staleness {ra.comm.staleness} on {what}")
        log(f"phase 10 (d): run_async(buffer={m}, lookahead=0) on {what}: "
            f"bit-identical to run_rounds over {ra.n_rounds} rounds, "
            f"staleness {ra.comm.staleness}; wall {t_async:.3f} s against "
            f"{t_sync:.3f} s")


def uplink_async_buffered(dev, report):
    """(e) the comm bench's async knobs at MNIST width: 1,000 Dirichlet(0.5)
    clients, DEM separated at tol 0 from one state0, CyclicSampler(1000,
    64); buffered (16 + 240 in flight, alpha 0.5) 400 combines against the
    synchronous arm's 40 rounds."""
    import numpy as np
    from repro_torch.api import FitConfig
    from repro_torch.convert import split_to_clients
    from repro_torch.core.dem import DEMStrategy
    from repro_torch.fed import CyclicSampler, run_async

    cfg = FitConfig(device=dev.type)
    clients = split_to_clients(async_population(), dev)
    strat = DEMStrategy(k=K, init="separated", tol=0.0)
    state0 = strat.init_state(0, clients)
    sampler = CyclicSampler(ASYNC_CLIENTS, ASYNC_COHORT)
    arms = {"sync": (ASYNC_COHORT, 0, SYNC_ROUNDS),
            "async": (ASYNC_BUFFER, ASYNC_LOOKAHEAD, ASYNC_COMBINES)}
    out = {}
    for name, (buffer, lookahead, rounds) in arms.items():
        seen = []

        def run():
            seen.clear()
            return run_async(strat, clients, device=dev, state0=state0,
                             max_rounds=rounds, sampler=sampler,
                             buffer_size=buffer, lookahead=lookahead,
                             staleness=ASYNC_ALPHA,
                             progress=lambda v, s, st: seen.append(st))

        before = kernel_counts()["estep_stats"]
        res, wall = synced(run)
        launches = kernel_counts()["estep_stats"] - before
        busy, pwall, _, _ = profiled_busy(run)
        ll, auc = quality(res.global_gmm, report, cfg)
        check(res.n_rounds == rounds and launches == rounds,
              f"(e) {name}: {res.n_rounds} combines, {launches} estep_stats "
              f"launches for {rounds}")
        comm = res.comm
        log(f"phase 10 (e): {name} arm (buffer {buffer}, lookahead "
            f"{lookahead}): {res.n_rounds} combines, staleness histogram "
            f"{comm.staleness}, mean {comm.mean_staleness:.4f}; final avg "
            f"loglik {ll:.6f}, AUC-PR {auc:.6f}; wall {wall:.3f} s "
            f"({wall / rounds * 1e3:.3f} ms a combine); a profiled run: "
            f"device busy {busy:.3f} ms of {pwall:.3f} ms (idle share "
            f"{1 - busy / pwall:.4f}); estep_stats {launches}")
        out[name] = (res, seen)
    _, seen = out["async"]
    k = ASYNC_LOOKAHEAD // ASYNC_BUFFER
    steady = [s for st in seen[k + ASYNC_COHORT // ASYNC_BUFFER:] for s in st]
    lo, hi = k, k + ASYNC_COHORT // ASYNC_BUFFER - 1
    check(steady and min(steady) >= lo and max(steady) <= hi,
          f"(e) steady-state staleness {min(steady)}..{max(steady)} outside "
          f"[{lo}, {hi}]")
    log(f"phase 10 (e): steady-state staleness {min(steady)}..{max(steady)}"
        f", mean {np.mean(steady):.4f} (lookahead / buffer = {k}; a "
        f"{ASYNC_COHORT}-client dispatch batch spans "
        f"{ASYNC_COHORT // ASYNC_BUFFER} combines)")


def executor_turns(dev, state0, srcs, rounds, what):
    """DEM rounds over ``srcs``, serially and on
    SourceClients(executor=ClientExecutor(n)) for one and four workers, in
    turns (serial, 1, 4, 4, 1, serial): the same bits; the walls."""
    from repro_torch.core.dem import DEMStrategy
    from repro_torch.fed import ClientExecutor, SourceClients, run_rounds

    strat = DEMStrategy(k=K, tol=0.0)
    walls = {}
    serial = None
    with ClientExecutor(1) as one, \
            ClientExecutor(EXECUTOR_WORKERS) as many:
        pools = {"serial": None, "ClientExecutor(1)": one,
                 f"ClientExecutor({EXECUTOR_WORKERS})": many}
        order = list(pools)
        for name in order + order[::-1]:
            cl = SourceClients(srcs, dev, executor=pools[name])
            res, wall = synced(lambda: run_rounds(
                strat, cl, device=dev, state0=state0, max_rounds=rounds))
            walls.setdefault(name, []).append(wall)
            serial = serial or res
            check(same_bits(res.global_gmm, serial.global_gmm),
                  f"(f) {what}: {name}'s rounds differ from the serial "
                  f"loop's")
    log(f"phase 10 (f): {what}: DEM, {rounds} rounds, wall in turns: "
        + "; ".join(f"{n} {' / '.join(f'{w:.3f}' for w in ws)} s"
                    for n, ws in walls.items()) + "; all bit-identical")
    return walls


def uplink_executor(dev, report, workdir):
    """(f) the client executor against the serial loop on two workloads:
    phase 9 (a)'s 20 single-block .npy clients (a step is a few small
    launches), and 4 clients of 2^20 rows each read from .npy files in
    16 blocks of 65,536 rows (a step is mostly copying rows out of the
    file's map to the card)."""
    import numpy as np
    from repro_torch.core.dem import DEMStrategy
    from repro_torch.data.sources import NpyFileSource, SyntheticGMMSource

    split = report["split"]
    paths = []
    for c in range(CLIENTS):
        paths.append(workdir / f"client{c:02d}.npy")
        np.save(paths[-1], np.ascontiguousarray(
            split.data[c, :int(split.sizes[c])]))
    state0 = DEMStrategy(k=K, tol=0.0).state_from_gmm(report["gmm"])
    walls = {"small": executor_turns(
        dev, state0, [NpyFileSource(p) for p in paths], TIMED_ROUNDS,
        f"{CLIENTS} single-block clients")}
    big = []
    for c in range(EXECUTOR_FILE_CLIENTS):
        big.append(workdir / f"big{c}.npy")
        out = np.lib.format.open_memmap(big[-1], mode="w+", dtype=np.float32,
                                        shape=(EXECUTOR_FILE_ROWS, D))
        gen = SyntheticGMMSource(report["gmm"], EXECUTOR_FILE_ROWS,
                                 seed=10 + c, cache_rows=0)
        at = 0
        for block in gen.iter_blocks(BIG_CHUNK):
            out[at:at + block.shape[0]] = block.cpu().numpy()
            at += block.shape[0]
        out.flush()
        del out
    walls["files"] = executor_turns(
        dev, state0, [NpyFileSource(p) for p in big], EXECUTOR_FILE_ROUNDS,
        f"{EXECUTOR_FILE_CLIENTS} clients of {EXECUTOR_FILE_ROWS} rows in "
        f"{EXECUTOR_FILE_ROWS // BIG_CHUNK} blocks")
    nbytes = EXECUTOR_FILE_CLIENTS * EXECUTOR_FILE_ROWS * D * 4 \
        * EXECUTOR_FILE_ROUNDS
    log("phase 10 (f): the file clients, best of two: " + "; ".join(
        f"{n} {min(ws):.3f} s ({nbytes / min(ws) / 1e9:.2f} GB/s of rows)"
        for n, ws in walls["files"].items()))
    report["executor_walls"] = walls


def phase_uplink_async(dev, report):
    """Phase 10: the uplink transforms, the DP release and async rounds on
    phase 3's data, (a)-(f), with every kernel's launches over the phase."""
    import tempfile
    from pathlib import Path as _Path
    import torch

    t_phase = time.perf_counter()
    clients = counting_clients(report["split"], dev)
    legs = (("a", lambda w: uplink_dp_one_shot(dev, report, clients)),
            ("b", lambda w: uplink_dp_depletion(dev, report, clients)),
            ("c", lambda w: uplink_quantize_mask(dev, report, clients)),
            ("d", lambda w: uplink_async_sync_equivalent(dev, report,
                                                         clients)),
            ("e", lambda w: uplink_async_buffered(dev, report)),
            ("f", lambda w: uplink_executor(dev, report, w)))
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        for part, fn in legs:
            t0 = time.perf_counter()
            fn(_Path(tmp))
            log(f"phase 10 ({part}): took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    total = kernel_counts()
    for name in ("estep_stats", "kmeans_sweep_stats", "gmm_log_prob"):
        check(total[name] > 0, f"kernel {name} was not launched in phase 10")
    for entry in report["kernels"]:
        entry["launches_by_path"]["uplink_async"] = total[entry["name"]]
    log(f"phase 10: launches {total}; took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 11: the mesh runtime, continual FedGenGMM and split-merge EM
# ----------------------------------------------------------------------

SEAM_ROUNDS = 4                    # (c): test_fed_transforms.py's budget
CONTINUAL_WINDOWS, CONTINUAL_MEMORY = 3, 0.5
# (e)'s refit once the old global model joins as one more client
CONTINUAL_SYNTH = H * (CLIENTS + 1) * K
# (b): phase 7's runs, the kernel each round launches and how often
MESH_RUNS = (("DEM fed-kmeans", "estep_stats", 1),
             ("FedEM p=0.5 e=2", "estep_stats", 2),
             ("FedKMeans", "kmeans_sweep_stats", 1))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def world_one_mesh(dev, workdir):
    """A process group of one rank over a ``file://`` store, and its 1-D
    ``"data"`` mesh: NCCL on the card (gloo where the phase is rehearsed
    on the CPU). NCCL's bootstrap is pointed at the loopback interface,
    the one a single rank needs and every machine has."""
    import os
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import torch
    if dev.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{workdir}/store", rank=0,
                            world_size=1)
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
    # NCCL builds its communicator at the first collective: take it here
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe, group=mesh.get_group("data"))
    check(float(probe) == 1.0, f"an all-reduce of 1 at world size 1 gave "
          f"{float(probe)}")
    log(f"phase 11: {dist.get_backend()} process group of one rank, its "
        f"\"data\" mesh and first all-reduce in "
        f"{time.perf_counter() - t0:.3f} s (NCCL_SOCKET_IFNAME="
        f"{os.environ.get('NCCL_SOCKET_IFNAME')})")
    return mesh


class MeshReduces:
    """Within a ``with`` block, each ``ShardedClients.reduce_clients`` call's
    round-kernel launches and collective calls (``calls``)."""

    def __enter__(self):
        from repro_torch.fed.runtime import ShardedClients
        self.calls, inner = [], ShardedClients.reduce_clients
        self._inner = inner

        def reduce_clients(backend, *args, **kwargs):
            before, coll = kernel_counts(), ShardedClients.collectives
            out = inner(backend, *args, **kwargs)
            after = kernel_counts()
            self.calls.append(dict(
                {k: after[k] - before[k] for k in ROUND_KERNELS},
                collectives=ShardedClients.collectives - coll))
            return out

        ShardedClients.reduce_clients = reduce_clients
        return self

    def __exit__(self, *exc):
        from repro_torch.fed.runtime import ShardedClients
        ShardedClients.reduce_clients = self._inner
        return False


def mesh_fedgen(dev, report, mesh):
    """(a) fedgen_sharded against fedgengmm_cfg: the same bits, one
    all-gather."""
    import torch
    from repro_torch.api import FitConfig
    from repro_torch.core.fedgen import fedgengmm_cfg
    from repro_torch.distributed import fedgen_sharded
    from repro_torch.fed.runtime import ShardedClients

    split, cfg = report["split"], FitConfig(device=dev.type)
    walls = {"single": [], "sharded": []}
    for side in ("single", "sharded", "sharded", "single"):
        # the phase's counts run on: each run's launches are a difference
        before, coll = kernel_counts(), ShardedClients.collectives
        if side == "single":
            single, wall = synced(lambda: fedgengmm_cfg(
                0, split, cfg, k_clients=K, k_global=K, h=H))
        else:
            sharded, wall = synced(lambda: fedgen_sharded(
                mesh, 0, split.data, split.mask, K, K, h=H, config=cfg))
            after = kernel_counts()
            launches = {k: after[k] - before[k] for k in after}
            collectives = ShardedClients.collectives - coll
        walls[side].append(wall)
    locals_same = torch.equal(sharded.local_means, torch.stack(
        [g.means for g in single.local_gmms]))
    check(same_bits(sharded.global_gmm, single.global_gmm) and locals_same,
          "(a) fedgen_sharded differs from fedgengmm_cfg")
    check(collectives == 1,
          f"(a) {collectives} collective calls, not one all-gather")
    check(launches["estep_stats"] > 0 and launches["kmeans_sweep_stats"] > 0,
          f"(a) launches {launches}")
    ll, auc = quality(sharded.global_gmm, report, cfg)
    log(f"phase 11 (a): fedgen_sharded at world size 1 bit-identical to "
        f"fedgengmm_cfg, local fits and global model (avg loglik {ll:.6f}, "
        f"AUC-PR {auc:.6f}); one all-gather of {CLIENTS} x ({K} + 2 x {K} "
        f"x {D} + 1) floats; wall in turns single {walls['single'][0]:.3f} "
        f"/ {walls['single'][1]:.3f} s, sharded {walls['sharded'][0]:.3f} / "
        f"{walls['sharded'][1]:.3f} s; launches {launches}")
    return {"FedGenGMM": (min(walls["single"]), min(walls["sharded"]))}


def mesh_iterative(dev, report, mesh):
    """(b) DEM (fed-kmeans init; and dem_sharded from phase 7's centers),
    FedEM (participation 0.5, 2 local epochs) and FedKMeans sharded, each
    timed in turns with its single-process run (both with their inits; the
    sharded side also copies its clients from the host): phase 7's rounds,
    bits and Table 4 ledger, one all-reduce and the round kernels'
    launches a round."""
    from repro_torch.api import DEM, FedEM, FedKMeans, FitConfig
    from repro_torch.convert import split_to_clients
    from repro_torch.core.config import derive_seed
    from repro_torch.core.dem import DEMStrategy, fed_kmeans_centers
    from repro_torch.distributed import (dem_sharded, fed_kmeans_sharded,
                                         fedem_sharded)
    from repro_torch.fed import run_rounds

    split, cfg = report["split"], FitConfig(device=dev.type)
    data, mask = split.data, split.mask
    clients = split_to_clients(split, dev)
    centers = fed_kmeans_centers(derive_seed(0, "init"), clients, K)

    def model(res):
        return res.centers if hasattr(res, "centers") else res.global_gmm

    arms = {
        # over the mesh DEM is timed with its scheme init, as the facade
        # runs it; dem_sharded (from given centers) is held to it below
        "DEM fed-kmeans": (
            lambda: DEM(K, init="fed-kmeans", config=cfg).run(clients,
                                                              seed=0),
            lambda: run_rounds(DEMStrategy(k=K), split, seed=0, mesh=mesh,
                               max_rounds=200)),
        "FedEM p=0.5 e=2": (
            lambda: FedEM(K, participation=0.5, local_epochs=2,
                          config=cfg).run(clients, seed=0),
            lambda: fedem_sharded(mesh, 0, data, mask, K, participation=0.5,
                                  local_epochs=2, config=cfg)),
        "FedKMeans": (
            lambda: FedKMeans(K, config=cfg).run(clients, seed=0),
            lambda: fed_kmeans_sharded(mesh, 0, data, mask, K, config=cfg))}
    walls = {}
    for name, kern, per_round in MESH_RUNS:
        phase7 = report["paper_runs"][name]
        single, sharded = arms[name]
        times = {single: [], sharded: []}
        for fn in (single, sharded, sharded, single):
            with MeshReduces() as mr:
                out, wall = synced(fn)
            times[fn].append(wall)
            if fn is sharded:
                res, calls = out, mr.calls
            else:
                check(same_bits(model(out), model(phase7)),
                      f"(b) single-process {name} differs from phase 7")
        rounds = res.n_rounds
        if name.startswith("DEM"):
            gmm, dem_rounds = dem_sharded(mesh, 0, data, mask, K, centers,
                                          config=cfg)
            check(same_bits(gmm, res.global_gmm) and dem_rounds == rounds,
                  "(b) dem_sharded from phase 7's centers differs")
        post = 1 if name == "FedKMeans" else 0
        check(same_bits(model(res), model(phase7))
              and rounds == phase7.n_rounds and res.comm == phase7.comm,
              f"(b) sharded {name}: {rounds} rounds against phase 7's "
              f"{phase7.n_rounds}, ledger {res.comm} against {phase7.comm}, "
              f"or other bits")
        check(len(calls) == rounds + post,
              f"(b) sharded {name}: {len(calls)} reduces for {rounds} "
              f"rounds")
        check(all(c["collectives"] == 1 for c in calls),
              f"(b) sharded {name}: collective calls a reduce "
              f"{sorted({c['collectives'] for c in calls})}")
        check(all(c[kern] == per_round for c in calls[:rounds]),
              f"(b) sharded {name}: {kern} launches a round "
              f"{sorted({c[kern] for c in calls[:rounds]})}, not "
              f"{per_round}")
        walls[name] = (min(times[single]), min(times[sharded]))
        log(f"phase 11 (b): {name} sharded: {rounds} rounds, phase 7's bits "
            f"and Table 4 ledger ({res.comm.uplink_floats} uplink floats, "
            f"{res.comm.downlink_floats} downlink), one all-reduce and "
            f"{per_round} {kern} a round; wall in turns single "
            f"{times[single][0]:.3f} / {times[single][1]:.3f} s, sharded "
            f"{times[sharded][0]:.3f} / {times[sharded][1]:.3f} s")
    return walls


def mesh_seam_async(dev, report, mesh):
    """(c) sharded DEM over SEAM_ROUNDS rounds: Identity and PairwiseMask
    bit-identical to no transform, GaussianDP(2, rounds=4) not; (d)
    run_async(mesh=) sync-equivalent against run_rounds(mesh=) and the
    single-process run_rounds."""
    from repro_torch.api import FitConfig
    from repro_torch.convert import split_to_clients
    from repro_torch.core.config import derive_seed
    from repro_torch.core.dem import DEMStrategy, fed_kmeans_centers
    from repro_torch.distributed import dem_sharded
    from repro_torch.fed import (GaussianDP, Identity, PairwiseMask,
                                 run_async, run_rounds)
    from repro_torch.fed.runtime import ShardedClients

    split = report["split"]
    cfg = FitConfig(device=dev.type, max_iter=SEAM_ROUNDS)
    centers = fed_kmeans_centers(derive_seed(0, "init"),
                                 split_to_clients(split, dev), K)
    out, walls = {}, {}
    for name, t in (("none", None), ("Identity", Identity()),
                    ("PairwiseMask", PairwiseMask()),
                    ("GaussianDP", GaussianDP(epsilon=2.0,
                                              rounds=SEAM_ROUNDS))):
        ShardedClients.collectives = 0
        (gmm, rounds), walls[name] = synced(lambda: dem_sharded(
            mesh, 0, split.data, split.mask, K, centers, config=cfg,
            transform=t))
        out[name] = (gmm, rounds, ShardedClients.collectives)
    base = out["none"][0]
    check(same_bits(out["Identity"][0], base)
          and same_bits(out["PairwiseMask"][0], base),
          "(c) sharded DEM under Identity or PairwiseMask differs")
    check(not same_bits(out["GaussianDP"][0], base),
          "(c) sharded DEM under GaussianDP did not move")
    check(out["PairwiseMask"][2] == 2 + 2 * out["PairwiseMask"][1],
          f"(c) masked collectives {out['PairwiseMask'][2]}")
    log(f"phase 11 (c): sharded DEM, {SEAM_ROUNDS} rounds: Identity and "
        f"PairwiseMask bit-identical to no transform, GaussianDP(2, rounds="
        f"{SEAM_ROUNDS}) not; collective calls (2 for the init) "
        + ", ".join(f"{n} {c}" for n, (_, _, c) in out.items())
        + "; walls " + ", ".join(f"{n} {w:.3f} s" for n, w in walls.items()))

    strat = DEMStrategy(k=K, tol=0.0)
    state0 = strat.state_from_gmm(report["gmm"])
    kw = dict(state0=state0, max_rounds=TIMED_ROUNDS)
    ra, t_async = synced(lambda: run_async(strat, split, mesh=mesh, **kw))
    rs, t_sync = synced(lambda: run_rounds(strat, split, mesh=mesh, **kw))
    r1 = run_rounds(strat, split, device=dev, **kw)
    check(same_bits(ra.global_gmm, rs.global_gmm)
          and same_bits(rs.global_gmm, r1.global_gmm)
          and ra.n_rounds == rs.n_rounds == r1.n_rounds,
          "(d) run_async(mesh=) differs from run_rounds(mesh=) or from the "
          "single process")
    log(f"phase 11 (d): run_async(mesh=) sync-equivalent bit-identical to "
        f"run_rounds(mesh=) and to the single-process run_rounds over "
        f"{ra.n_rounds} rounds; wall {t_async:.3f} s against {t_sync:.3f} s")


def mesh_continual(dev, report):
    """(e) continual FedGenGMM over three windows of the 60,000 rows, each
    split over the 20 clients: one round a window, each window's rows
    scored after its round."""
    import numpy as np
    from repro_torch.api import FitConfig, score
    from repro_torch.core.continual import continual_round, init_state

    ds, cfg = report["ds"], FitConfig(device=dev.type)
    state, lines = init_state(), []
    for w, (x, split) in enumerate(continual_windows()):
        state, wall = synced(lambda: continual_round(
            w, state, split.data, split.mask, split.sizes, k_clients=K,
            k_global=K, h=H, memory=CONTINUAL_MEMORY, device=dev.type))
        ll = float(score(state.global_gmm, x, config=cfg))
        check(np.isfinite(ll) and state.rounds_total == w + 1
              and state.window == w + 1, f"(e) window {w}: {state[1:]}")
        lines.append(f"window {w} ({split.data.shape}) avg loglik "
                     f"{ll:.6f}, {wall:.3f} s")
    ll_all, auc = quality(state.global_gmm, report, cfg)
    log(f"phase 11 (e): continual FedGenGMM, memory {CONTINUAL_MEMORY}, "
        f"{state.rounds_total} rounds for {state.window} windows: "
        + "; ".join(lines) + f"; all {len(ds.x_train):,} rows "
        f"{ll_all:.6f}, AUC-PR {auc:.6f}")


def mesh_split_merge(dev, report):
    """(f) split_merge_fit on each of the 20 clients at K = 30 against the
    plain fit (never below it by more than 1e-5), the walls, then the
    split-merge locals aggregated and scored."""
    from repro_torch.api import FitConfig
    from repro_torch.core.em import fit_gmm
    from repro_torch.core.fedgen import aggregate
    from repro_torch.core.splitmerge import split_merge_fit

    split, cfg = report["split"], FitConfig(device=dev.type)
    rows = [split.data[c, :int(split.sizes[c])] for c in range(CLIENTS)]
    plain, t_plain = synced(lambda: [
        fit_gmm(c, x, K, device=dev.type) for c, x in enumerate(rows)])
    sm, t_sm = synced(lambda: [
        split_merge_fit(c, x, K, device=dev.type)
        for c, x in enumerate(rows)])
    gains = [float(s.log_likelihood) - float(p.log_likelihood)
             for s, p in zip(sm, plain)]
    check(min(gains) >= -1e-5, f"(f) split-merge below the plain fit: "
          f"{min(gains)}")
    res, _ = aggregate(0, [r.gmm for r in sm], split.sizes, h=H, k_global=K,
                       device=dev.type)
    ll, auc = quality(res.gmm, report, cfg)
    log(f"phase 11 (f): split_merge_fit on {CLIENTS} clients at K = {K}: "
        f"avg loglik gain over the plain fit {min(gains):.3e}..."
        f"{max(gains):.3e} ({sum(g > 1e-6 for g in gains)} clients "
        f"improved); wall {t_sm:.3f} s against {t_plain:.3f} s plain; "
        f"aggregated: avg loglik {ll:.6f}, AUC-PR {auc:.6f} (phase 3: "
        f"{report['ll']:.6f}, {report['auc']:.6f})")


def phase_mesh_extensions(dev, report):
    """Phase 11: the mesh runtime at world size 1 (NCCL on the card),
    continual FedGenGMM and split-merge EM on phase 3's data, with every
    kernel's launches over the phase."""
    import tempfile
    from pathlib import Path as _Path
    import torch
    import torch.distributed as dist

    t_phase = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = world_one_mesh(dev, _Path(tmp))
        try:
            t0 = time.perf_counter()
            walls = mesh_fedgen(dev, report, mesh)
            walls.update(mesh_iterative(dev, report, mesh))
            mesh_seam_async(dev, report, mesh)
            log(f"phase 11 (a)-(d): took {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    for part, fn in (("e", mesh_continual), ("f", mesh_split_merge)):
        t0 = time.perf_counter()
        fn(dev, report)
        log(f"phase 11 ({part}): took {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    total = kernel_counts()
    for name in PATH_KERNELS:
        check(total[name] > 0, f"kernel {name} was not launched in phase 11")
    for entry in report["kernels"]:
        entry["launches_by_path"]["mesh_continual_splitmerge"] = \
            total[entry["name"]]
    log(f"phase 11: walls at world size 1 on {card_line()}, single process "
        f"/ sharded: " + "; ".join(f"{n} {a:.3f} / {b:.3f} s"
                                   for n, (a, b) in walls.items()))
    log(f"phase 11: launches {total}; took "
        f"{time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 12: the transformer substrate's serving path at full width
# ----------------------------------------------------------------------

LM_ARCH = "internlm2-1.8b"
LM_PARAMS = 1_889_110_016
# f32 logits (TF32 off) of one computation done two ways: decode against
# prefill, ring against windowed full cache, batched against solo
LM_RTOL = LM_ATOL = 1e-3
CONSIST_B, CONSIST_PROMPT, CONSIST_STEPS = 4, 64, 16
RING_C, RING_STEPS = 32, 48
# name: (requests, prompt lengths lo..hi, max_new, max_batch, max_context).
# "cli" is the JAX package's serve CLI stream (repro/launch/serve.py:95-120)
LM_STREAMS = {"cli": (12, (8, 32), 8, 4, 256),
              "heavy": (32, (128, 512), 32, 8, 1024)}
# the monitor: MonitorConfig() (feature_dim 32, k_local 4, k_global 8,
# h 100); 4 clients observe 8 batches of 16 x 256 tokens each, then 64
# in-distribution and 64 OOD sequences are scored
MON_CLIENTS, MON_BATCHES, MON_ROWS, MON_LEN, MON_SCORED = 4, 8, 16, 256, 64
MON_DIM, MON_K_LOCAL, MON_K_GLOBAL, MON_H = 32, 4, 8, 100
# the monitor's kernel shapes (held in phase 2): (rows, d, K) of a local
# fit's E-step and of the server refit's, (batch, rows, d, K) of their
# pilot and Lloyd sweeps, rows of a scoring call
MON_FIT_ROWS = MON_BATCHES * MON_ROWS
MON_REFIT_ROWS = MON_H * MON_CLIENTS * MON_K_LOCAL
MON_ESTEP_SHAPES = [(MON_FIT_ROWS, MON_DIM, MON_K_LOCAL),
                    (MON_REFIT_ROWS, MON_DIM, MON_K_GLOBAL)]
MON_SWEEP_SHAPES = [(4, MON_FIT_ROWS, MON_DIM, MON_K_LOCAL),
                    (1, MON_FIT_ROWS, MON_DIM, MON_K_LOCAL),
                    (4, MON_REFIT_ROWS, MON_DIM, MON_K_GLOBAL),
                    (1, MON_REFIT_ROWS, MON_DIM, MON_K_GLOBAL)]


def lm_gib(nbytes) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def lm_consistency(dev, model, cfg, rng, what, b=CONSIST_B,
                   prompt_len=CONSIST_PROMPT, steps=CONSIST_STEPS,
                   extra=None):
    """Decode against prefill: a ``prompt_len``-token prompt at B = ``b``,
    then ``steps`` decode steps fed fixed tokens; step i's logits against
    ``prefill_forward``'s last-position logits on the prompt extended by
    the same i + 1 tokens (``extra``, e.g. an encoder-decoder's
    ``src_embeds``, in every prefill's batch) -> (max abs diff, greedy
    agreement)."""
    import torch
    from repro_torch.models import decode_step, prefill_forward
    extra = extra or {}
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        b, prompt_len)), device=dev)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        b, steps)), device=dev)
    _, cache = prefill_forward(model, cfg, {"tokens": prompt, **extra},
                               capacity=prompt_len + steps)
    err, agree = 0.0, []
    for i in range(steps):
        got, cache = decode_step(model, cfg, cache, forced[:, i],
                                 prompt_len + i)
        want, _ = prefill_forward(
            model, cfg, {"tokens": torch.cat([prompt, forced[:, :i + 1]],
                                             dim=1), **extra},
            capacity=prompt_len + i + 1)
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
        err = max(err, float((got - want).abs().max()))
        agree.append(torch.argmax(got, -1) == torch.argmax(want, -1))
    return err, float(torch.stack(agree).float().mean())


def lm_ring(dev, model, cfg, rng):
    """Ring-buffer decode at C = RING_C against full-cache decode with a
    RING_C window, RING_STEPS steps after a CONSIST_PROMPT-token prompt,
    both through ``swa`` layers of window RING_C -> max abs diff."""
    import dataclasses
    import torch
    from repro_torch.models import decode_step, prefill_forward
    swa = dataclasses.replace(cfg, pattern=("swa",), window=RING_C)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        CONSIST_B, CONSIST_PROMPT)), device=dev)
    _, ring = prefill_forward(model, swa, {"tokens": prompt},
                              capacity=RING_C, ring=True)
    _, full = prefill_forward(model, swa, {"tokens": prompt},
                              capacity=CONSIST_PROMPT + RING_STEPS)
    check(ring[0]["k"].shape[1] == RING_C, "the ring cache is not C wide")
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (CONSIST_B,)),
                          device=dev)
    err = 0.0
    for i in range(RING_STEPS):
        a, ring = decode_step(model, swa, ring, tok, CONSIST_PROMPT + i,
                              ring=True)
        b, full = decode_step(model, swa, full, tok, CONSIST_PROMPT + i)
        err = max(err, close(a, b, LM_RTOL, LM_ATOL,
                             f"ring decode step {i} against the windowed "
                             f"full cache"))
        tok = torch.argmax(b, -1)
    return err


def lm_stream(name, cfg, seed=0, spec=None):
    """``spec`` (default LM_STREAMS[name]) as serve requests: prompt
    lengths uniform in lo..hi and tokens uniform below ``min(vocab, 100)``
    ("cli", as the JAX CLI draws them) or over the vocabulary, from
    default_rng(seed)."""
    import numpy as np
    from repro_torch.launch.serve import Request
    n, (lo, hi), max_new, _, _ = spec or LM_STREAMS[name]
    rng = np.random.default_rng(seed)
    top = min(cfg.vocab_size, 100) if name == "cli" else cfg.vocab_size
    return [Request(i, rng.integers(0, top, rng.integers(lo, hi + 1))
                    .astype(np.int32), max_new) for i in range(n)]


def forced_logits(eng, reqs, row, forced):
    """Logits of ``reqs[row]`` at every step through ``eng``'s own
    padding, prefill and decode step, the row fed ``forced`` (the others
    their greedy tokens) -> (len(forced), V)."""
    import torch
    tokens, lmax = eng._pad_batch(reqs)
    logits, cache = eng._prefill(eng.params, {"tokens": tokens})
    out = [logits[row].clone()]
    for i in range(len(forced) - 1):
        tok = torch.argmax(logits, -1)
        tok[row] = forced[i]
        logits, cache = eng._step(eng.params, cache, tok, lmax + i)
        out.append(logits[row].clone())
    return torch.stack(out)


def batch_vs_solo(dev, cfg32, model32, name, stream):
    """A request of ``stream`` served with same-length peers against its
    solo run, in f32 through an f32 engine of the stream's geometry: the
    solo greedy tokens are fed to both, logits held step by step ->
    (max abs diff, batch size)."""
    import numpy as np
    from repro_torch.launch.serve import Request, ServeEngine
    _, _, max_new, max_batch, max_context = LM_STREAMS[name]
    eng = ServeEngine(cfg32, model32, max_batch=max_batch,
                      max_context=max_context, device=dev.type)
    target = stream[0]
    solo = eng.serve([target])[0].tokens
    rng = np.random.default_rng(1)
    top = int(target.prompt.max()) + 1
    peers = [Request(100 + i, rng.integers(0, top, len(target.prompt))
                     .astype(np.int32), max_new)
             for i in range(max_batch - 1)]
    row = max_batch // 2
    batch = peers[:row] + [target] + peers[row:]
    err = close(forced_logits(eng, batch, row, solo),
                forced_logits(eng, [target], 0, solo), LM_RTOL, LM_ATOL,
                f"{name}: request {target.rid} with {max_batch - 1} "
                f"same-length peers against its solo run")
    return err, len(batch)


def serve_lm_stream(dev, cfg, model, name, monitor=None, spec=None):
    """Serve ``spec`` (default LM_STREAMS[name]) through a bf16
    ``ServeEngine`` -> (results, stats line). Every request served with
    its budget; TTFT, latency, decode ms a step, tokens/s and peak memory
    measured."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import ServeEngine
    spec = spec or LM_STREAMS[name]
    n, _, max_new, max_batch, max_context = spec
    stream = lm_stream(name, cfg, spec=spec)
    eng = ServeEngine(cfg, model, max_batch=max_batch,
                      max_context=max_context, monitor=monitor,
                      device=dev.type)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = eng.serve(stream)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(sorted(r.rid for r in results) == list(range(n)),
          f"{name}: not every request was served")
    check(all(len(r.tokens) == max_new for r in results),
          f"{name}: a request's token budget was not kept")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.tokens),
          f"{name}: a token outside the vocabulary")
    ttft = np.array([r.ttft_s for r in results]) * 1e3
    lat = np.array([r.latency_s for r in results]) * 1e3
    # one decode step: a batch's wall after its first token over its steps
    per_batch = {(r.ttft_s, r.latency_s) for r in results}
    step_ms = [(b - a) / (max_new - 1) * 1e3 for a, b in per_batch]
    tokens = sum(len(r.tokens) for r in results)
    lens = [len(r.prompt) for r in stream]
    stats = (f"{n} requests, prompts {min(lens)}..{max(lens)} tokens, "
             f"max_new {max_new}, max_batch {max_batch}, max_context "
             f"{max_context}: TTFT p50 {np.percentile(ttft, 50):.2f} ms, p99 "
             f"{np.percentile(ttft, 99):.2f} ms; latency p50 "
             f"{np.percentile(lat, 50):.2f} ms, p99 "
             f"{np.percentile(lat, 99):.2f} ms; decode "
             f"{np.mean(step_ms):.3f} ms a step ({min(step_ms):.3f}.."
             f"{max(step_ms):.3f} over {len(step_ms)} batches); {tokens} "
             f"tokens in {wall:.3f} s, {tokens / wall:.1f} tokens/s; peak "
             f"memory {lm_gib(peak)}, {lm_gib(peak - before)} above the "
             f"{lm_gib(before)} allocated before the stream")
    bare = ServeEngine(cfg, model, max_batch=max_batch,
                       max_context=max_context, device=dev.type)
    busy, pwall, by_name, _ = profiled_busy(
        lambda: bare.serve(stream[:max_batch]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    stats += (f"; one batch under the profiler: device busy {busy:.2f} ms "
              f"of {pwall:.2f} ms wall, idle share {1 - busy / pwall:.4f}; "
              f"largest device items (ms) " + ", ".join(
                  f"{ms:.2f} {name.replace('void at::native::', '')[:90]}"
                  for name, ms in top))
    return stream, stats


def lm_monitor(dev, cfg, model, tag, extra=None, seq_len=None):
    """The FedGenGMM monitor at full width: MON_CLIENTS clients observe
    MON_BATCHES batches of MON_ROWS x MON_LEN in-distribution tokens
    (``synthetic_stream`` at the model's vocabulary, one seed a client),
    one aggregation, then MON_SCORED in-distribution sequences (another
    seed) and MON_SCORED OOD ones (uniform over the vocabulary's upper
    half) scored, the scores held against the plain version of the
    global GMM's log density (rtol/atol 2e-4) -> (the monitor, median ID
    score, median OOD score, the scores' max abs err, walls).
    ``extra(rows, seed)`` adds entries to each batch (an encoder-decoder's
    ``src_embeds``); ``seq_len`` (default MON_LEN) shortens the sequences
    (the kernels' row counts do not depend on it)."""
    import numpy as np
    import torch
    from repro_torch.data.tokens import synthetic_stream
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import pack_params
    from repro_torch.monitor import (FedGMMMonitor, MonitorConfig,
                                     extract_features)
    mcfg = MonitorConfig()
    check((mcfg.feature_dim, mcfg.k_local, mcfg.k_global, mcfg.h)
          == (MON_DIM, MON_K_LOCAL, MON_K_GLOBAL, MON_H),
          f"MonitorConfig() is {mcfg}, not phase 12's")
    mon = FedGMMMonitor(cfg, mcfg, device=dev.type)
    seq_len = seq_len or MON_LEN
    per_client = MON_BATCHES * MON_ROWS * seq_len

    def batch(toks, seed):
        return {"tokens": toks, **(extra(len(toks), seed) if extra else {})}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for cid in range(MON_CLIENTS):
        toks = synthetic_stream(cid, cfg.vocab_size, per_client).reshape(
            MON_BATCHES, MON_ROWS, seq_len)
        for b in range(MON_BATCHES):
            mon.observe(cid, model, batch(toks[b], cid * MON_BATCHES + b))
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = mon.aggregate()
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    check(g.n_components == MON_K_GLOBAL
          and all(bool(torch.isfinite(t).all())
                  for t in (g.weights, g.means, g.covs)),
          "the global monitor GMM is not a finite K_global mixture")
    id_toks = synthetic_stream(MON_CLIENTS, cfg.vocab_size,
                               MON_SCORED * seq_len).reshape(MON_SCORED,
                                                             seq_len)
    ood_toks = np.random.default_rng(7).integers(
        cfg.vocab_size // 2, cfg.vocab_size, (MON_SCORED, seq_len)
    ).astype(np.int32)
    id_b, ood_b = batch(id_toks, 10_000), batch(ood_toks, 10_001)
    t0 = time.perf_counter()
    id_s = mon.score(model, id_b)
    ood_s = mon.score(model, ood_b)
    t_score = time.perf_counter() - t0
    feats = torch.cat([extract_features(model, cfg, b, mon.proj)
                       for b in (id_b, ood_b)])
    plain = -ref.gmm_log_prob_packed(feats, *pack_params(
        g.means, g.covs, torch.log(g.weights)))
    err = close(torch.as_tensor(np.concatenate([id_s, ood_s])), plain.cpu(),
                2e-4, 2e-4, f"{tag} monitor scores against the plain version")
    return (mon, float(np.median(id_s)), float(np.median(ood_s)), err,
            (t_feat, t_fit, t_score))


def phase_transformer_serving(dev, report):
    """Phase 12: internlm2-1.8b at full width from seed 0 (bf16 matrices;
    an f32 copy from the same seed for the f32 bounds, built after the
    bf16 streams are served so that their peak memory is the server's):
    (a) the build; (c) ``ServeEngine`` on the JAX CLI's stream with the
    FedGenGMM monitor attached (one ``observe`` a batch) and on a heavier
    stream; (b) decode against prefill in f32 and bf16, ring against
    windowed full-cache decode in f32; (c) a request of each stream
    against its solo run in f32; (d) the monitor at full width: four
    clients' local fits, one FedGenGMM round and OOD against ID scores,
    through the kernels."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    from repro_torch.monitor import FedGMMMonitor, MonitorConfig

    t_phase = time.perf_counter()
    reset_counts()
    cfg = get_config(LM_ARCH, "full")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    # (a) the build
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev.type)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    mem_bf16 = torch.cuda.memory_allocated() - base
    n_params = count_params(model)
    check(n_params == LM_PARAMS, f"{LM_ARCH}: {n_params:,} parameters, not "
          f"{LM_PARAMS:,}")
    check(model.embed.dtype == torch.bfloat16
          and model.layers[0].attn.wq.dtype == torch.bfloat16
          and model.layers[0].ln1.dtype == torch.float32,
          "the bf16 model's matrices are not bf16 or its norms not f32")
    log(f"phase 12 (a): {LM_ARCH} full ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, kv {cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}) from seed 0: {n_params:,} "
        f"parameters; bf16 matrices {lm_gib(mem_bf16)} allocated, built in "
        f"{t_build:.3f} s; {card_line()}")

    # (c) ServeEngine, two streams, bf16, served while only the bf16 model
    # is on the card; the monitor on the CLI's
    mon = FedGMMMonitor(cfg, MonitorConfig(), device=dev.type)
    observed = []
    observe = mon.observe
    mon.observe = lambda cid, p, b: (observed.append(cid), observe(cid, p, b))
    streams = {}
    for name in LM_STREAMS:
        streams[name], stats = serve_lm_stream(
            dev, cfg, model, name, monitor=mon if name == "cli" else None)
        log(f"phase 12 (c): {name}: {stats}; {card_line()}")
    n_cli, _, _, cli_batch, _ = LM_STREAMS["cli"]
    check(observed == [0] * -(-n_cli // cli_batch),
          f"the monitor observed {observed}, not once a batch as client 0")
    log(f"phase 12 (c): the monitor attached to the cli stream's engine "
        f"observed {len(observed)} batches, once a batch")

    # the f32 copy, for (b) and the batch-against-solo checks of (c)
    t0 = time.perf_counter()
    model32 = init_params(0, cfg32, device=dev.type)
    torch.cuda.synchronize()
    t_build32 = time.perf_counter() - t0
    check(torch.equal(model32.layers[-1].ffn.w_up.to(torch.bfloat16),
                      model.layers[-1].ffn.w_up),
          "the f32 and bf16 models are not the same draw")
    log(f"phase 12 (a): the f32 copy built in {t_build32:.3f} s; "
        f"{lm_gib(torch.cuda.memory_allocated())} allocated with both")

    # (b) consistency
    rng = np.random.default_rng(12)
    err32, agree32 = lm_consistency(dev, model32, cfg32, rng, "f32")
    check(err32 <= LM_ATOL, f"f32 decode against prefill: max abs diff "
          f"{err32} beyond {LM_ATOL}")
    err16, agree16 = lm_consistency(dev, model, cfg, rng, "bf16")
    ring_err = lm_ring(dev, model32, cfg32, rng)
    log(f"phase 12 (b): decode against prefill, B = {CONSIST_B}, a "
        f"{CONSIST_PROMPT}-token prompt, {CONSIST_STEPS} steps fed fixed "
        f"tokens: f32 (TF32 off) max abs diff {err32:.3e} (bound "
        f"{LM_ATOL}), greedy agreement {agree32:.4f}; bf16 max abs diff "
        f"{err16:.3e}, greedy agreement {agree16:.4f}; ring decode at C = "
        f"{RING_C} against windowed full-cache decode (window {RING_C}), "
        f"{RING_STEPS} steps in f32: max abs diff {ring_err:.3e}")

    # (c) a request with same-length peers against its solo run, in f32
    for name, stream in streams.items():
        err, b = batch_vs_solo(dev, cfg32, model32, name, stream)
        log(f"phase 12 (c): {name}: request 0 with {b - 1} same-length "
            f"peers against its solo run, f32, its solo tokens "
            f"fed to both: logits max abs diff {err:.3e} (bound {LM_ATOL})")
    del model32
    torch.cuda.empty_cache()

    # (d) the monitor at full width
    mon, med_id, med_ood, err, walls = lm_monitor(dev, cfg, model, "(d)")
    torch.cuda.synchronize()
    launches = kernel_counts()
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              f"transformer serving path")
    log(f"phase 12 (d): monitor {MonitorConfig()}: {MON_CLIENTS} clients x "
        f"{MON_BATCHES} batches of {MON_ROWS} x {MON_LEN} tokens; feature "
        f"extraction {walls[0]:.3f} s, local fits + aggregate {walls[1]:.3f} "
        f"s, scoring {2 * MON_SCORED} sequences {walls[2]:.3f} s; median "
        f"anomaly score ID {med_id:.4f}, OOD {med_ood:.4f}; scores against "
        f"the plain version max abs err {err:.3e} (rtol/atol 2e-4); "
        f"launches {launches}")
    check(med_ood > med_id, f"the monitor scores OOD traffic (median "
          f"{med_ood}) no higher than ID traffic (median {med_id})")
    for entry in report["kernels"]:
        entry["launches_by_path"]["transformer_serving"] = \
            launches[entry["name"]]
    del model, mon
    torch.cuda.empty_cache()
    log(f"phase 12: took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 13: the substrate's training path and its MoE family
# ----------------------------------------------------------------------

# (a) internlm2-1.8b training at full width and depth
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_LR = 10, 4, 1024, 3e-4
# (b) the card against the CPU: the smoke configs in f32, TF32 off
CARD_CPU_ARCHS = ("internlm2-1.8b", "deepseek-moe-16b", "mixtral-8x7b")
CARD_CPU_STEPS, CARD_CPU_B, CARD_CPU_S, CARD_CPU_RTOL = 3, 2, 64, 1e-4
# (c) remat and the chunked loss at smoke width, f32, S = 1024 (two loss
# chunks of the configs' 512)
REMAT_ARCHS = ("internlm2-1.8b", "deepseek-moe-16b")
REMAT_B, REMAT_S, REMAT_TOL = 2, 1024, 1e-5
# (d) deepseek-moe-16b whole, served on phase 12's streams; its f32 decode
# against prefill on a 4-layer copy at the drop-free capacity factor
MOE_ARCH = "deepseek-moe-16b"
MOE_PARAMS = 16_375_728_128
MOE_CONSIST_LAYERS = 4
# (e) full width, reduced depth: deepseek-moe-16b's dense layer and one MoE
# layer trained; mixtral-8x7b's two layers in f32 past its 4,096 window
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS, MOE_TRAIN_STEPS = 2, 1_091_315_712, 5
MIX_ARCH, MIX_LAYERS, MIX_PARAMS = "mixtral-8x7b", 2, 3_164_688_384
MIX_PROMPT, MIX_STEPS = 4160, 8


def drop_free(cfg):
    """``cfg`` with capacity factor ``n_experts``: no routed choice can
    drop, so a token's output does not depend on its group's peers."""
    import dataclasses
    return dataclasses.replace(cfg, moe=cfg.moe._replace(
        capacity_factor=float(cfg.moe.n_experts)))


def train_batches(seed, cfg, b, s, n, dev):
    """``data.tokens.batches`` as tensors on ``dev``."""
    import torch
    from repro_torch.data.tokens import batches
    return [{"tokens": torch.as_tensor(t.tokens, device=dev),
             "targets": torch.as_tensor(t.targets, device=dev),
             "mask": torch.as_tensor(t.mask, device=dev)}
            for t in batches(seed, cfg.vocab_size, b, s, n)]


def train_full_width(dev):
    """(a) internlm2-1.8b: f32 masters from seed 0 at full width and depth,
    bf16 compute, remat on; TRAIN_STEPS steps of ``batches(0, vocab,
    TRAIN_B, TRAIN_S, TRAIN_STEPS)``, then one profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamWConfig, init_opt_state, schedule
    cfg = get_config(LM_ARCH, "full")
    check(cfg.remat and cfg.dtype == torch.bfloat16
          and cfg.loss_chunk == 512, f"{LM_ARCH}: not remat on, bf16, "
          f"loss_chunk 512")
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev.type, master=True)
    state = init_opt_state(model)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = count_params(model)
    check(n_params == LM_PARAMS, f"{LM_ARCH} masters: {n_params:,} "
          f"parameters, not {LM_PARAMS:,}")
    check(all(p.dtype == torch.float32 and p.requires_grad
              for p in model.parameters()), "the masters are not f32 "
          "trainable")
    held = torch.cuda.memory_allocated()
    step = make_train_step(cfg, opt)
    data = train_batches(0, cfg, TRAIN_B, TRAIN_S, TRAIN_STEPS, dev)
    torch.cuda.reset_peak_memory_stats()
    rows, walls = [], []
    for i, batch in enumerate(data):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rows.append(m)
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"(a) step {i + 1}: loss {m['loss']}, grad_norm "
              f"{m['grad_norm']}")
        check(m["lr"] == schedule(opt, i + 1), f"(a) step {i + 1}: lr "
              f"{m['lr']} is not the schedule's {schedule(opt, i + 1)}")
        log(f"phase 13 (a): step {i + 1}: loss {m['loss']:.6f}, nll "
            f"{m['nll']:.6f}, grad_norm {m['grad_norm']:.6f}, lr "
            f"{m['lr']:.6e}, wall {walls[-1]:.4f} s")
    peak = torch.cuda.max_memory_allocated()
    check(rows[-1]["loss"] < rows[0]["loss"], f"(a) the loss did not fall: "
          f"{[r['loss'] for r in rows]}")
    busy, pwall, by_name, _ = profiled_busy(lambda: step(model, state,
                                                         data[-1]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    med = float(np.median(walls[2:]))
    tokens = TRAIN_B * TRAIN_S
    log(f"phase 13 (a): {LM_ARCH} full ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), {n_params:,} f32 master parameters built in "
        f"{t_build:.3f} s, {lm_gib(held)} with m and v; {TRAIN_STEPS} steps "
        f"of B = {TRAIN_B}, S = {TRAIN_S}, lr {TRAIN_LR}, warmup 1, bf16 "
        f"compute, remat on: loss {rows[0]['loss']:.6f} -> "
        f"{rows[-1]['loss']:.6f}; median step wall (steps 3-{TRAIN_STEPS}) "
        f"{med:.4f} s (first {walls[0]:.4f} s), {tokens / med:.1f} tokens/s,"
        f" model {6 * n_params * tokens / med / 1e12:.1f} TFLOP/s as "
        f"6 N tokens / step wall (the remat recompute not counted); peak "
        f"memory {lm_gib(peak)}; one profiled step: device busy "
        f"{busy:.2f} ms of {pwall:.2f} ms wall, idle share "
        f"{1 - busy / pwall:.4f}; largest device items (ms) " + ", ".join(
            f"{ms:.2f} {name.replace('void at::native::', '')[:80]}"
            for name, ms in top) + f"; {card_line()}")
    del model, state, data
    torch.cuda.empty_cache()


def card_against_cpu(dev):
    """(b) the smoke configs in f32 (TF32 off): masters from seed 0 built
    on the CPU and copied to the card, CARD_CPU_STEPS ``train_step``s on
    each device on the same batches. Loss and grad_norm every step, and
    the parameters after step 1, within CARD_CPU_RTOL relative; a
    parameter whose step-1 gradient is under 1e-2 of its tensor's largest
    may move by Adam's ``lr`` with either sign, so it is held within
    ``2 * lr`` instead."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=CARD_CPU_STEPS)
    for arch in CARD_CPU_ARCHS:
        cfg = dataclasses.replace(get_config(arch, "smoke"),
                                  dtype=torch.float32)
        cpu = init_params(0, cfg, device="cpu", master=True)
        card = copy.deepcopy(cpu).to(dev)
        s_cpu, s_card = init_opt_state(cpu), init_opt_state(card)
        step = make_train_step(cfg, opt)
        data = train_batches(1, cfg, CARD_CPU_B, CARD_CPU_S, CARD_CPU_STEPS,
                             "cpu")
        worst, sharp_err, loose_err = 0.0, 0.0, 0.0
        for i, batch in enumerate(data):
            a = step(cpu, s_cpu, batch)
            b = step(card, s_card, {k: v.to(dev) for k, v in batch.items()})
            for k in ("loss", "grad_norm"):
                rel = abs(b[k] - a[k]) / abs(a[k])
                worst = max(worst, rel)
                check(rel <= CARD_CPU_RTOL, f"(b) {arch} step {i + 1}: {k} "
                      f"card {b[k]} against cpu {a[k]}")
            if i:
                continue
            for (n, p), (_, q) in zip(cpu.named_parameters(),
                                      card.named_parameters()):
                p, q = p.detach(), q.detach().cpu()
                g = s_cpu["m"][n].abs()
                sharp = g >= 1e-2 * g.max()
                sharp_err = max(sharp_err, close(
                    q[sharp], p[sharp], CARD_CPU_RTOL, 1e-7,
                    f"(b) {arch}: {n} after step 1"))
                loose_err = max(loose_err, float((q - p).abs().max()))
                check(loose_err <= 2 * a["lr"] + 1e-6, f"(b) {arch}: {n} "
                      f"parted by {loose_err} after step 1")
        log(f"phase 13 (b): {arch} smoke, f32, TF32 off, {CARD_CPU_STEPS} "
            f"steps of B = {CARD_CPU_B}, S = {CARD_CPU_S} on the card and "
            f"the CPU: loss and grad_norm largest relative difference "
            f"{worst:.3e} (bound {CARD_CPU_RTOL}); parameters after step 1 "
            f"max abs diff {sharp_err:.3e} where the gradient is sharp "
            f"(rtol {CARD_CPU_RTOL}), {loose_err:.3e} over all (bound "
            f"2 lr = {2 * opt.lr})")


def remat_and_chunking(dev):
    """(c) on the card, f32, smoke width, S = REMAT_S: one step's loss and
    gradients with remat on against off, and the chunked loss against the
    single shot at the same weights, within REMAT_TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batches
    from repro_torch.models import init_params, train_forward

    def loss_and_grads(cfg, batch):
        model = init_params(0, cfg, device=dev.type, master=True)
        loss, _ = train_forward(model, cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, list(
            model.parameters()))

    for arch in REMAT_ARCHS:
        base = dataclasses.replace(get_config(arch, "smoke"),
                                   dtype=torch.float32)
        b = next(batches(2, base.vocab_size, REMAT_B, REMAT_S, 1))
        batch = {"tokens": b.tokens, "targets": b.targets, "mask": b.mask}
        runs = {name: loss_and_grads(dataclasses.replace(base, **kw), batch)
                for name, kw in (("remat off", dict(remat=False)),
                                 ("remat on", dict(remat=True)),
                                 ("single shot", dict(loss_chunk=0)))}
        ref_loss, ref_grads = runs["remat off"]
        errs = {}
        for name in ("remat on", "single shot"):
            loss, grads = runs[name]
            errs[name] = max([close(loss, ref_loss, REMAT_TOL, REMAT_TOL,
                                    f"(c) {arch}: {name} loss")]
                             + [close(g, r, REMAT_TOL, REMAT_TOL,
                                      f"(c) {arch}: {name} gradients")
                                for g, r in zip(grads, ref_grads)])
        log(f"phase 13 (c): {arch} smoke, f32, B = {REMAT_B}, S = {REMAT_S} "
            f"(loss_chunk {base.loss_chunk}, chunk_q {base.chunk_q}): loss "
            f"{float(ref_loss):.6f}; remat on against off max abs diff "
            f"{errs['remat on']:.3e}, chunked loss against the single shot "
            f"{errs['single shot']:.3e} over the loss and every gradient "
            f"(rtol/atol {REMAT_TOL})")


def serve_moe_whole(dev, report):
    """(d) deepseek-moe-16b whole (28 layers, bf16) on phase 12's two
    streams through ``ServeEngine``, the FedGenGMM monitor attached to the
    cli stream's engine; the monitor's four clients' fits, round and
    scoring at full width; then f32 decode against prefill on a
    MOE_CONSIST_LAYERS-layer copy at the drop-free capacity factor."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params
    from repro_torch.monitor import FedGMMMonitor, MonitorConfig
    cfg = get_config(MOE_ARCH, "full")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev.type)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = count_params(model)
    mem = torch.cuda.memory_allocated() - base
    check(n_params == MOE_PARAMS, f"{MOE_ARCH}: {n_params:,} parameters, "
          f"not {MOE_PARAMS:,}")
    check(model.layers[0].ffn is not None and all(
        b.moe is not None for b in model.layers[1:]), f"{MOE_ARCH}: not one "
        f"dense layer then MoE layers")
    log(f"phase 13 (d): {MOE_ARCH} full ({cfg.n_layers} layers, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
        f"{cfg.moe.n_shared} shared, capacity factor "
        f"{cfg.moe.capacity_factor}) from seed 0: {n_params:,} parameters, "
        f"bf16 {lm_gib(mem)} allocated, built in {t_build:.3f} s")
    mon = FedGMMMonitor(cfg, MonitorConfig(), device=dev.type)
    observed = []
    observe = mon.observe
    mon.observe = lambda cid, p, b: (observed.append(cid), observe(cid, p, b))
    for name in LM_STREAMS:
        _, stats = serve_lm_stream(dev, cfg, model, name,
                                   monitor=mon if name == "cli" else None)
        log(f"phase 13 (d): {MOE_ARCH} {name}: {stats}; {card_line()}")
    n_cli, _, _, cli_batch, _ = LM_STREAMS["cli"]
    check(observed == [0] * -(-n_cli // cli_batch),
          f"the monitor observed {observed}, not once a batch as client 0")
    mon, med_id, med_ood, err, walls = lm_monitor(dev, cfg, model, "(d)")
    log(f"phase 13 (d): the cli stream's monitor observed {len(observed)} "
        f"batches, once a batch; the monitor at {MOE_ARCH}'s width: "
        f"features {walls[0]:.3f} s, fits + round {walls[1]:.3f} s, scoring "
        f"{walls[2]:.3f} s; median anomaly score ID {med_id:.4f}, OOD "
        f"{med_ood:.4f}; scores against the plain version max abs err "
        f"{err:.3e}")
    del model, mon
    torch.cuda.empty_cache()
    cfg32 = drop_free(dataclasses.replace(cfg, n_layers=MOE_CONSIST_LAYERS,
                                          dtype=torch.float32))
    model32 = init_params(0, cfg32, device=dev.type)
    n32 = count_params(model32)
    err32, agree32 = lm_consistency(dev, model32, cfg32,
                                    np.random.default_rng(13), "(d) f32")
    check(err32 <= LM_ATOL, f"(d) f32 decode against prefill: max abs diff "
          f"{err32} beyond {LM_ATOL}")
    log(f"phase 13 (d): {MOE_CONSIST_LAYERS}-layer f32 copy ({n32:,} "
        f"parameters, {lm_gib(4 * n32)}), capacity factor "
        f"{cfg32.moe.capacity_factor} (drop-free), decode against prefill, "
        f"B = {CONSIST_B}, a {CONSIST_PROMPT}-token prompt, {CONSIST_STEPS} "
        f"steps: max abs diff {err32:.3e} (bound {LM_ATOL}), greedy "
        f"agreement {agree32:.4f}")
    del model32
    torch.cuda.empty_cache()


def train_moe_reduced(dev):
    """(e) deepseek-moe-16b at MOE_TRAIN_LAYERS layers (its dense layer and
    one MoE layer) at full width: MOE_TRAIN_STEPS steps at B = TRAIN_B,
    S = TRAIN_S, bf16 compute, remat on. Losses finite and falling, aux
    finite and above 0, and every routed expert, the router and the
    shared experts given nonzero gradients (read from Adam's first
    moment, the sum of the steps' clipped gradients)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = dataclasses.replace(get_config(MOE_ARCH, "full"),
                              n_layers=MOE_TRAIN_LAYERS)
    model = init_params(0, cfg, device=dev.type, master=True)
    n_params = count_params(model)
    check(n_params == MOE_TRAIN_PARAMS, f"(e) {MOE_ARCH} at "
          f"{MOE_TRAIN_LAYERS} layers: {n_params:,} parameters, not "
          f"{MOE_TRAIN_PARAMS:,}")
    state = init_opt_state(model)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                            total_steps=MOE_TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    rows, walls = [], []
    for batch in train_batches(0, cfg, TRAIN_B, TRAIN_S, MOE_TRAIN_STEPS,
                               dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(step(model, state, batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in rows]
    auxes = [r["aux"] for r in rows]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(e) losses not finite and falling: {losses}")
    check(all(np.isfinite(a) and a > 0 for a in auxes),
          f"(e) aux not finite and above 0: {auxes}")
    moe_layer = "layers.1.moe"
    m = state["m"]
    for name in ("w_gate", "w_up", "w_down"):
        per_expert = m[f"{moe_layer}.{name}"].abs().flatten(1).amax(1)
        check(bool((per_expert > 0).all()), f"(e) {name}: experts "
              f"{torch.nonzero(per_expert == 0).flatten().tolist()} took "
              f"no gradient")
    for name in ("router", "shared.w_gate", "shared.w_up", "shared.w_down"):
        check(float(m[f"{moe_layer}.{name}"].abs().max()) > 0,
              f"(e) {name} took no gradient")
    tokens = TRAIN_B * TRAIN_S
    med = float(np.median(walls[1:]))
    log(f"phase 13 (e): {MOE_ARCH} cut to {MOE_TRAIN_LAYERS} layers (the "
        f"dense layer and one MoE layer; full width), {n_params:,} f32 "
        f"master parameters, {MOE_TRAIN_STEPS} steps of B = {TRAIN_B}, S = "
        f"{TRAIN_S}: loss " + " ".join(f"{x:.6f}" for x in losses)
        + "; aux " + " ".join(f"{x:.6f}" for x in auxes)
        + "; grad_norm " + " ".join(f"{r['grad_norm']:.4f}" for r in rows)
        + f"; every expert of w_gate/w_up/w_down, the router and the shared "
        f"experts took gradients; median step wall (steps 2-"
        f"{MOE_TRAIN_STEPS}) {med:.4f} s, {tokens / med:.1f} tokens/s; peak "
        f"memory {lm_gib(peak)}")
    del model, state
    torch.cuda.empty_cache()


def mixtral_ring_reduced(dev):
    """(e) mixtral-8x7b at MIX_LAYERS layers, full width, f32, drop-free:
    a MIX_PROMPT-token prompt (past the 4,096 window), then MIX_STEPS
    greedy decode steps through a ring cache of the window's capacity and
    through a full cache with the window mask, logits within LM_ATOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (count_params, decode_step, init_params,
                                    prefill_forward)
    cfg = drop_free(dataclasses.replace(get_config(MIX_ARCH, "full"),
                                        n_layers=MIX_LAYERS,
                                        dtype=torch.float32))
    model = init_params(0, cfg, device=dev.type)
    n_params = count_params(model)
    check(n_params == MIX_PARAMS, f"(e) {MIX_ARCH} at {MIX_LAYERS} layers: "
          f"{n_params:,} parameters, not {MIX_PARAMS:,}")
    w = cfg.window
    check(MIX_PROMPT > w, "the prompt does not pass the window")
    prompt = torch.as_tensor(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (1, MIX_PROMPT)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    la, ring = prefill_forward(model, cfg, {"tokens": prompt}, capacity=w,
                               ring=True)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    lb, full = prefill_forward(model, cfg, {"tokens": prompt},
                               capacity=MIX_PROMPT + MIX_STEPS)
    check(ring[0]["k"].shape[1] == w, "the ring cache is not the window "
          "wide")
    err = close(la, lb, LM_RTOL, LM_ATOL, "(e) mixtral prefill logits")
    tok = torch.argmax(lb, -1)
    for i in range(MIX_STEPS):
        a, ring = decode_step(model, cfg, ring, tok, MIX_PROMPT + i,
                              ring=True)
        b, full = decode_step(model, cfg, full, tok, MIX_PROMPT + i)
        err = max(err, close(a, b, LM_RTOL, LM_ATOL, f"(e) mixtral ring "
                             f"decode step {i} against the windowed full "
                             f"cache"))
        tok = torch.argmax(b, -1)
    log(f"phase 13 (e): {MIX_ARCH} cut to {MIX_LAYERS} layers (full width, "
        f"f32, capacity factor {cfg.moe.capacity_factor}), {n_params:,} "
        f"parameters: a {MIX_PROMPT}-token prompt (prefill {t_prefill:.3f} "
        f"s), then {MIX_STEPS} decode steps through a ring cache of "
        f"capacity {w} against a full cache with the window mask: logits "
        f"max abs diff {err:.3e} (bound {LM_ATOL})")
    del model, ring, full
    torch.cuda.empty_cache()


def phase_training_moe(dev, report):
    """Phase 13: (a) internlm2-1.8b trained at full width and depth; (b)
    the smoke configs' steps on the card against the CPU; (c) remat and
    the chunked loss; (d) deepseek-moe-16b whole behind ``ServeEngine``
    with the monitor; (e) deepseek-moe-16b trained and mixtral-8x7b's ring
    against its window at full width, reduced depth."""
    t_phase = time.perf_counter()
    reset_counts()
    train_full_width(dev)
    card_against_cpu(dev)
    remat_and_chunking(dev)
    serve_moe_whole(dev, report)
    launches = kernel_counts()
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
              f"monitor in phase 13")
    for entry in report["kernels"]:
        entry["launches_by_path"]["transformer_training_moe"] = \
            launches[entry["name"]]
    log(f"phase 13 (d): kernel launches {launches}")
    train_moe_reduced(dev)
    mixtral_ring_reduced(dev)
    log(f"phase 13: took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 14: the RG-LRU, xLSTM and encoder-decoder families
# ----------------------------------------------------------------------

RG_ARCH, RG_PARAMS = "recurrentgemma-9b", 11_712_739_328
# (a) the JAX serve CLI's stream, and one past the 2,048-token local window
RG_STREAMS = {"cli": LM_STREAMS["cli"],
              "long": (8, (2100, 2600), 16, 4, 2688)}
# (b) f32, TF32 off, on a prompt past the window: decode against the full
# forward, ring (capacity = local_window) against windowed decode
RG_B, RG_PROMPT, RG_CONSIST_STEPS, RG_RING_STEPS = 2, 2100, 4, 8
# (c) one pattern group (rglru, rglru, local_attn) at full width, trained
RG_TRAIN_LAYERS, RG_TRAIN_PARAMS = 3, 2_851_174_400
RG_TRAIN_B, RG_TRAIN_S = 2, 1024
# (d) xlstm-350m whole: served, trained (S = 512 > chunk_q = 256: the
# chunked mLSTM and its checkpoints); cut to two layers (one mLSTM, one
# sLSTM) at full width, trained on the same batches and, in f32, the card
# against the CPU
XL_ARCH, XL_PARAMS = "xlstm-350m", 449_324_128
XL_TRAIN_B, XL_TRAIN_S = 8, 512
# the monitor's sequences for xlstm-350m: the sLSTM loop runs once a token
MON_LEN_XLSTM = 32
XL_CPU_LAYERS, XL_CPU_PARAMS, XL_CPU_B, XL_CPU_S = 2, 131_881_992, 2, 320
XL_CPU_RTOL = 1e-4
# (e) seamless-m4t-medium whole
SM_ARCH, SM_PARAMS = "seamless-m4t-medium", 977_860_608
SM_TRAIN_B, SM_TRAIN_S = 8, 512
RECUR_TRAIN_STEPS, RECUR_LR = 10, 3e-4
# (f) the recurrences alone at full width: (layer type, B, S)
RECUR_SHAPES = (("rglru", 1, 2048), ("mlstm", 8, 1024), ("slstm", 8, 1024))


def serve_and_monitor(dev, cfg, model, streams, tag, seq_len=None):
    """Serve ``streams`` through bf16 ``ServeEngine``s, the FedGenGMM
    monitor attached to the cli stream's (one ``observe`` a batch); then
    phase 12's monitor at this model's width, its scores against the plain
    version. OOD against ID is reported, not gated (random weights)."""
    from repro_torch.monitor import FedGMMMonitor, MonitorConfig
    mon = FedGMMMonitor(cfg, MonitorConfig(), device=dev.type)
    observed = []
    observe = mon.observe
    mon.observe = lambda cid, p, b: (observed.append(cid), observe(cid, p, b))
    for name, spec in streams.items():
        _, stats = serve_lm_stream(dev, cfg, model, name,
                                   monitor=mon if name == "cli" else None,
                                   spec=spec)
        log(f"phase 14 {tag}: {cfg.name} {name}: {stats}; {card_line()}")
    n_cli, _, _, cli_batch, _ = streams["cli"]
    check(observed == [0] * -(-n_cli // cli_batch),
          f"{tag} the monitor observed {observed}, not once a batch as "
          f"client 0")
    _, med_id, med_ood, err, walls = lm_monitor(dev, cfg, model, tag,
                                                seq_len=seq_len)
    log(f"phase 14 {tag}: the cli stream's monitor observed {len(observed)} "
        f"batches, once a batch; the monitor at {cfg.name}'s width "
        f"({MON_CLIENTS} clients x {MON_BATCHES} batches of {MON_ROWS} x "
        f"{seq_len or MON_LEN} tokens): "
        f"features {walls[0]:.3f} s, fits + round {walls[1]:.3f} s, scoring "
        f"{walls[2]:.3f} s; median anomaly score ID {med_id:.4f}, OOD "
        f"{med_ood:.4f} (OOD above ID: {med_ood > med_id}; not gated); "
        f"scores against the plain version max abs err {err:.3e} (rtol/atol "
        f"2e-4); kernel launches in phase 14 so far {kernel_counts()}")


def build_full(dev, cfg, expect, tag, **kw):
    """``init_params(0, cfg)`` on the card, its parameter count held to
    ``expect`` -> (model, GiB allocated by it, build seconds)."""
    import torch
    from repro_torch.models import count_params, init_params
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = init_params(0, cfg, device=dev.type, **kw)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n = count_params(model)
    check(n == expect, f"{tag} {cfg.name}: {n:,} parameters, not {expect:,}")
    return model, lm_gib(torch.cuda.memory_allocated() - base), t_build


def run_train_steps(dev, cfg, model, batches, profile_last=False):
    """``make_train_step`` over ``batches`` from fresh AdamW state at lr
    RECUR_LR (warmup 1) -> (metrics a step, walls, peak bytes, the
    optimizer state, (busy, wall, top items) of the last step run under
    the profiler, or None; that step's wall is the profiler's)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, init_opt_state
    state = init_opt_state(model)
    step = make_train_step(cfg, AdamWConfig(lr=RECUR_LR, warmup_steps=1,
                                            total_steps=len(batches)))
    torch.cuda.reset_peak_memory_stats()
    rows, walls, prof = [], [], None
    for i, batch in enumerate(batches):
        if profile_last and i == len(batches) - 1:
            busy, pwall, by_name, _ = profiled_busy(
                lambda: rows.append(step(model, state, batch)))
            walls.append(pwall / 1e3)
            prof = (busy, pwall, sorted(by_name.items(),
                                        key=lambda kv: -kv[1])[:5])
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(step(model, state, batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return rows, walls, torch.cuda.max_memory_allocated(), state, prof


def finite_and_falling(rows):
    """(every loss and grad norm finite, the last loss below the first)."""
    import numpy as np
    losses = [r["loss"] for r in rows]
    return (all(np.isfinite(losses))
            and all(np.isfinite(r["grad_norm"]) for r in rows),
            losses[-1] < losses[0])


def every_leaf_moved(state, model, kinds, tag):
    """Every leaf of the modules named ``kinds`` took a nonzero gradient
    (read from Adam's first moment, the sum of the steps' clipped
    gradients) -> how many leaves were checked."""
    names = [n for n, _ in model.named_parameters()
             if any(f".{k}." in n for k in kinds)]
    check(names, f"{tag} no {kinds} leaves")
    still = [n for n in names if float(state["m"][n].abs().max()) == 0]
    check(not still, f"{tag} leaves took no gradient: {still[:5]}")
    return len(names)


def train_line(rows, walls, peak, tokens, first=2):
    """Losses, grad norms, the median step wall from step ``first + 1``,
    tokens/s and peak memory of a training run, as one line."""
    import numpy as np
    med = float(np.median(walls[first:]))
    return (f"loss " + " ".join(f"{r['loss']:.4f}" for r in rows)
            + "; grad_norm " + " ".join(f"{r['grad_norm']:.3f}"
                                        for r in rows)
            + f"; median step wall (steps {first + 1}-{len(walls)}) "
            f"{med:.4f} s (first {walls[0]:.3f} s), {tokens / med:.1f} "
            f"tokens/s; peak memory {lm_gib(peak)}")


def recurrentgemma_served(dev):
    """(a) recurrentgemma-9b whole in bf16 behind ``ServeEngine`` on the
    JAX CLI's stream (the monitor attached) and a stream past the local
    window, then the monitor at its width."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(RG_ARCH, "full")
    model, mem, t_build = build_full(dev, cfg, RG_PARAMS, "(a)")
    blk = model.layers[0].rglru
    check(blk.w_r.dtype == torch.bfloat16
          and blk.log_lambda.dtype == torch.float32,
          "(a) the serving model's RG-LRU matrices are not bf16 or its "
          "log_lambda not f32")
    log(f"phase 14 (a): {RG_ARCH} full ({cfg.n_layers} layers "
        f"{cfg.pattern} x {cfg.n_groups} + {cfg.n_tail}, d_model "
        f"{cfg.d_model}, d_rnn {cfg.d_rnn}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} head_dim {cfg.hd}, local window "
        f"{cfg.local_window}, vocab {cfg.vocab_size}) from seed 0: "
        f"{RG_PARAMS:,} parameters, bf16 {mem} allocated, built in "
        f"{t_build:.3f} s")
    serve_and_monitor(dev, cfg, model, RG_STREAMS, "(a)")
    del model
    torch.cuda.empty_cache()


def recurrentgemma_f32(dev):
    """(b) recurrentgemma-9b in f32 at full width and depth (TF32 off) on a
    RG_PROMPT-token prompt past the window: decode against the full
    forward, and ring decode (capacity = local_window) against windowed
    full-cache decode, each within LM_ATOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, prefill_forward
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    cfg = dataclasses.replace(get_config(RG_ARCH, "full"),
                              dtype=torch.float32)
    model, mem, t_build = build_full(dev, cfg, RG_PARAMS, "(b)")
    rng = np.random.default_rng(14)
    check(RG_PROMPT > cfg.local_window, "the prompt is inside the window")
    t0 = time.perf_counter()
    err, agree = lm_consistency(dev, model, cfg, rng, "(b) f32", b=RG_B,
                                prompt_len=RG_PROMPT,
                                steps=RG_CONSIST_STEPS)
    t_consist = time.perf_counter() - t0
    check(err <= LM_ATOL, f"(b) f32 decode against the full forward: max "
          f"abs diff {err} beyond {LM_ATOL}")
    w = cfg.local_window
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (RG_B, RG_PROMPT)), device=dev)
    _, ring = prefill_forward(model, cfg, {"tokens": prompt}, capacity=w,
                              ring=True)
    lb, full = prefill_forward(model, cfg, {"tokens": prompt},
                               capacity=RG_PROMPT + RG_RING_STEPS)
    check(ring[2]["k"].shape[1] == w, "(b) the ring cache is not the "
          "window wide")
    tok = torch.argmax(lb, -1)
    ring_err = 0.0
    for i in range(RG_RING_STEPS):
        a, ring = decode_step(model, cfg, ring, tok, RG_PROMPT + i,
                              ring=True)
        b, full = decode_step(model, cfg, full, tok, RG_PROMPT + i)
        ring_err = max(ring_err, close(a, b, LM_RTOL, LM_ATOL,
                                       f"(b) ring decode step {i} against "
                                       f"the windowed full cache"))
        tok = torch.argmax(b, -1)
    log(f"phase 14 (b): {RG_ARCH} f32 at full depth ({mem} allocated, "
        f"built in {t_build:.3f} s), TF32 off, B = {RG_B}, a {RG_PROMPT}-"
        f"token prompt past the {w}-token window: {RG_CONSIST_STEPS} decode "
        f"steps against the full forward max abs diff {err:.3e} (bound "
        f"{LM_ATOL}), greedy agreement {agree:.4f} ({t_consist:.1f} s); "
        f"ring decode at capacity {w} against windowed full-cache decode, "
        f"{RG_RING_STEPS} steps: max abs diff {ring_err:.3e}")
    del model, ring, full
    torch.cuda.empty_cache()


def recurrentgemma_trained(dev):
    """(c) recurrentgemma-9b cut to one pattern group (3 layers) at full
    width: RECUR_TRAIN_STEPS steps on ``batches(0, 256000, 2, 1024, 10)``
    (the chunked loss), every RG-LRU leaf given a gradient."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(RG_ARCH, "full"),
                              n_layers=RG_TRAIN_LAYERS)
    model, mem, _ = build_full(dev, cfg, RG_TRAIN_PARAMS, "(c)",
                               master=True)
    data = train_batches(0, cfg, RG_TRAIN_B, RG_TRAIN_S, RECUR_TRAIN_STEPS,
                         dev)
    rows, walls, peak, state, _ = run_train_steps(dev, cfg, model, data)
    finite, falling = finite_and_falling(rows)
    check(finite and falling, f"(c) losses not finite and falling: "
          f"{[r['loss'] for r in rows]}")
    n = every_leaf_moved(state, model, ("rglru",), "(c)")
    log(f"phase 14 (c): {RG_ARCH} cut to {RG_TRAIN_LAYERS} layers "
        f"({cfg.pattern}, full width), {RG_TRAIN_PARAMS:,} f32 master "
        f"parameters ({mem}), {RECUR_TRAIN_STEPS} steps of B = "
        f"{RG_TRAIN_B}, S = {RG_TRAIN_S} (loss_chunk {cfg.loss_chunk}), lr "
        f"{RECUR_LR}, bf16 compute, remat on: "
        + train_line(rows, walls, peak, RG_TRAIN_B * RG_TRAIN_S)
        + f"; all {n} RG-LRU leaves took gradients")
    del model, state, data
    torch.cuda.empty_cache()


def xlstm_card_against_cpu(dev):
    """(d) xlstm-350m cut to XL_CPU_LAYERS layers (one mLSTM, one sLSTM)
    at full width in f32: one ``train_step`` from the same masters on the
    CPU and on the card, loss and grad_norm within XL_CPU_RTOL."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import count_params, init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = dataclasses.replace(get_config(XL_ARCH, "full"),
                              n_layers=XL_CPU_LAYERS, dtype=torch.float32)
    cpu = init_params(0, cfg, device="cpu", master=True)
    check(count_params(cpu) == XL_CPU_PARAMS, f"(d) {XL_ARCH} at "
          f"{XL_CPU_LAYERS} layers: not {XL_CPU_PARAMS:,} parameters")
    card = copy.deepcopy(cpu).to(dev)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=1))
    batch = train_batches(3, cfg, XL_CPU_B, XL_CPU_S, 1, "cpu")[0]
    a = step(cpu, init_opt_state(cpu), batch)
    b = step(card, init_opt_state(card),
             {k: v.to(dev) for k, v in batch.items()})
    rel = {k: abs(b[k] - a[k]) / abs(a[k]) for k in ("loss", "grad_norm")}
    for k, r in rel.items():
        check(r <= XL_CPU_RTOL, f"(d) {k}: card {b[k]} against cpu {a[k]}")
    log(f"phase 14 (d): {XL_ARCH} cut to {cfg.layer_types()} at full width, "
        f"f32, TF32 off, one step of B = {XL_CPU_B}, S = {XL_CPU_S} (the "
        f"chunked mLSTM at chunk_q {cfg.chunk_q}) on the card and the CPU: "
        f"loss {a['loss']:.6f}, relative difference {rel['loss']:.3e}; "
        f"grad_norm {a['grad_norm']:.6f}, relative difference "
        f"{rel['grad_norm']:.3e} (bound {XL_CPU_RTOL})")


def xlstm_two_layers_trained(dev):
    """(d) xlstm-350m cut to XL_CPU_LAYERS layers (one mLSTM, one sLSTM) at
    full width, bf16 compute: RECUR_TRAIN_STEPS steps of ``batches(0,
    50304, 8, 512, 10)``; the loss falls, as the reference's does at this
    cut (the whole stack's does not, in either package)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(XL_ARCH, "full"),
                              n_layers=XL_CPU_LAYERS)
    model, mem, _ = build_full(dev, cfg, XL_CPU_PARAMS, "(d)", master=True)
    data = train_batches(0, cfg, XL_TRAIN_B, XL_TRAIN_S, RECUR_TRAIN_STEPS,
                         dev)
    rows, walls, peak, state, _ = run_train_steps(dev, cfg, model, data)
    log(f"phase 14 (d): {XL_ARCH} cut to {cfg.layer_types()} at full "
        f"width, {XL_CPU_PARAMS:,} f32 master parameters ({mem}), "
        f"{RECUR_TRAIN_STEPS} steps of B = {XL_TRAIN_B}, S = {XL_TRAIN_S}, "
        f"bf16 compute: " + train_line(rows, walls, peak,
                                       XL_TRAIN_B * XL_TRAIN_S))
    finite, falling = finite_and_falling(rows)
    check(finite and falling, f"(d) {XL_CPU_LAYERS} layers: the losses are "
          f"not finite and falling: {rows}")
    n = every_leaf_moved(state, model, ("mlstm", "slstm"), "(d)")
    log(f"phase 14 (d): at {XL_CPU_LAYERS} layers the loss falls and all {n} "
        f"mLSTM and sLSTM leaves took gradients")
    del model, state, data
    torch.cuda.empty_cache()


def xlstm_whole(dev):
    """(d) xlstm-350m whole: served on the CLI stream with the monitor,
    the monitor at its width (MON_LEN_XLSTM-token sequences),
    RECUR_TRAIN_STEPS steps of ``batches(0, 50304, 8, 512, 10)``, the last
    profiled; then two layers trained, and on the card against the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    cfg = get_config(XL_ARCH, "full")
    model, mem, t_build = build_full(dev, cfg, XL_PARAMS, "(d)")
    sl = model.layers[1].slstm
    check(sl.r.dtype == sl.b.dtype == model.layers[0].mlstm.b_if.dtype
          == torch.float32 and sl.w_in.dtype == torch.bfloat16,
          "(d) the serving model's f32 leaves are not f32")
    log(f"phase 14 (d): {XL_ARCH} full ({cfg.n_layers} layers "
        f"{cfg.pattern}, d_model {cfg.d_model}, {cfg.xlstm}, vocab "
        f"{cfg.vocab_size}) from seed 0: {XL_PARAMS:,} parameters, bf16 "
        f"with r, b and b_if f32: {mem}, built in {t_build:.3f} s")
    serve_and_monitor(dev, cfg, model, {"cli": LM_STREAMS["cli"]}, "(d)",
                      seq_len=MON_LEN_XLSTM)
    del model
    torch.cuda.empty_cache()
    model, mem, _ = build_full(dev, cfg, XL_PARAMS, "(d)", master=True)
    data = train_batches(0, cfg, XL_TRAIN_B, XL_TRAIN_S, RECUR_TRAIN_STEPS,
                         dev)
    rows, walls, peak, state, prof = run_train_steps(dev, cfg, model, data,
                                                     profile_last=True)
    finite, falling = finite_and_falling(rows)
    busy, pwall, top = prof
    # the last step ran under the profiler: the median leaves it out
    log(f"phase 14 (d): {XL_ARCH} whole, {XL_PARAMS:,} f32 master "
        f"parameters ({mem}), {RECUR_TRAIN_STEPS} steps of B = "
        f"{XL_TRAIN_B}, S = {XL_TRAIN_S} (chunk_q {cfg.chunk_q}: the "
        f"chunked mLSTM), bf16 compute, remat on, gradients clipped to "
        f"{AdamWConfig().clip_norm}: "
        + train_line(rows, walls[:-1], peak, XL_TRAIN_B * XL_TRAIN_S)
        + f"; the last loss {'below' if falling else 'not below'} the first "
        f"(not gated: the reference's 24-layer stack does not learn in 10 "
        f"steps either, PERF.md section 6); the profiled step: "
        f"{pwall / 1e3:.3f} s, device busy {busy:.2f} ms, idle share "
        f"{1 - busy / pwall:.4f}; largest device items (ms) "
        + ", ".join(f"{ms:.2f} {name.replace('void at::native::', '')[:70]}"
                    for name, ms in top) + f"; {card_line()}")
    check(finite, f"(d) a loss or grad norm is not finite: {rows}")
    n = every_leaf_moved(state, model, ("mlstm", "slstm"), "(d)")
    log(f"phase 14 (d): all {n} mLSTM and sLSTM leaves took gradients")
    del model, state, data
    torch.cuda.empty_cache()
    xlstm_two_layers_trained(dev)
    xlstm_card_against_cpu(dev)


def seamless_frames(cfg, rows, seq_len, seed, dev):
    """Frame embeddings (rows, seq_len // src_ratio, d_model) in the
    trainer's draw (N(0, 0.02)) from default_rng(seed)."""
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(seed).normal(
        0, 0.02, (rows, seq_len // cfg.src_ratio, cfg.d_model)),
        dtype=torch.float32, device=dev).to(cfg.dtype)


def seamless_whole(dev):
    """(e) seamless-m4t-medium whole: RECUR_TRAIN_STEPS steps through
    ``launch.train.train`` (its ``src_embeds`` draw); f32 prefill plus
    decode with the cross-attention cache against the full forward; the
    monitor observing batches with ``src_embeds``, its fits and scores."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    cfg = get_config(SM_ARCH, "full")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, losses = train(SM_ARCH, "full", steps=RECUR_TRAIN_STEPS,
                          batch_size=SM_TRAIN_B, seq_len=SM_TRAIN_S,
                          lr=RECUR_LR, log_every=RECUR_TRAIN_STEPS,
                          device=dev.type)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = sum(int(p.numel()) for p in model.parameters())
    check(n == SM_PARAMS, f"(e) {SM_ARCH}: {n:,} parameters")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"(e) losses not finite and falling: {losses}")
    tokens = SM_TRAIN_B * SM_TRAIN_S * RECUR_TRAIN_STEPS
    log(f"phase 14 (e): {SM_ARCH} full ({cfg.n_enc_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), {SM_PARAMS:,} f32 master parameters, "
        f"{RECUR_TRAIN_STEPS} steps of ``train`` at B = {SM_TRAIN_B}, S = "
        f"{SM_TRAIN_S} with {SM_TRAIN_S // cfg.src_ratio} frames of "
        f"src_embeds: loss " + " ".join(f"{x:.4f}" for x in losses)
        + f"; {wall:.3f} s in all (the build and the first step's warm-up "
        f"included), {tokens / wall:.1f} decoder tokens/s; peak memory "
        f"{lm_gib(peak)}")
    del model
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32, _, _ = build_full(dev, cfg32, SM_PARAMS, "(e)")
    frames = {"src_embeds": seamless_frames(
        cfg32, CONSIST_B, CONSIST_PROMPT, 15, dev)}
    err, agree = lm_consistency(dev, model32, cfg32,
                                np.random.default_rng(15), "(e) f32",
                                extra=frames)
    check(err <= LM_ATOL, f"(e) f32 decode with the cross-attention cache "
          f"against the full forward: max abs diff {err} beyond {LM_ATOL}")
    log(f"phase 14 (e): f32 (TF32 off), B = {CONSIST_B}, a "
        f"{CONSIST_PROMPT}-token prompt over {CONSIST_PROMPT // cfg.src_ratio}"
        f" frames, {CONSIST_STEPS} decode steps with the cross-attention "
        f"cache against the full forward: max abs diff {err:.3e} (bound "
        f"{LM_ATOL}), greedy agreement {agree:.4f}")
    del model32
    torch.cuda.empty_cache()

    model, _, _ = build_full(dev, cfg, SM_PARAMS, "(e)")
    mon, med_id, med_ood, err, walls = lm_monitor(
        dev, cfg, model, "(e)", extra=lambda rows, seed: {
            "src_embeds": seamless_frames(cfg, rows, MON_LEN, seed, dev)})
    log(f"phase 14 (e): the monitor at {SM_ARCH}'s width, every batch with "
        f"{MON_LEN // cfg.src_ratio} frames of src_embeds: features "
        f"{walls[0]:.3f} s, fits + round {walls[1]:.3f} s, scoring "
        f"{walls[2]:.3f} s; median anomaly score ID {med_id:.4f}, OOD "
        f"{med_ood:.4f} (OOD above ID: {med_ood > med_id}; not gated); "
        f"scores against the plain version max abs err {err:.3e}")
    del model, mon
    torch.cuda.empty_cache()


def recurrences_alone(dev):
    """(f) one RG-LRU, one mLSTM and one sLSTM cell at full width in bf16
    (a serving model's leaves for the forward; every leaf bf16 with
    gradients on for forward+backward, as a train step casts them), each
    run once to warm up and once under the profiler: device busy against
    wall, device ops a call, the largest device items."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import make_generator
    from repro_torch.models import rglru, xlstm
    rg, xl = get_config(RG_ARCH, "full"), get_config(XL_ARCH, "full")
    gen = make_generator(0, dev)
    cells = {
        "rglru": (rglru.rglru_init(gen, rg.d_model,
                                   rglru.RGLRUDims(rg.d_rnn), torch.bfloat16),
                  rg.d_model, lambda m, x: rglru.rglru_forward(m, x)),
        "mlstm": (xlstm.mlstm_init(gen, xl.d_model, xl.xlstm, torch.bfloat16),
                  xl.d_model,
                  lambda m, x: xlstm.mlstm_forward(m, x, xl.chunk_q)),
        "slstm": (xlstm.slstm_init(gen, xl.d_model, xl.xlstm, torch.bfloat16),
                  xl.d_model,
                  lambda m, x: xlstm.slstm_forward(m, x, xl.xlstm.n_heads)),
    }
    for kind, b, s in RECUR_SHAPES:
        module, d, fwd = cells[kind]
        x = torch.randn((b, s, d), generator=gen, device=dev,
                        dtype=torch.float32).to(torch.bfloat16)

        def forward():
            with torch.no_grad():
                fwd(module, x)

        trained = type(module)(*(p.detach().to(torch.bfloat16)
                                 for p in module.parameters()))
        trained.requires_grad_()

        def backward():
            out, _ = fwd(trained, x.requires_grad_())
            out.float().sum().backward()

        parts = []
        for what, fn in (("forward", forward), ("forward+backward",
                                                 backward)):
            fn()
            busy, wall, by_name, n_ops = profiled_busy(fn)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            parts.append(
                f"{what}: device busy {busy:.2f} ms of {wall:.2f} ms wall "
                f"(idle {1 - busy / wall:.4f}), {n_ops} device ops, "
                f"largest (ms) " + ", ".join(
                    f"{ms:.2f} {n.replace('void at::native::', '')[:60]}"
                    for n, ms in top))
        log(f"phase 14 (f): {kind} at full width, B = {b}, S = {s}, bf16: "
            + "; ".join(parts) + f"; {card_line()}")
        del module, trained, x
    torch.cuda.empty_cache()


def phase_recurrent_encdec(dev, report):
    """Phase 14: (a) recurrentgemma-9b whole, served with the monitor; (b)
    its f32 decode and ring checks past the window; (c) trained cut to one
    pattern group; (d) xlstm-350m served, trained whole and held to the
    CPU; (e) seamless-m4t-medium trained, checked in f32 and monitored;
    (f) the recurrences alone, timed."""
    t_phase = time.perf_counter()
    reset_counts()
    for part in (recurrentgemma_served, recurrentgemma_f32,
                 recurrentgemma_trained, xlstm_whole, seamless_whole):
        t0 = time.perf_counter()
        part(dev)
        log(f"phase 14: {part.__name__} took {time.perf_counter() - t0:.1f} "
            f"s")
    launches = kernel_counts()
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched by the "
              f"monitor in phase 14")
    for entry in report["kernels"]:
        entry["launches_by_path"]["transformer_recurrent_encdec"] = \
            launches[entry["name"]]
    log(f"phase 14: kernel launches {launches}")
    recurrences_alone(dev)
    log(f"phase 14: took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------------
# Phase 15: the sharding context, the production mesh and the dry-run
# ----------------------------------------------------------------------

DECODE_STEPS = 8
# the dry-run cells run in (b), one CLI process a group, all started
# together: (arch, shapes or None for all four, --mesh)
DRY_GROUPS = (("internlm2-1.8b", None, "single"),
              ("internlm2-1.8b", None, "multi"),
              ("deepseek-moe-16b", ("train_4k",), "single"),
              ("mixtral-8x7b", ("long_500k",), "single"),
              ("recurrentgemma-9b", ("decode_32k",), "single"),
              ("seamless-m4t-medium", ("prefill_32k",), "single"),
              ("xlstm-350m", ("train_4k",), "single"))
DRY_TIMEOUT = 600
AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}


def host_mesh_2d(dev, workdir):
    """A process group of one rank over a ``file://`` store (NCCL on the
    card, gloo where the phase is rehearsed on the CPU) and its (data=1,
    model=1) mesh from ``repro_torch.launch.mesh.make_host_mesh``."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if dev.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{workdir}/store", rank=0,
                            world_size=1)
    return make_host_mesh(1, device_type=dev.type)


def full(t):
    """A ``DTensor``'s whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def bits_or_bound(what, got, want, atol):
    """True where ``got`` is ``want`` bit for bit; else it must be within
    ``atol`` (the substrate's bound for the dtype), and the gap is
    printed."""
    import torch
    got, want = full(got).float(), want.float()
    if torch.equal(got, want):
        return True
    gap = float((got - want).abs().max())
    check(gap <= atol, f"(a) {what}: the DTensor path is {gap:.3e} from the "
          f"plain one, above {atol}")
    log(f"phase 15 (a): {what}: not the same bits, max gap {gap:.3e} "
        f"(bound {atol})")
    return False


def cli_batch(cfg, dev):
    """Phase 12's CLI stream's first batch (max_batch 4), left-padded as
    ``ServeEngine`` pads it -> (tokens (4, L), L)."""
    import numpy as np
    import torch
    reqs = lm_stream("cli", cfg)[:LM_STREAMS["cli"][3]]
    lmax = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), lmax), np.int32)
    for i, r in enumerate(reqs):
        toks[i, lmax - len(r.prompt):] = r.prompt
    return torch.as_tensor(toks, device=dev), lmax


def timed(fn):
    """(result, wall s) of ``fn()``, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_serving(dev, mesh, cfg):
    """(a) serving: internlm2-1.8b's CLI batch prefilled and decoded
    DECODE_STEPS greedy steps, the plain model against its ``DTensor``
    copy (``param_specs(fsdp=None)`` through ``to_shardings``, the batch
    on "data"), the same tokens fed to both."""
    import copy
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import init_params, sharding_ctx
    from repro_torch.models.transformer import param_specs

    model = init_params(0, cfg, device=dev.type)
    tokens, lmax = cli_batch(cfg, dev)
    cap = lmax + DECODE_STEPS
    prefill = steps.make_prefill_step(cfg, cap)
    decode = steps.make_decode_step(cfg)
    # each prefill twice: the first call of a shape warms caches (cuBLAS
    # heuristics; DTensor's sharding propagation)
    t_pre = [timed(lambda: prefill(model, {"tokens": tokens}))[1]]
    (logits, cache), t = timed(lambda: prefill(model, {"tokens": tokens}))
    t_pre.append(t)
    feed, want, t_dec = [], [logits], []
    for i in range(DECODE_STEPS):
        feed.append(torch.argmax(want[-1], -1))
        (lg, cache), t = timed(lambda: decode(model, cache, feed[-1],
                                              lmax + i))
        want.append(lg)
        t_dec.append(t)
    specs = param_specs(cfg, fsdp=None, model_axis_size=1)
    shardings = steps.to_shardings(mesh, specs)
    check(set(shardings) == {n for n, _ in model.named_parameters()},
          "(a) to_shardings does not cover the parameters")
    sharding_ctx.set_axes(batch="data", model="model")
    try:
        dmodel = steps.distribute_params(copy.deepcopy(model), mesh, specs)
        dbatch = steps.distribute_tree({"tokens": tokens}, mesh,
                                       {"tokens": ("data", None)})
        d_pre = [timed(lambda: prefill(dmodel, dbatch))[1]]
        (dlogits, dcache), t = timed(lambda: prefill(dmodel, dbatch))
        d_pre.append(t)
        got, d_dec = [dlogits], []
        for i in range(DECODE_STEPS):
            tok = steps.distribute_tree(feed[i], mesh, ("data",))
            (lg, dcache), t = timed(lambda: decode(dmodel, dcache, tok,
                                                   lmax + i))
            got.append(lg)
            d_dec.append(t)
    finally:
        sharding_ctx.clear_axes()
    same = [bits_or_bound(f"logits at step {i}", g, w, 5e-2)
            for i, (g, w) in enumerate(zip(got, want))]
    same += [bits_or_bound(f"cache layer {i} {k}", dc[k], pc[k], 5e-2)
             for i, (dc, pc) in enumerate(zip(dcache, cache)) for k in pc]
    verdict = "bit-identical" if all(same) else "within 5e-2"
    per = DECODE_STEPS - 1
    log(f"phase 15 (a): {LM_ARCH} serving on the (data=1, model=1) mesh: "
        f"prefill of the CLI batch (4 x {lmax}) and {DECODE_STEPS} decode "
        f"steps, logits and cache {verdict} to the plain model; prefill "
        f"(first, second call) {t_pre[0] * 1e3:.2f}, {t_pre[1] * 1e3:.2f} ms "
        f"plain / {d_pre[0] * 1e3:.2f}, {d_pre[1] * 1e3:.2f} ms DTensor, "
        f"decode "
        f"{1e3 * sum(t_dec[1:]) / per:.2f} / {1e3 * sum(d_dec[1:]) / per:.2f}"
        f" ms a step (steps 2-{DECODE_STEPS}); {card_line()}")
    del model, dmodel, cache, dcache
    torch.cuda.empty_cache()


def mesh_training(dev, mesh, cfg):
    """(a) training and (c) the memory model: one step of phase 13's first
    batch from the seed-0 f32 masters, (c) under the dry-run's live-bytes
    tracker at world size 1 against ``torch.cuda.max_memory_allocated``,
    then plain and on the mesh (FSDP layout, ``param_specs(fsdp="data")``),
    timed, the metrics and the updated masters compared."""
    import torch
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import init_params, sharding_ctx
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim import AdamWConfig, init_opt_state

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS)
    batch = train_batches(0, cfg, TRAIN_B, TRAIN_S, 1, dev)[0]
    # (c): the tracker's prediction against the card's peak, the step's
    # arguments alone resident
    model = init_params(0, cfg, device=dev.type, master=True)
    state = init_opt_state(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = dryrun.count_step(steps._train_step_tensors(cfg, opt),
                            (model, state, batch), in_place=2)["memory"]
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated()
    ratio = mem["peak_bytes"] / card
    check(abs(ratio - 1) <= 0.25, f"(c) the tracker's peak "
          f"{lm_gib(mem['peak_bytes'])} is not within 25% of the card's "
          f"{lm_gib(card)}")
    log(f"phase 15 (c): {LM_ARCH} train step (B = {TRAIN_B}, S = "
        f"{TRAIN_S}) at world size 1: predicted peak "
        f"{lm_gib(mem['peak_bytes'])} (argument "
        f"{lm_gib(mem['argument_bytes'])} + max(output "
        f"{lm_gib(mem['output_bytes'])}, temp {lm_gib(mem['temp_bytes'])}))"
        f", card max_memory_allocated {lm_gib(card)}, ratio {ratio:.4f}; "
        f"{card_line()}")
    del model, state
    torch.cuda.empty_cache()
    # (a): plain, then on the mesh, from the same seed
    step = steps.make_train_step(cfg, opt)
    model = init_params(0, cfg, device=dev.type, master=True)
    state = init_opt_state(model)
    want, t_plain = timed(lambda: step(model, state, batch))
    del state
    torch.cuda.empty_cache()
    p_specs = param_specs(cfg, fsdp="data", model_axis_size=1)
    sharding_ctx.set_axes(batch="data", model="model")
    try:
        dmodel = steps.distribute_params(
            init_params(0, cfg, device=dev.type, master=True), mesh,
            p_specs)
        dstate = init_opt_state(dmodel)
        dbatch = steps.distribute_tree(batch, mesh, {
            k: ("data", None) for k in batch})
        got, t_mesh = timed(lambda: step(dmodel, dstate, dbatch))
    finally:
        sharding_ctx.clear_axes()
    check(all(abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k]))
              for k in want), f"(a) train metrics {got} against {want}")
    same = [bits_or_bound(f"master {n}", dmodel.get_parameter(n), p, 1e-5)
            for n, p in model.named_parameters()]
    log(f"phase 15 (a): {LM_ARCH} train step on the mesh (f32 masters in "
        f"the FSDP layout, bf16 compute): loss {got['loss']:.6f} / plain "
        f"{want['loss']:.6f}, grad_norm {got['grad_norm']:.6f} / "
        f"{want['grad_norm']:.6f}, metrics "
        f"{'equal' if got == want else 'within 1e-5'}, updated masters "
        f"{'bit-identical' if all(same) else 'within 1e-5'}; step wall "
        f"{t_plain:.3f} s plain / {t_mesh:.3f} s DTensor; {card_line()}")
    del model, dmodel, dstate
    torch.cuda.empty_cache()


def spec_bytes(tree, specs) -> int:
    """Bytes of one device's shard (the ceil-sized first) of every tensor
    of ``tree`` laid out by the matching ``specs`` (the production mesh's
    axis sizes); a Python int (the optimizer step, the position) counts
    as an int32 scalar."""
    import torch
    if isinstance(tree, dict):
        return sum(spec_bytes(tree[k], specs[k]) for k in tree)
    if isinstance(tree, list):
        return sum(spec_bytes(t, s) for t, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 4
    n = 1
    for i, dim in enumerate(tree.shape):
        entry = specs[i] if i < len(specs) else None
        ways = 1
        for a in (entry if isinstance(entry, tuple) else
                  () if entry is None else (entry,)):
            ways *= AXIS_SIZE[a]
        n *= -(-dim // ways)
    return n * tree.element_size()


def expected_argument_bytes(arch, shape, multi_pod) -> int:
    """A cell's argument bytes from the port's specs, no mesh: the meta
    builds of ``build_jitted`` laid out by ``param_specs``,
    ``opt_state_specs``, ``batch_specs`` and ``cache_specs``."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import input_specs
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import batch_axes, fsdp_axes
    from repro_torch.models import init_params
    from repro_torch.models.transformer import cache_specs, param_specs
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.adamw import opt_state_specs

    cfg = get_config(arch)
    sh = INPUT_SHAPES[shape]
    kind = sh["kind"]
    bax = batch_axes(multi_pod, sh["global_batch"])
    inputs = input_specs(cfg, shape)
    if kind == "train":
        model = init_params(0, cfg, "meta", master=True)
        p = param_specs(cfg, fsdp=fsdp_axes(multi_pod), model_axis_size=16)
        named = dict(model.named_parameters())
        return (spec_bytes(named, p)
                + spec_bytes(init_opt_state(model), opt_state_specs(p))
                + spec_bytes(inputs["batch"], steps.batch_specs(
                    cfg, shape, multi_pod, kind)))
    named = dict(steps._serve_dtype(init_params(0, cfg, "meta"),
                                    cfg).named_parameters())
    p = param_specs(cfg, fsdp=None, model_axis_size=16)
    if kind == "prefill":
        return spec_bytes(named, p) + spec_bytes(
            inputs["batch"], steps.batch_specs(cfg, shape, multi_pod, kind))
    seq_axis = "data" if bax is None else None
    return (spec_bytes(named, p)
            + spec_bytes(inputs["cache"], cache_specs(cfg, bax, seq_axis,
                                                      "seq"))
            + spec_bytes(inputs["token"], (bax,)) + 4)


FLOPS_BAND = (0.5, 2.0)


def shape_flops(arch, shape, multi_pod) -> float:
    """A cell's matmul FLOPs a device worked out from its shapes and
    specs alone: 2 x every weight a token multiplies (the vocab head once
    a sequence in prefill; an MoE expert's weighted by its capacity C of
    each group of gs tokens, plus the dispatch and combine products) x
    the tokens, over
    the batch's axes and, for a weight whose spec puts a dim on it, the
    model axis (a weight whole over it, sLSTM's or k/v's, is multiplied
    on every model rank); plus the score and value products over the
    context (4 x context x heads' width a token, for attention,
    cross-attention and mLSTM's parallel form, whole tiles as the port
    computes them) over every device; x 4 for a train step (forward,
    rematerialised forward, backward's two products)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.configs.base import decode_capacity
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import init_params
    from repro_torch.models.transformer import (ATTN_TYPES, decoder_types,
                                                param_specs)

    cfg, sh = get_config(arch), INPUT_SHAPES[shape]
    kind, b, s = sh["kind"], sh["global_batch"], sh["seq_len"]
    full = kind in ("train", "prefill")
    tokens = b * (s if full else 1)
    ctx = s if full else decode_capacity(cfg, shape)
    enc_len = s // cfg.src_ratio if cfg.n_enc_layers else 0
    enc_tokens = b * enc_len if full else 0
    bax = batch_axes(multi_pod, b)
    batch_ways = 1
    for a in (bax if isinstance(bax, tuple) else () if bax is None
              else (bax,)):
        batch_ways *= AXIS_SIZE[a]
    devices = AXIS_SIZE["data"] * AXIS_SIZE["model"] * (2 if multi_pod
                                                         else 1)
    specs = param_specs(cfg, fsdp=None, model_axis_size=AXIS_SIZE["model"])
    moe = cfg.moe
    if moe:
        gs = min(moe.group_size, tokens)
        slots = moe.n_experts * math.ceil(gs * moe.top_k
                                          * moe.capacity_factor
                                          / moe.n_experts)
    flops = 0.0
    for name, p in init_params(0, cfg, "meta").named_parameters():
        if p.ndim < 2 or name == "embed" or name.endswith("conv_w"):
            continue
        n = 2.0 * p.numel()
        if moe and ".moe." in name and ".shared." not in name \
                and not name.endswith("router"):
            n *= slots / gs / moe.n_experts    # each expert's C of gs
        ways = batch_ways * (AXIS_SIZE["model"] if "model" in specs[name]
                             else 1)
        rows = enc_tokens if name.startswith("encoder.") else \
            b if name == "head" and kind == "prefill" else tokens
        flops += n * rows / ways
    width = cfg.n_heads * cfg.head_dim
    per_tok = 0.0
    for lt in decoder_types(cfg):
        if lt in ATTN_TYPES:
            per_tok += 4 * ctx * width
            if moe:
                per_tok += 4 * slots * cfg.d_model   # dispatch, combine
        if lt == "xattn":
            per_tok += 4 * enc_len * width
        if lt == "mlstm":
            per_tok += 4 * ctx * cfg.xlstm.up_factor * cfg.d_model
    flops += (tokens * per_tok + enc_tokens * cfg.n_enc_layers * 4
              * enc_len * width) / devices
    return flops * (4 if kind == "train" else 1)


def dry_run_cells(workdir, device):
    """(b) ``python -m repro_torch.launch.dryrun`` on DRY_GROUPS, one
    process a group, all started together: every process exits 0, every
    cell's argument bytes are the specs' sum and its FLOPs within
    FLOPS_BAND of :func:`shape_flops`."""
    import os
    from repro_torch.configs import INPUT_SHAPES
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for arch, shapes, mesh in DRY_GROUPS:
        for shape in shapes or (None,):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--mesh", mesh, "--out", str(workdir),
                   "--device", device]
            if shape:
                cmd += ["--shape", shape]
            procs.append((cmd, subprocess.Popen(
                cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    t0 = time.perf_counter()
    outs = []
    try:
        for cmd, p in procs:
            left = max(1.0, DRY_TIMEOUT - (time.perf_counter() - t0))
            out, err = p.communicate(timeout=left)
            outs.append((cmd, p.returncode, out, err))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, rc, out, err in outs:
        for line in out.splitlines():
            if line.startswith("[ok]") or line.startswith("[FAIL]"):
                log(f"phase 15 (b): {line}")
        check(rc == 0, f"(b) {' '.join(cmd[2:])} exited {rc}: "
              f"{err.strip()[-2000:]}")
    cells = sorted(workdir.glob("*.json"))
    want = sum(len(shapes or INPUT_SHAPES) * (2 if mesh == "both" else 1)
               for _, shapes, mesh in DRY_GROUPS)
    check(len(cells) == want, f"(b) {len(cells)} cell files, not {want}")
    for path in cells:
        r = json.loads(path.read_text())
        exp = expected_argument_bytes(r["arch"], r["shape"],
                                      r["mesh"] == "multipod")
        check(r["memory"]["argument_bytes"] == exp, f"(b) {path.name}: "
              f"argument bytes {r['memory']['argument_bytes']}, the specs "
              f"give {exp}")
        est = shape_flops(r["arch"], r["shape"], r["mesh"] == "multipod")
        ratio = r["cost"]["flops"] / est
        check(FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], f"(b) {path.name}: "
              f"flops {r['cost']['flops']:.4e}, {ratio:.3f}x the "
              f"{est:.4e} its shapes give (band {FLOPS_BAND})")
        coll = {k: v["bytes"] for k, v in r["collectives"].items()
                if v["count"]}
        log(f"phase 15 (b): {path.stem}: flops {r['cost']['flops']:.6e} "
            f"({ratio:.4f}x the shapes' {est:.6e}), "
            f"collective bytes {coll}, peak {r['memory']['peak_bytes']:,} B,"
            f" argument bytes {exp:,} (the specs' sum), build "
            f"{r['lower_s']} s, walk {r['compile_s']} s")


def phase_sharding_dryrun(dev, report):
    """Phase 15: (a) internlm2-1.8b at full width and depth on a (data=1,
    model=1) NCCL mesh as ``DTensor``s, against the plain path: prefill
    of the CLI batch and DECODE_STEPS decode steps, one train step; (b)
    the dry-run CLI on DRY_GROUPS' cells over a fake group of 256 or 512
    ranks, in subprocesses; (c) the dry-run's memory model against the
    card on phase 13's train step."""
    import tempfile
    from pathlib import Path as _Path
    import torch.distributed as dist
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    reset_counts()
    cfg = get_config(LM_ARCH, "full")
    with tempfile.TemporaryDirectory() as tmp:
        mesh = host_mesh_2d(dev, _Path(tmp))
        try:
            for part in (mesh_serving, mesh_training):
                t0 = time.perf_counter()
                part(dev, mesh, cfg)
                log(f"phase 15: {part.__name__} took "
                    f"{time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        dry_run_cells(_Path(tmp) / "dryrun", dev.type)
        log(f"phase 15 (b): took {time.perf_counter() - t0:.1f} s")
    launches = kernel_counts()
    log(f"phase 15: kernel launches {launches} (the substrate runs none of "
        f"the five); took {time.perf_counter() - t_phase:.1f} s")


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
    log(card_line())
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
              ("serving", phase_serving),
              ("out of core", phase_out_of_core),
              ("uplink transforms and async rounds", phase_uplink_async),
              ("mesh runtime, continual and split-merge",
               phase_mesh_extensions),
              ("transformer serving", phase_transformer_serving),
              ("transformer training and MoE", phase_training_moe),
              ("recurrent, xLSTM and encoder-decoder families",
               phase_recurrent_encdec),
              ("sharding context, mesh and dry-run", phase_sharding_dryrun)]
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
