"""Expectation-Maximization for GMMs (port of ``repro/core/em.py``), plus
the streaming-statistics engine and BIC model selection.

The engine runs on *stacked* problems: rows ``x (B, N, d)`` with weights
``w (B, N)`` and one model per member, every leaf with a leading axis B.
That axis is what ``jax.vmap`` gave the JAX package: the local fits of all
clients are one batch (one E-step launch per iteration), and a single fit is
a batch of one. The public functions take either form; a 2-D ``x`` is
lifted to a batch of one and the result is lowered again.

Sample weights make padded client datasets fixed-shape (weight 0 =
padding), and let the engine pad row counts to chunk boundaries for free:
zero-weight rows add exact zeros to every statistic. ``chunk_size`` streams
any reduction in fixed-size row chunks, in chunk order, with an
O(chunk·K) working set.

Every engine entry point also takes a :class:`DataSource` in the rows
position: a host loop over its blocks (``prefetch_blocks``, each block
padded to one row count with a 0/1 mask and delivered on the engine's
device) runs the same per-block statistics as a batch of one, summed in
block order, so N never has to be resident and source-backed fits are
bit-identical across source types holding the same rows. The device of a
source reduction is the model's (``gmm.device``), or the config's.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.config import (FitConfig, derive_seed,
                                     require_array_weights, resolve_backend,
                                     resolve_estep_backend,
                                     resolve_source_chunk)
from repro_torch.core.gmm import GMM
from repro_torch.data.sources import DataSource, prefetch_blocks


class EMResult(NamedTuple):
    gmm: GMM
    log_likelihood: torch.Tensor  # final average log-likelihood
    n_iter: torch.Tensor
    converged: torch.Tensor


class SufficientStats(NamedTuple):
    """Weighted sufficient statistics of one E-step (leading batch axes
    allowed on every field).

    s0 : (K,)     sum_n w_n r_nk
    s1 : (K, d)   sum_n w_n r_nk x_n
    s2 : (K, d) or (K, d, d)   sum_n w_n r_nk x_n x_n(^T)
    loglik : ()   weighted total log-likelihood
    wsum : ()     total sample weight
    """
    s0: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor
    loglik: torch.Tensor
    wsum: torch.Tensor


# ----------------------------------------------------------------------
# Batch lifting
# ----------------------------------------------------------------------

def _lift(gmm: GMM) -> GMM:
    return GMM(gmm.weights[None], gmm.means[None], gmm.covs[None])


def _first(tup):
    """Member 0 of every field of a stats tuple."""
    vals = [t[0] for t in tup]
    return type(tup)(*vals) if hasattr(tup, "_fields") else tuple(vals)


def _weights(x: torch.Tensor, sample_weight) -> torch.Tensor:
    """Row weights aligned with ``x``: ones, or ``sample_weight`` on x's
    device and dtype."""
    if sample_weight is None:
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    return torch.as_tensor(sample_weight, dtype=x.dtype, device=x.device)


def _select(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Per-member ``where``: ``mask`` (B,) picks ``new`` over ``old``."""
    return torch.where(mask.view((-1,) + (1,) * (new.ndim - 1)), new, old)


# ----------------------------------------------------------------------
# Streaming-statistics engine
# ----------------------------------------------------------------------

def _tree_children(tree):
    """(children, rebuild) of one payload node, or (None, None) for a leaf.
    Nodes are dicts (children in sorted key order, as ``jax.tree`` orders
    them), GMMs, (named) tuples and lists; leaves are tensors and Python
    numbers."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [tree[k] for k in keys], lambda vals: dict(zip(keys, vals))
    if isinstance(tree, GMM):
        return [tree.weights, tree.means, tree.covs], lambda v: GMM(*v)
    if isinstance(tree, (tuple, list)):
        if hasattr(tree, "_fields"):
            return list(tree), lambda vals: type(tree)(*vals)
        return list(tree), type(tree)
    return None, None


def _tree_leaves(tree) -> list:
    """Every leaf of a payload, in :func:`_tree_map`'s order."""
    kids, _ = _tree_children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in _tree_leaves(kid)]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more payloads of one structure."""
    kids, rebuild = _tree_children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_tree_children(r)[0] for r in rest]
    return rebuild([_tree_map(fn, kid, *(o[i] for o in others))
                    for i, kid in enumerate(kids)])


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """The int32 two's-complement value of an integer tensor modulo 2^32,
    by construction (int64 arithmetic and a mask), so int32 sums wrap the
    same on every device without relying on signed overflow."""
    return (((v.to(torch.int64) + 2**31) & 0xFFFFFFFF) - 2**31).to(
        torch.int32)


def _leaf_add(u, v):
    if isinstance(u, torch.Tensor) and u.dtype == torch.int32:
        return wrap_int32(u.to(torch.int64) + v.to(torch.int64))
    return u + v


def _tree_add(a, b):
    """``a + b`` over every leaf of two payloads of one structure; int32
    leaves add modulo 2^32 (secure-aggregation channels)."""
    return _tree_map(_leaf_add, a, b)


def _source_map_reduce(block_fn: Callable, source: DataSource,
                       chunk_size: int, device):
    """The host block loop of a :class:`DataSource`: ``block_fn(xb, wb) ->
    (stats, per_row)`` on every ``(block, mask)`` pair of
    :func:`prefetch_blocks` on ``device``. ``stats`` accumulate in block
    order, in at least float32, and are cast back to ``block_fn``'s
    dtypes; ``per_row`` outputs are concatenated and cut back to the
    source's rows (padding only trails the last block)."""
    acc = dtypes = None
    parts: list = []
    for xb, wb in prefetch_blocks(source, chunk_size, device=device):
        stats, rows = block_fn(xb, wb)
        if acc is None:
            dtypes = [t.dtype for t in stats]
            acc = [t.to(torch.promote_types(t.dtype, torch.float32))
                   for t in stats]
        else:
            acc = [a + t.to(a.dtype) for a, t in zip(acc, stats)]
        parts.append(rows)
    if acc is None:
        raise ValueError(f"source yielded no blocks: {source!r}")
    vals = [a.to(dt) for a, dt in zip(acc, dtypes)]
    stats = type(stats)(*vals) if hasattr(stats, "_fields") else tuple(vals)
    rows = tuple(torch.cat(p, dim=0)[:source.num_rows] for p in zip(*parts))
    return stats, rows


def streaming_map_reduce(block_fn: Callable, arrays, chunk_size: int,
                         device="cuda"):
    """Run ``block_fn`` over fixed-size row chunks of ``arrays`` (rows on
    axis 1 of every array).

    ``block_fn(*chunk_arrays) -> (stats, per_row)``: ``stats`` is an
    additive tuple (summed over chunks in chunk order, pass ``()`` for
    map-only) and ``per_row`` a tuple of (B, chunk, ...) outputs
    (concatenated and cut back to N rows, pass ``()`` for reduce-only).
    The last chunk is zero-padded; padded rows carry weight 0.

    ``arrays`` may instead be one :class:`DataSource`: ``block_fn`` then
    gets ``(block (R, d), mask (R,))`` on ``device`` and returns per-row
    outputs of (R, ...) (:func:`_source_map_reduce`).
    """
    if isinstance(arrays, DataSource):
        return _source_map_reduce(block_fn, arrays, int(chunk_size), device)
    chunk_size = int(chunk_size)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    n = arrays[0].shape[1]
    n_chunks = -(-n // chunk_size)
    pad = n_chunks * chunk_size - n
    if pad:
        arrays = [torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                            dim=1) for a in arrays]
    acc, parts = None, []
    for i in range(n_chunks):
        sl = slice(i * chunk_size, (i + 1) * chunk_size)
        stats, rows = block_fn(*(a[:, sl] for a in arrays))
        acc = stats if acc is None else _tree_add(acc, stats)
        parts.append(rows)
    rows = tuple(torch.cat(p, dim=1)[:, :n] for p in zip(*parts))
    return acc, rows


def streaming_reduce(block_fn: Callable, arrays, chunk_size: int,
                     device="cuda"):
    """Reduce-only :func:`streaming_map_reduce`."""
    stats, _ = streaming_map_reduce(lambda *a: (block_fn(*a), ()), arrays,
                                    chunk_size, device)
    return stats


def reduce_rows(block_fn: Callable, arrays,
                chunk_size: Optional[int] = None, device="cuda"):
    """THE chunk dispatch: ``None`` runs one full-batch call, an integer
    streams fixed-size chunks through :func:`streaming_reduce`. A
    :class:`DataSource` always streams, ``None`` meaning
    :data:`DEFAULT_SOURCE_CHUNK` rows a block, on ``device``."""
    if isinstance(arrays, DataSource):
        return streaming_reduce(block_fn, arrays,
                                resolve_source_chunk(chunk_size), device)
    if chunk_size is None:
        return block_fn(*arrays)
    return streaming_reduce(block_fn, arrays, chunk_size)


# ----------------------------------------------------------------------
# E / M steps
# ----------------------------------------------------------------------

def _e_step_stats_reference(gmm: GMM, x: torch.Tensor,
                            w: torch.Tensor) -> SufficientStats:
    """Eager E-step: materializes the (.., N, K) responsibility matrix."""
    lp = gmm.component_log_prob(x) + torch.log(gmm.weights).unsqueeze(-2)
    log_norm = torch.logsumexp(lp, dim=-1)
    resp = torch.exp(lp - log_norm.unsqueeze(-1)) * w.unsqueeze(-1)
    rt = resp.transpose(-1, -2)
    if gmm.is_diagonal:
        s2 = rt @ (x * x)
    else:
        s2 = torch.einsum("...nk,...ni,...nj->...kij", resp, x, x)
    return SufficientStats(resp.sum(dim=-2), rt @ x, s2,
                           torch.sum(log_norm * w, dim=-1), w.sum(dim=-1))


def e_step_stats_fused(gmm: GMM, x: torch.Tensor,
                       sample_weight: Optional[torch.Tensor] = None
                       ) -> SufficientStats:
    """Kernel-backed E-step (diagonal covariance only): the CUDA
    ``estep_stats`` kernel fuses log-pdf, softmax and the reductions, so the
    (N, K) responsibility matrix never reaches device memory. Takes one
    model with x (N, d) or a batch with x (B, N, d)."""
    from repro_torch.kernels import ops
    if not gmm.is_diagonal:
        raise ValueError("the fused E-step kernel supports diagonal "
                         "covariance only")
    w = _weights(x, sample_weight)
    s0, s1, s2, ll = ops.estep_stats(x, gmm.means, gmm.covs,
                                     torch.log(gmm.weights), w)
    return SufficientStats(s0, s1, s2, ll, w.sum(dim=-1))


def _e_step_batched(gmm: GMM, x: torch.Tensor, w: torch.Tensor,
                    backend: str, chunk_size: Optional[int]
                    ) -> SufficientStats:
    if backend == "fused":
        block = lambda xb, wb: e_step_stats_fused(gmm, xb, wb)
    else:
        block = lambda xb, wb: _e_step_stats_reference(gmm, xb, wb)
    return reduce_rows(block, (x, w), chunk_size)


def e_step_stats(gmm: GMM, x: torch.Tensor,
                 sample_weight: Optional[torch.Tensor] = None,
                 estep_backend: str = "auto",
                 chunk_size: Optional[int] = None) -> SufficientStats:
    """One E-step: responsibilities -> sufficient statistics.

    ``estep_backend`` picks the eager reference or the fused kernel;
    ``chunk_size`` streams either through the engine in O(chunk·K) memory.
    ``x`` is (N, d) with one model, or (B, N, d) with a stacked model.
    """
    if isinstance(x, DataSource):
        require_array_weights(sample_weight, "e_step_stats over a DataSource")
        backend = resolve_estep_backend(estep_backend, gmm.is_diagonal,
                                        gmm.device)
        return reduce_rows(
            lambda xb, wb: _estep_block(gmm, xb, wb, backend), x,
            chunk_size, gmm.device)
    backend = resolve_estep_backend(estep_backend, gmm.is_diagonal, x.device)
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        return _first(_e_step_batched(_lift(gmm), x[None], w[None], backend,
                                      chunk_size))
    return _e_step_batched(gmm, x, w, backend, chunk_size)


def e_step_stats_chunked(gmm: GMM, x: torch.Tensor,
                         sample_weight: Optional[torch.Tensor] = None,
                         chunk_size: int = 4096,
                         estep_backend: str = "auto") -> SufficientStats:
    """Constant-memory E-step over fixed-size row chunks (the reference's
    spelling of ``e_step_stats(..., chunk_size=)``).

    ``SufficientStats`` is additive in N, so the full-batch statistics are
    the chunk-wise sum: the working set is one (chunk_size, K) block
    instead of the whole (N, K) responsibility matrix. The fused backend
    computes each chunk in float32 whatever ``x``'s dtype."""
    return e_step_stats(gmm, x, sample_weight, estep_backend,
                        chunk_size=int(chunk_size))


def _estep_block(gmm: GMM, xb: torch.Tensor, wb: torch.Tensor,
                 backend: str) -> SufficientStats:
    """The E-step of one source block with its 0/1 pad mask, run as a
    batch of one through the resident chunk path (on the fused backend one
    ``estep_stats`` launch a block), so a source and an array at the same
    chunk take the same operations."""
    return _first(_e_step_batched(_lift(gmm), xb[None], wb[None], backend,
                                  None))


def m_step(stats: SufficientStats, reg_covar: float = 1e-6) -> GMM:
    """M-step from (possibly aggregated, possibly stacked) statistics."""
    s0 = torch.clamp(stats.s0, min=1e-10)
    weights = stats.s0 / torch.clamp(stats.wsum, min=1e-12).unsqueeze(-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    means = stats.s1 / s0.unsqueeze(-1)
    if stats.s2.ndim == stats.s1.ndim:  # diagonal
        covs = stats.s2 / s0.unsqueeze(-1) - means * means
        covs = torch.clamp(covs, min=0.0) + reg_covar
    else:
        outer = torch.einsum("...ki,...kj->...kij", means, means)
        covs = stats.s2 / s0[..., None, None] - outer
        # robustness against component collapse: symmetrize, sanitize
        # non-finite entries, floor the diagonal
        covs = 0.5 * (covs + covs.transpose(-1, -2))
        covs = torch.where(torch.isfinite(covs), covs, 0.0)
        d = means.shape[-1]
        eye = torch.eye(d, dtype=means.dtype, device=means.device)
        covs = covs + reg_covar * eye
        diag = torch.clamp(torch.diagonal(covs, dim1=-2, dim2=-1),
                           min=reg_covar)
        covs = covs * (1.0 - eye) + diag.unsqueeze(-1) * eye
    means = torch.where(torch.isfinite(means), means, 0.0)
    return GMM(weights, means, covs)


def em_step(gmm: GMM, x: torch.Tensor,
            sample_weight: Optional[torch.Tensor] = None,
            reg_covar: float = 1e-6, estep_backend: str = "auto",
            chunk_size: Optional[int] = None) -> tuple[GMM, torch.Tensor]:
    """One full EM iteration. Returns (new_gmm, avg_loglik_of_old_gmm)."""
    stats = e_step_stats(gmm, x, sample_weight, estep_backend, chunk_size)
    avg_ll = stats.loglik / torch.clamp(stats.wsum, min=1e-12)
    return m_step(stats, reg_covar), avg_ll


# ----------------------------------------------------------------------
# Streaming scoring: log-likelihood and BIC without the (N, K) matrix
# ----------------------------------------------------------------------

def _log_prob_block(gmm: GMM, xb: torch.Tensor, backend: str) -> torch.Tensor:
    """Mixture log density of one row block, (R, d) -> (R,). The fused
    backend runs the CUDA ``gmm_log_prob`` kernel (diagonal only), which
    sums each row's logsumexp in the kernel, so the (R, K) per-component
    block is never written; reference uses ``GMM.log_prob``."""
    if backend == "fused":
        from repro_torch.kernels import ops
        return ops.gmm_log_prob(xb, gmm.means, gmm.covs,
                                torch.log(gmm.weights)).to(xb.dtype)
    return gmm.log_prob(xb)


def log_prob_chunked(gmm: GMM, x: torch.Tensor,
                     chunk_size: Optional[int] = 4096,
                     backend: str = "auto") -> torch.Tensor:
    """``GMM.log_prob`` in fixed-size row chunks -> (N,). ``None`` runs one
    full-batch block with the same backend resolution. ``x`` may be a
    :class:`DataSource` (the (N,) output is O(N), 4 bytes a row; the
    (N, K) block never exists)."""
    if isinstance(x, DataSource):
        backend = resolve_backend(backend, gmm.device, gmm.is_diagonal)
        _, (lp,) = streaming_map_reduce(
            lambda xb, wb: ((), (_log_prob_block(gmm, xb, backend),)), x,
            resolve_source_chunk(chunk_size), gmm.device)
        return lp
    backend = resolve_backend(backend, x.device, gmm.is_diagonal)
    if chunk_size is None:
        return _log_prob_block(gmm, x, backend)
    _, (lp,) = streaming_map_reduce(
        lambda xb: ((), (_log_prob_block(gmm, xb[0], backend)[None],)),
        (x[None],), chunk_size)
    return lp[0]


def _score_sums(gmm: GMM, x: torch.Tensor,
                sample_weight: Optional[torch.Tensor],
                chunk_size: Optional[int], backend: str):
    """(sum_n w_n log p(x_n), sum_n w_n) through the engine."""
    if isinstance(x, DataSource):
        require_array_weights(sample_weight, "scoring over a DataSource")
        backend = resolve_backend(backend, gmm.device, gmm.is_diagonal)

        def source_block(xb, wb):
            lp = _log_prob_block(gmm, xb, backend)
            return torch.sum(lp * wb), wb.sum()

        return reduce_rows(source_block, x, chunk_size, gmm.device)
    backend = resolve_backend(backend, x.device, gmm.is_diagonal)
    w = _weights(x, sample_weight)

    def block(xb, wb):
        lp = _log_prob_block(gmm, xb[0], backend)
        return torch.sum(lp * wb[0])[None], wb.sum(dim=-1)

    total, wsum = reduce_rows(block, (x[None], w[None]), chunk_size)
    return total[0], wsum[0]


def score_streaming(gmm: GMM, x: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None,
                    chunk_size: Optional[int] = 4096,
                    backend: str = "auto") -> torch.Tensor:
    """Average log-likelihood (the paper's fitness score, Eq. 2) in
    O(chunk·K) memory. Equals ``GMM.score`` up to summation order."""
    total, wsum = _score_sums(gmm, x, sample_weight, chunk_size, backend)
    return total / torch.clamp(wsum, min=1e-12)


def bic_streaming(gmm: GMM, x: torch.Tensor,
                  sample_weight: Optional[torch.Tensor] = None,
                  chunk_size: Optional[int] = 4096,
                  backend: str = "auto") -> torch.Tensor:
    """Bayesian Information Criterion in O(chunk·K) memory (lower is
    better). Equals ``GMM.bic`` up to summation order."""
    total, wsum = _score_sums(gmm, x, sample_weight, chunk_size, backend)
    return gmm.n_free_params() * torch.log(wsum) - 2.0 * total


# ----------------------------------------------------------------------
# Initialization
# ----------------------------------------------------------------------

def label_stats(x: torch.Tensor, assignments: torch.Tensor, k: int,
                sample_weight: Optional[torch.Tensor] = None,
                covariance_type: str = "diag",
                chunk_size: Optional[int] = None) -> SufficientStats:
    """Hard-assignment sufficient statistics via weighted one-hot matmuls
    (``oh.T @ xb``), ``chunk_size`` bounding the working set to one
    (chunk, K) block. x (N, d) or (B, N, d), assignments aligned with it."""
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        return _first(label_stats(x[None], assignments[None], k, w[None],
                                  covariance_type, chunk_size))
    cols = torch.arange(k, device=x.device)

    def block(xb, wb, ab):
        oh = (ab.unsqueeze(-1) == cols).to(xb.dtype) * wb.unsqueeze(-1)
        ot = oh.transpose(-1, -2)
        if covariance_type == "diag":
            s2 = ot @ (xb * xb)
        else:
            s2 = torch.einsum("...nk,...ni,...nj->...kij", oh, xb, xb)
        return SufficientStats(oh.sum(dim=-2), ot @ xb, s2,
                               xb.new_zeros(xb.shape[0]), wb.sum(dim=-1))

    return reduce_rows(block, (x, w, assignments), chunk_size)


def init_from_kmeans(seed: int, x: torch.Tensor, k: int,
                     sample_weight: Optional[torch.Tensor] = None,
                     covariance_type: str = "diag",
                     reg_covar: float = 1e-6,
                     chunk_size: Optional[int] = None,
                     assign_backend: str = "auto", device="cuda") -> GMM:
    """sklearn-style init: k-means labels -> label stats -> M-step. A batch
    x (B, N, d) gives a stacked model, member b seeded from
    ``derive_seed(seed, b)``. A :class:`DataSource` runs out of core on
    ``device``: streamed k-means++ seeding, host-loop Lloyd sweeps, and the
    label statistics summed in a last assignment pass
    (``kmeans_label_block``), so no (N,) label vector exists."""
    from repro_torch.core.kmeans import (kmeans_label_block, kmeans_multi,
                                         kmeans_multi_source)
    if isinstance(x, DataSource):
        require_array_weights(sample_weight,
                              "init_from_kmeans over a DataSource")
        cs = resolve_source_chunk(chunk_size)
        res = kmeans_multi_source(seed, x, k, max_iter=50, chunk_size=cs,
                                  assign_backend=assign_backend,
                                  device=device)
        backend = resolve_backend(assign_backend, res.centers.device)
        stats = streaming_reduce(
            lambda xb, wb: kmeans_label_block(res.centers, xb, wb,
                                              covariance_type, backend),
            x, cs, res.centers.device)
        return m_step(stats, reg_covar)
    w = _weights(x, sample_weight)
    res = kmeans_multi(seed, x, k, sample_weight=w, max_iter=50,
                       chunk_size=chunk_size, assign_backend=assign_backend)
    stats = label_stats(x, res.assignments, k, w, covariance_type,
                        chunk_size)
    return m_step(stats, reg_covar)


def _moments_block(xb: torch.Tensor, wb: torch.Tensor):
    """(sum w x, sum w x², sum w) of one block: streamed data moments
    (``wb`` is the pad mask, so padded rows count for nothing)."""
    wc = wb.unsqueeze(-1)
    return (torch.sum(xb * wc, dim=0), torch.sum(xb * xb * wc, dim=0),
            torch.sum(wb))


def init_from_means(means: torch.Tensor, x: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None,
                    covariance_type: str = "diag",
                    reg_covar: float = 1e-6,
                    chunk_size: Optional[int] = None,
                    sharded=None) -> GMM:
    """Init with given centers, uniform weights and the data's variance as
    every component's covariance: the DEM baselines' init, where the server
    proposes centers without seeing client data. x (N, d) with the
    weighted two-pass variance (zero-weight rows count for nothing), or a
    :class:`DataSource` with one-pass streamed moments on the centers'
    device (E[x²] - E[x]², clamped at zero; ``chunk_size`` applies to
    sources only). ``sharded`` (a
    :class:`repro_torch.fed.runtime.ShardedClients`) makes x its rank's
    rows: each pass's sums are then all-reduced over the ranks (two
    collectives)."""
    k, d = means.shape
    if isinstance(x, DataSource):
        require_array_weights(sample_weight,
                              "init_from_means over a DataSource")
        s, ss, cnt = reduce_rows(_moments_block, x, chunk_size, means.device)
        wsum = torch.clamp(cnt, min=1e-12)
        mean = s / wsum
        var = torch.clamp(ss / wsum - mean * mean, min=0.0) + reg_covar
        dtype = means.dtype
    else:
        def total(t):
            return t if sharded is None else sharded.all_reduce(t)

        w = _weights(x, sample_weight)
        s, cnt = total((torch.sum(x * w.unsqueeze(-1), dim=0), w.sum()))
        wsum = torch.clamp(cnt, min=1e-12)
        mean = s / wsum
        var = (total(torch.sum((x - mean) ** 2 * w.unsqueeze(-1), dim=0))
               / wsum + reg_covar)
        dtype, means = x.dtype, means.to(x)
    weights = torch.full((k,), 1.0 / k, dtype=dtype, device=means.device)
    if covariance_type == "diag":
        covs = var.expand(k, d).contiguous()
    else:
        covs = torch.diag(var).expand(k, d, d).contiguous()
    return GMM(weights, means, covs.to(dtype))


# ----------------------------------------------------------------------
# Full EM fit
# ----------------------------------------------------------------------

def _em_loop(gmm0: GMM, x: torch.Tensor, w: torch.Tensor, tol: float,
             reg_covar: float, max_iter: int, backend: str,
             chunk_size: Optional[int]):
    """The convergence loop of ``jax.vmap(_em_loop)``, on stacked members.

    One bootstrap step, then steps while any member is active. A member is
    active while ``it < max_iter`` and its |Δ avg-loglik| > ``tol``; once
    it stops, its state is frozen, exactly as the vmapped ``while_loop``
    freezes it. Reading ``active.any()`` syncs the device once per
    iteration.
    """
    def step(gmm):
        return em_step(gmm, x, w, reg_covar, backend, chunk_size)

    gmm, ll = step(gmm0)
    prev_ll = torch.full_like(ll, float("-inf"))
    it = torch.ones(ll.shape, dtype=torch.int64, device=ll.device)
    active = (it < max_iter) & (torch.abs(ll - prev_ll) > tol)
    while bool(active.any()):
        new_gmm, avg_ll = step(gmm)
        gmm = GMM(*(_select(active, n, o) for n, o in
                    zip((new_gmm.weights, new_gmm.means, new_gmm.covs),
                        (gmm.weights, gmm.means, gmm.covs))))
        prev_ll = torch.where(active, ll, prev_ll)
        ll = torch.where(active, avg_ll, ll)
        it = it + active.to(it.dtype)
        active = (it < max_iter) & (torch.abs(ll - prev_ll) > tol)
    converged = torch.abs(ll - prev_ll) <= tol
    return gmm, ll, it, converged


def host_em_loop(step: Callable, gmm0: GMM, tol: float, max_iter: int):
    """The host EM convergence loop of the out-of-core trainers: a
    bootstrap ``step(gmm) -> (new_gmm, avg_ll float)``, then steps while
    ``it < max_iter`` and the avg-loglik change exceeds ``tol``; the same
    state transitions as :func:`_em_loop`. Returns ``(gmm, avg_ll,
    n_iter, converged)``, tensors on the model's device."""
    tol = float(tol)
    gmm, ll = step(gmm0)
    prev_ll, it = float("-inf"), 1
    while it < max_iter and abs(ll - prev_ll) > tol:
        new_gmm, avg_ll = step(gmm)
        gmm, prev_ll, ll, it = new_gmm, ll, avg_ll, it + 1
    converged = abs(ll - prev_ll) <= tol
    dev = gmm.device
    return (gmm, torch.tensor(ll, dtype=gmm.means.dtype, device=dev),
            torch.tensor(it, device=dev), torch.tensor(converged, device=dev))


def _em_loop_source(gmm0: GMM, source: DataSource, tol: float,
                    reg_covar: float, max_iter: int, estep_backend: str,
                    chunk_size: int):
    """Out-of-core twin of :func:`_em_loop` on the model's device: every
    iteration one pass over the source's blocks (one ``estep_stats`` launch
    a block on the fused backend) and one read of the avg loglik."""
    backend = resolve_estep_backend(estep_backend, gmm0.is_diagonal,
                                    gmm0.device)

    def step(gmm):
        stats = streaming_reduce(
            lambda xb, wb: _estep_block(gmm, xb, wb, backend), source,
            chunk_size, gmm.device)
        avg_ll = float(stats.loglik / torch.clamp(stats.wsum, min=1e-12))
        return m_step(stats, reg_covar), avg_ll

    return host_em_loop(step, gmm0, tol, max_iter)


def fit_gmm_cfg(seed, x, k: int, config: FitConfig,
                sample_weight=None, init_gmm: Optional[GMM] = None
                ) -> EMResult:
    """Train a GMM with EM until the avg-loglik delta drops below the
    config's ``tol`` (the paper's convergence criterion, 1e-3).

    ``x`` is (N, d), or a batch (B, N, d) of independent fits (the local
    fits of a padded client split, ``sample_weight`` (B, N) masking the
    padding); the result is then stacked. ``seed`` is an int, or for a
    batch one seed per member: member b then fits as a lone fit seeded
    with ``seed[b]`` would. ``init_gmm`` skips the k-means
    init. ``config.backend`` selects the E-step and the k-means assignment
    implementation; an integer ``config.chunk_size`` streams the init and
    every E-step.

    ``x`` may be a :class:`DataSource`: init, every E-step and the
    convergence test then run as host block loops on the config's device
    with an O(chunk·K) working set ("auto" streams
    :data:`DEFAULT_SOURCE_CHUNK`-row blocks).
    """
    device = config.resolve_device()
    backend = resolve_estep_backend(
        config.backend,
        config.is_diagonal if init_gmm is None else init_gmm.is_diagonal,
        device)
    if isinstance(x, DataSource):
        require_array_weights(sample_weight, "fit_gmm over a DataSource")
        cs = config.resolve_chunk(source=True)
        if init_gmm is None:
            init_gmm = init_from_kmeans(
                seed, x, k, covariance_type=config.covariance_type,
                reg_covar=config.reg_covar, chunk_size=cs,
                assign_backend=config.backend, device=device)
        gmm, ll, it, converged = _em_loop_source(
            init_gmm.to(device), x, config.resolve_tol("em"),
            config.reg_covar, config.resolve_max_iter("em"), backend, cs)
        return EMResult(gmm, ll, it, converged)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    w = _weights(x, sample_weight)
    single = x.ndim == 2
    if single:
        x, w = x[None], w[None]
    cs = config.resolve_chunk(source=False)
    if init_gmm is None:
        init_gmm = init_from_kmeans(seed, x, k, w, config.covariance_type,
                                    config.reg_covar, chunk_size=cs,
                                    assign_backend=config.backend)
    else:
        init_gmm = init_gmm.to(device)
        if single:
            init_gmm = _lift(init_gmm)
    gmm, ll, it, converged = _em_loop(
        init_gmm, x, w, config.resolve_tol("em"), config.reg_covar,
        config.resolve_max_iter("em"), backend, cs)
    if single:
        return EMResult(gmm[0], ll[0], it[0], converged[0])
    return EMResult(gmm, ll, it, converged)


def fit_gmm(seed, x, k: int, sample_weight=None,
            covariance_type: str = "diag", max_iter: int = 200,
            tol: float = 1e-3, reg_covar: float = 1e-6,
            init_gmm: Optional[GMM] = None, estep_backend: str = "auto",
            chunk_size: Optional[int] = None, device="cuda") -> EMResult:
    """Legacy keyword surface of :func:`fit_gmm_cfg` (prefer
    ``repro_torch.api.GMMEstimator``): the loose knobs folded into one
    :class:`FitConfig` by :meth:`FitConfig.from_legacy`."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return fit_gmm_cfg(seed, x, k, cfg, sample_weight, init_gmm)


def fit_gmm_streaming(seed: int, x, k: int, sample_weight=None,
                      covariance_type: str = "diag", max_iter: int = 200,
                      tol: float = 1e-3, reg_covar: float = 1e-6,
                      init_gmm: Optional[GMM] = None,
                      estep_backend: str = "auto", chunk_size: int = 4096,
                      device="cuda") -> EMResult:
    """Deprecated: ``repro_torch.api.GMMEstimator`` with an integer
    ``FitConfig.chunk_size`` is the same all-streaming fit. This shim
    forwards to the facade (the facade's bits) and will be removed."""
    warnings.warn(
        "fit_gmm_streaming is deprecated; use repro_torch.api.GMMEstimator("
        "k, chunk_size=<int>).fit(x) — same engine, same bits",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import GMMEstimator  # the facade sits above core
    est = GMMEstimator(k, config=FitConfig.from_legacy(
        backend=estep_backend, chunk_size=int(chunk_size),
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device))
    est.fit(x, sample_weight=sample_weight, init_gmm=init_gmm, seed=seed)
    return est.result_


def fit_gmm_bic_cfg(seed: int, x, k_candidates: Sequence[int],
                    config: FitConfig, sample_weight=None
                    ) -> tuple[EMResult, dict[int, float]]:
    """TrainGMM of Algorithm 4.1: fit every K in ``k_candidates`` (candidate
    i seeded with ``derive_seed(seed, i)``), score each fit with
    :func:`bic_streaming` (one ``gmm_log_prob`` launch a chunk on the fused
    backend), and return the first fit of least BIC with every candidate's
    BIC. x (N, d), or a :class:`DataSource` (every candidate's init, EM and
    BIC then run out of core)."""
    device = config.resolve_device()
    source = isinstance(x, DataSource)
    if source:
        require_array_weights(sample_weight, "fit_gmm_bic over a DataSource")
        w = None
    else:
        x = torch.as_tensor(x, device=device).to(torch.float32)
        w = (None if sample_weight is None else
             torch.as_tensor(sample_weight, device=device).to(torch.float32))
    best, best_bic, bics = None, float("inf"), {}
    for i, k in enumerate(k_candidates):
        res = fit_gmm_cfg(derive_seed(seed, i), x, k, config, w)
        b = float(bic_streaming(res.gmm, x, w,
                                chunk_size=config.resolve_chunk(source),
                                backend=config.backend))
        bics[k] = b
        if b < best_bic:
            best, best_bic = res, b
    return best, bics


def fit_gmm_bic(seed: int, x, k_candidates: Sequence[int],
                sample_weight=None, covariance_type: str = "diag",
                max_iter: int = 200, tol: float = 1e-3,
                reg_covar: float = 1e-6, estep_backend: str = "auto",
                chunk_size: Optional[int] = None, device="cuda"
                ) -> tuple[EMResult, dict[int, float]]:
    """Legacy keyword surface of :func:`fit_gmm_bic_cfg` (prefer
    ``repro_torch.api.GMMEstimator`` with ``k_candidates``)."""
    cfg = FitConfig.from_legacy(
        backend=estep_backend, chunk_size=chunk_size,
        covariance_type=covariance_type, reg_covar=reg_covar, tol=tol,
        max_iter=max_iter, device=device)
    return fit_gmm_bic_cfg(seed, x, k_candidates, cfg, sample_weight)
