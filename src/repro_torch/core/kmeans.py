"""K-means: k-means++ seeding, weighted Lloyd iterations and one-shot
federated k-means (port of ``repro/core/kmeans.py``).

Like the EM engine, everything here runs on stacked problems: rows
``x (B, N, d)``, weights ``w (B, N)``, centers ``(B, K, d)``. The B axis
stands in for ``jax.vmap``: the k-means inits of all clients, and all
``n_init`` restarts of each, run as one batch, one kernel launch per
sweep on the fused backend. A member stops iterating when its own center
shift drops to ``tol``, and its centers are frozen from then on, as under
vmap.

Random draws come from explicit torch generators: member b of a call with
``seed`` draws from ``derive_seed(seed, b)`` and a stage name. A call may
instead pass one seed per member; member b then draws what a lone problem
seeded with ``seed[b]`` would, so one batch stands in for a loop of
single fits (per-client BIC selection relies on that). The draws
are not the JAX package's (threefry and Philox never agree), so the seeded
stages are compared with it statistically, and the deterministic ones
(``init_centers=``) exactly.

Out-of-core data runs through the source twins: ``kmeans_plusplus_streaming``
(Gumbel-max seeding over blocks), ``kmeans_source`` and
``kmeans_multi_source`` (host-driven Lloyd loops, one
``kmeans_sweep_stats`` launch a block on the fused backend) and
``federated_kmeans`` over a list of sources; none holds an (N, ·) tensor.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import tracing
from repro_torch.core.config import (FitConfig, derive_seed, is_source_list,
                                     make_generator, require_array_weights,
                                     resolve_backend, resolve_device,
                                     resolve_source_chunk)
from repro_torch.core.em import (SufficientStats, _weights, _select,
                                 reduce_rows, streaming_map_reduce,
                                 streaming_reduce)
from repro_torch.data.sources import (TILE, DataSource, prefetch_blocks,
                                      tiled)

# Rows the k-means++ seeding works from when the dataset is larger (the
# Lloyd sweeps still see every row).
SEED_ROWS = 16384

# Lockstep Lloyd sweeps every restart runs before kmeans_multi keeps the
# best seed.
PILOT_ITERS = 3

# Full-data Lloyd budget of kmeans_multi's refine stage beyond SEED_ROWS.
REFINE_ITERS = 10


class KMeansResult(NamedTuple):
    centers: torch.Tensor        # (K, d)
    assignments: torch.Tensor    # (N,); None on a DataSource
    inertia: torch.Tensor        # ()
    n_iter: torch.Tensor         # ()
    cluster_sizes: torch.Tensor  # (K,) sum of sample weights per cluster


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (.., N, K) via the matmul identity."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1).unsqueeze(-2)
    return torch.clamp(x2 - 2.0 * (x @ centers.transpose(-1, -2)) + c2,
                       min=0.0)


def _assign_block(xb: torch.Tensor, centers: torch.Tensor):
    """Reference nearest-center assignment of one row block -> (int32
    index, d2) through the matmul identity; ties go to the first index."""
    dists = _sq_dists(xb, centers)
    return (torch.argmin(dists, dim=-1).to(torch.int32),
            dists.min(dim=-1).values)


def _labels_onehot(idx: torch.Tensor, k: int, wb: torch.Tensor,
                   dtype) -> torch.Tensor:
    """Weighted one-hot (.., R, K) of an assignment vector, so per-cluster
    sums are matmuls (``oh.T @ xb``)."""
    cols = torch.arange(k, device=idx.device)
    return (idx.unsqueeze(-1) == cols).to(dtype) * wb.unsqueeze(-1)


def _sweep_block(xb: torch.Tensor, wb: torch.Tensor, centers: torch.Tensor,
                 backend: str):
    """Weighted Lloyd-sweep statistics of one block:
    (counts (.., K), sums (.., K, d), inertia (..)). ``fused`` launches the
    CUDA ``kmeans_sweep_stats`` kernel, which assigns and reduces in one
    pass; reference builds the weighted one-hot matrix."""
    if backend == "fused":
        from repro_torch.kernels import ops
        counts, sums, inertia, _ = ops.kmeans_sweep(xb, wb, centers)
        return counts, sums, inertia
    idx, d2 = _assign_block(xb, centers)
    oh = _labels_onehot(idx, centers.shape[-2], wb, xb.dtype)
    return oh.sum(dim=-2), oh.transpose(-1, -2) @ xb, torch.sum(d2 * wb,
                                                                 dim=-1)


def _update_block(xb: torch.Tensor, wb: torch.Tensor, centers: torch.Tensor,
                  backend: str):
    """counts/sums only: the Lloyd loop never reads inertia, so the
    reference assignment reduces to ``argmax(x·c - |c|²/2)``."""
    if backend == "fused":
        return _sweep_block(xb, wb, centers, backend)[:2]
    score = xb @ centers.transpose(-1, -2) - 0.5 * torch.sum(
        centers * centers, dim=-1).unsqueeze(-2)
    idx = torch.argmax(score, dim=-1)
    oh = _labels_onehot(idx, centers.shape[-2], wb, xb.dtype)
    return oh.sum(dim=-2), oh.transpose(-1, -2) @ xb


# ----------------------------------------------------------------------
# Seeding
# ----------------------------------------------------------------------

Seed = Union[int, Sequence[int]]


class MemberSeeds(tuple):
    """Per-member seeds taken as they are: member b of a batch draws from
    ``seed[b]`` itself. ``MemberSeeds(derive_seed(s, c) for c in ids)``
    gives a batch of the clients ``ids`` the draws those clients get as
    members of a batch of every client seeded with the integer ``s``, so a
    rank of a sharded run fits its block as the whole split would."""


def _member_seeds(seed: Seed, b: int) -> list[int]:
    """The seeds of the ``b`` members of a batch: ``derive_seed(seed, i)``
    for an integer ``seed``; :class:`MemberSeeds` as they are; for another
    sequence of per-member seeds, the seed member 0 of a lone call with
    ``seed[i]`` gets."""
    if isinstance(seed, MemberSeeds):
        seeds = list(seed)
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} member seeds for a batch of {b}")
        return seeds
    if not isinstance(seed, (list, tuple)):
        return [derive_seed(seed, i) for i in range(b)]
    seeds = [derive_seed(int(s), 0) for s in seed]
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} member seeds for a batch of {b}")
    return seeds


def _uniforms(seeds, stage: str, shape: tuple, device) -> torch.Tensor:
    """(B, *shape) float64 uniforms in [0, 1), member b from its own
    generator."""
    u = torch.stack([
        torch.rand(shape, generator=make_generator(derive_seed(s, stage)),
                   dtype=torch.float64) for s in seeds])
    return tracing.blocking(u.to, device)


def _categorical(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per member with probability ∝ ``p`` (B, N), by inverting
    the float64 CDF at the uniforms ``u`` (B,)."""
    cdf = torch.cumsum(p.to(torch.float64), dim=-1)
    t = (u * cdf[:, -1]).unsqueeze(-1)
    idx = torch.searchsorted(cdf, t, right=True).squeeze(-1)
    return torch.clamp(idx, max=p.shape[-1] - 1)


def _kmeanspp(x: torch.Tensor, w: torch.Tensor, k: int,
              u: torch.Tensor) -> torch.Tensor:
    """Batched k-means++ from pre-drawn uniforms ``u`` (B, k) -> (B, k, d).
    Zero-weight (padded) rows are never drawn."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)
    first = _categorical(torch.clamp(w, min=1e-30), u[:, 0])
    c = x[rows, first]
    centers = x.new_zeros((b, k, d))
    centers[:, 0] = c
    min_d = torch.sum((x - c.unsqueeze(1)) ** 2, dim=-1)
    for i in range(1, k):
        idx = _categorical(torch.clamp(min_d * w, min=1e-30), u[:, i])
        c = x[rows, idx]
        centers[:, i] = c
        min_d = torch.minimum(min_d, torch.sum((x - c.unsqueeze(1)) ** 2,
                                               dim=-1))
    return centers


def _subsample(seeds, stage: str, x: torch.Tensor, w: torch.Tensor,
               rows: int):
    """A uniform row subsample (with replacement) per member; weights ride
    along."""
    n, d = x.shape[1], x.shape[2]
    idx = torch.stack([
        torch.randint(0, n, (rows,),
                      generator=make_generator(derive_seed(s, stage)))
        for s in seeds])
    idx = tracing.blocking(idx.to, x.device)
    return (torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1, d)),
            torch.gather(w, 1, idx))


def _seed_centers(seeds, x: torch.Tensor, w: torch.Tensor, k: int,
                  seed_rows: int) -> torch.Tensor:
    """k-means++ over a uniform row subsample once N exceeds
    ``seed_rows``; over every row below that (the ``kmeans.seed`` span)."""
    with tracing.span("kmeans.seed"):
        if x.shape[1] > seed_rows:
            x, w = _subsample(seeds, "seed-rows", x, w, seed_rows)
        return _kmeanspp(x, w, k,
                         _uniforms(seeds, "kmeans++", (k,), x.device))


def kmeans_plusplus(seed: Seed, x: torch.Tensor, k: int,
                    sample_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """k-means++ seeding -> (k, d), or (B, k, d) for a batch x (B, N, d).
    Supports zero-weighted (padded) rows."""
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        return kmeans_plusplus(seed, x[None], k, w[None])[0]
    seeds = _member_seeds(seed, x.shape[0])
    return _kmeanspp(x, w, k, _uniforms(seeds, "kmeans++", (k,), x.device))


# ----------------------------------------------------------------------
# Lloyd
# ----------------------------------------------------------------------

def _lloyd(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
           max_iter: int, tol: float, chunk_size: Optional[int],
           backend: str) -> KMeansResult:
    """Batched Lloyd's algorithm from ``centers`` (B, k, d): each member
    sweeps while ``it < max_iter`` and its squared center shift > ``tol``.
    Assignments, inertia and sizes come from a final sweep against the
    returned centers. The whole call is one ``kmeans.lloyd`` span."""
    with tracing.span("kmeans.lloyd"):
        def sweep_stats(c):
            return reduce_rows(
                lambda xb, wb: _update_block(xb, wb, c, backend), (x, w),
                chunk_size)

        b = x.shape[0]
        it = torch.zeros(b, dtype=torch.int64, device=x.device)
        shift = torch.full((b,), float("inf"), dtype=x.dtype,
                           device=x.device)
        active = (it < max_iter) & (shift > tol)
        while tracing.blocking(bool, active.any()):
            counts, sums = sweep_stats(centers)
            cnt = counts.unsqueeze(-1)
            new = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1e-12),
                              centers)
            new_shift = torch.sum((new - centers) ** 2, dim=(-1, -2))
            centers = _select(active, new, centers)
            shift = torch.where(active, new_shift, shift)
            it = it + active.to(it.dtype)
            active = (it < max_iter) & (shift > tol)

        def block(xb, wb):
            if backend == "fused":
                from repro_torch.kernels import ops
                counts, _, inertia, idx = ops.kmeans_sweep(
                    xb, wb, centers, with_idx=True)
                return (counts, inertia), (idx,)
            idx, d2 = _assign_block(xb, centers)
            oh = _labels_onehot(idx, centers.shape[-2], wb, xb.dtype)
            return ((oh.sum(dim=-2), torch.sum(d2 * wb, dim=-1)), (idx,))

        if chunk_size is None:
            (counts, inertia), (assign,) = block(x, w)
        else:
            (counts, inertia), (assign,) = streaming_map_reduce(
                block, (x, w), chunk_size)
        return KMeansResult(centers, assign, inertia, it, counts)


def _lower(res: KMeansResult) -> KMeansResult:
    return KMeansResult(*(t[0] for t in res))


def kmeans(seed: Seed, x: torch.Tensor, k: int,
           sample_weight: Optional[torch.Tensor] = None,
           max_iter: int = 100, tol: float = 1e-4,
           chunk_size: Optional[int] = None,
           assign_backend: str = "auto",
           init_centers: Optional[torch.Tensor] = None,
           seed_rows: int = SEED_ROWS) -> KMeansResult:
    """Weighted Lloyd's algorithm with k-means++ init. x (N, d), or a batch
    (B, N, d) of independent problems. ``init_centers`` skips seeding."""
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        return _lower(kmeans(seed, x[None], k, w[None], max_iter, tol,
                             chunk_size, assign_backend,
                             None if init_centers is None
                             else init_centers[None], seed_rows))
    backend = resolve_backend(assign_backend, x.device)
    if init_centers is None:
        init_centers = _seed_centers(_member_seeds(seed, x.shape[0]), x, w,
                                     k, seed_rows)
    return _lloyd(x, w, init_centers.to(x), max_iter, tol, chunk_size,
                  backend)


def kmeans_multi(seed: Seed, x: torch.Tensor, k: int,
                 sample_weight: Optional[torch.Tensor] = None,
                 max_iter: int = 100, tol: float = 1e-4,
                 n_init: int = 4,
                 chunk_size: Optional[int] = None,
                 assign_backend: str = "auto",
                 pilot_iters: int = PILOT_ITERS,
                 seed_rows: int = SEED_ROWS) -> KMeansResult:
    """Best of ``n_init`` k-means restarts, pilot-pruned: every seed runs
    ``pilot_iters`` fixed Lloyd sweeps (all restarts of all members in one
    batch), the lowest pilot inertia wins, and only the winner iterates to
    convergence. Beyond ``seed_rows`` rows the pilot and the winner's
    convergence run on one uniform row subsample per member, followed by a
    :data:`REFINE_ITERS` full-data polish."""
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        return _lower(kmeans_multi(seed, x[None], k, w[None], max_iter, tol,
                                   n_init, chunk_size, assign_backend,
                                   pilot_iters, seed_rows))
    if n_init == 1:
        return kmeans(seed, x, k, w, max_iter, tol, chunk_size,
                      assign_backend, seed_rows=seed_rows)
    b, n, d = x.shape
    backend = resolve_backend(assign_backend, x.device)
    seeds = _member_seeds(seed, b)
    if n > seed_rows:
        xs, ws = _subsample(seeds, "pilot-rows", x, w, seed_rows)
        pilot_chunk = None
    else:
        xs, ws, pilot_chunk = x, w, chunk_size
    xr = xs.repeat_interleave(n_init, dim=0)
    wr = ws.repeat_interleave(n_init, dim=0)
    with tracing.span("kmeans.seed"):
        u = _uniforms(seeds, "pilot", (n_init, k), x.device).reshape(-1, k)
        centers = _kmeanspp(xr, wr, k, u)
    inertia = torch.full((b * n_init,), float("inf"), dtype=x.dtype,
                         device=x.device)
    for _ in range(pilot_iters):
        counts, sums, inertia = reduce_rows(
            lambda xb, wb: _sweep_block(xb, wb, centers, backend), (xr, wr),
            pilot_chunk)
        cnt = counts.unsqueeze(-1)
        centers = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1e-12),
                              centers)
    best = torch.argmin(inertia.view(b, n_init), dim=-1)
    best_centers = centers.view(b, n_init, k, d)[
        torch.arange(b, device=x.device), best]
    if n > seed_rows:
        sub = _lloyd(xs, ws, best_centers, max_iter, tol, None, backend)
        res = _lloyd(x, w, sub.centers, min(max_iter, REFINE_ITERS), tol,
                     chunk_size, backend)
        return res._replace(n_iter=res.n_iter + sub.n_iter + pilot_iters)
    res = _lloyd(x, w, best_centers, max_iter, tol, chunk_size, backend)
    return res._replace(n_iter=res.n_iter + pilot_iters)


# ----------------------------------------------------------------------
# Config core and federated k-means
# ----------------------------------------------------------------------

def kmeans_fit_cfg(seed: Seed, x, k: int, config: FitConfig,
                   sample_weight=None, n_init: int = 1) -> KMeansResult:
    """The k-means trainer behind ``repro_torch.api.KMeansEstimator``:
    :func:`kmeans` (``n_init`` = 1) or :func:`kmeans_multi` on an array,
    :func:`kmeans_source` or :func:`kmeans_multi_source` on a
    :class:`DataSource`, with ``tol`` and ``max_iter`` resolved through the
    "kmeans" defaults (1e-4 / 100)."""
    device = config.resolve_device()
    tol = config.resolve_tol("kmeans")
    max_iter = config.resolve_max_iter("kmeans")
    if isinstance(x, DataSource):
        require_array_weights(sample_weight, "k-means over a DataSource")
        cs = config.resolve_chunk(source=True)
        if n_init == 1:
            return kmeans_source(seed, x, k, max_iter, tol, cs,
                                 config.backend, device=device)
        return kmeans_multi_source(seed, x, k, max_iter, tol, n_init, cs,
                                   config.backend, device=device)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    w = (None if sample_weight is None else
         torch.as_tensor(sample_weight, device=device).to(torch.float32))
    cs = config.resolve_chunk(source=False)
    if n_init == 1:
        return kmeans(seed, x, k, w, max_iter, tol, cs, config.backend)
    return kmeans_multi(seed, x, k, w, max_iter, tol, n_init, cs,
                        config.backend)


def federated_kmeans(seed: int, client_data, k_global: int,
                     k_local: Optional[int] = None,
                     client_weights: Optional[torch.Tensor] = None,
                     max_iter: int = 100, chunk_size: Optional[int] = None,
                     assign_backend: str = "auto",
                     device="cuda", sharded=None) -> torch.Tensor:
    """One-shot federated k-means (Dennis et al. '21) -> global centers
    ``(k_global, d)``.

    ``client_data`` is padded clients ``(C, N, d)`` with 0/1
    ``client_weights (C, N)``: every client's local k-means runs in one
    batch (client c draws from member c of ``derive_seed(seed,
    "local")``). Or it is a list of per-client :class:`DataSource` streams:
    client c then runs :func:`kmeans_source` on ``device``, seeded with
    ``derive_seed(seed, "local", c)``, and ragged sizes need no padding or
    weights. The server clusters the C·k_local local centers, each
    weighted by its cluster size (seed ``derive_seed(seed, "server")``).

    ``sharded`` (a :class:`repro_torch.fed.runtime.ShardedClients`) makes
    ``client_data`` its rank's block: the block's clients draw what they
    would in the whole batch, and one all-gather brings every client's
    centers and sizes to the (replicated) server step."""
    k_local = k_local or k_global
    if is_source_list(client_data):
        if client_weights is not None:
            raise ValueError(
                "federated_kmeans over DataSources: client_weights is "
                "array-path-only (weights mask padded fixed-shape client "
                "arrays; source shards are ragged by nature and every "
                "source row has weight 1)")
        results = [kmeans_source(derive_seed(seed, "local", c), src, k_local,
                                 max_iter=max_iter, chunk_size=chunk_size,
                                 assign_backend=assign_backend, device=device)
                   for c, src in enumerate(client_data)]
        centers = torch.cat([r.centers for r in results])
        sizes = torch.cat([r.cluster_sizes for r in results])
    else:
        local_seed = derive_seed(seed, "local")
        if sharded is not None:
            local_seed = sharded.block_seeds(local_seed)
        local = kmeans(local_seed, client_data, k_local, client_weights,
                       max_iter=max_iter, chunk_size=chunk_size,
                       assign_backend=assign_backend)
        centers, sizes = local.centers, local.cluster_sizes
        if sharded is not None:
            centers, sizes = sharded.all_gather((centers, sizes))
        centers = centers.reshape(-1, client_data.shape[-1])
        sizes = sizes.reshape(-1)
    res = kmeans(derive_seed(seed, "server"), centers, k_global, sizes,
                 max_iter=max_iter, assign_backend=assign_backend)
    return res.centers


def federated_kmeans_from_sources(seed: int,
                                  sources: Sequence[DataSource],
                                  k_global: int,
                                  k_local: Optional[int] = None,
                                  max_iter: int = 100,
                                  chunk_size: Optional[int] = None,
                                  assign_backend: str = "auto",
                                  device="cuda") -> torch.Tensor:
    """Deprecated: :func:`federated_kmeans` dispatches on its input type,
    so a list of sources goes straight in. This shim forwards (the same
    bits) and will be removed."""
    warnings.warn(
        "federated_kmeans_from_sources is deprecated; pass the list of "
        "DataSources directly to repro_torch.core.kmeans.federated_kmeans "
        "— same engine, same bits",
        DeprecationWarning, stacklevel=2)
    return federated_kmeans(seed, list(sources), k_global, k_local=k_local,
                            max_iter=max_iter, chunk_size=chunk_size,
                            assign_backend=assign_backend, device=device)


def lloyd_round_stats(centers: torch.Tensor, x,
                      sample_weight: Optional[torch.Tensor] = None,
                      assign_backend: str = "auto",
                      chunk_size: Optional[int] = None):
    """One weighted Lloyd sweep against fixed centers -> ``(counts (.., K),
    sums (.., K, d), inertia (..))``: the label statistics one federated
    k-means client ships each round (Garst et al.). ``x`` is (N, d) or a
    batch (B, N, d) of clients; ``centers`` (K, d) is broadcast to every
    member, or (B, K, d) gives one set each. ``x`` may also be one
    :class:`DataSource` (no weights), swept block by block on the
    centers' device. ``assign_backend`` resolves with the data's device;
    the fused sweep is one ``kmeans_sweep_stats`` launch a chunk."""
    if isinstance(x, DataSource):
        require_array_weights(sample_weight,
                              "lloyd_round_stats over a DataSource")
        backend = resolve_backend(assign_backend, centers.device)
        return tuple(reduce_rows(
            lambda xb, wb: _lloyd_block(centers, xb, wb, backend), x,
            chunk_size, centers.device))
    w = _weights(x, sample_weight)
    if x.ndim == 2:
        counts, sums, inertia = lloyd_round_stats(
            centers if centers.ndim == 3 else centers[None], x[None],
            w[None], assign_backend, chunk_size)
        return counts[0], sums[0], inertia[0]
    backend = resolve_backend(assign_backend, x.device)
    if centers.ndim == 2:
        centers = centers.expand((x.shape[0],) + centers.shape)
    return tuple(reduce_rows(
        lambda xb, wb: _sweep_block(xb, wb, centers, backend),
        (x, w), chunk_size))


# ----------------------------------------------------------------------
# Out of core: host-driven loops over DataSource blocks
# ----------------------------------------------------------------------

def _gumbel(seed: int, rnd: int, start: int, size: int, restarts: int,
            seeds: dict, gen: torch.Generator, dtype, device) -> torch.Tensor:
    """(restarts, size) Gumbel noise of the global rows [start, start +
    size) in seeding round ``rnd``: the noise of row i depends on (seed,
    rnd, i) only, never on the block partition. Rows come in tiles aligned
    to the global row index, tile t drawn in full, for every restart at
    once, from ``derive_seed(seed, "kmeans++", rnd, t)``: one RNG launch a
    tile and round."""
    def draw(t):
        s = seeds.get((rnd, t))
        if s is None:
            s = seeds[rnd, t] = derive_seed(seed, "kmeans++", rnd, t)
        gen.manual_seed(s)
        return (torch.rand((restarts, TILE), generator=gen, device=device,
                           dtype=dtype),)

    u, = tiled(start, size, draw, axis=1)
    return -torch.log(-torch.log(u))


def _seed_block(centers: torch.Tensor, valid: torch.Tensor,
                noise: torch.Tensor, xb: torch.Tensor, wb: torch.Tensor):
    """One k-means++ sampling round over one block, for a batch of
    restarts (``centers (B, K, d)``, ``noise (B, R)``), by the Gumbel-max
    trick: drawing a row with probability ∝ its min squared distance is
    taking the argmax of ``log(min d²) + Gumbel``. With no valid center
    yet (round 0) the score is the noise alone, a uniform draw. Pad rows
    score -inf and are never drawn. Returns each restart's best score in
    the block and its row, on the device (the first of equal scores)."""
    d2 = torch.where(valid, _sq_dists(xb, centers), float("inf"))
    d2min = torch.min(d2, dim=-1).values
    base = torch.where(torch.isfinite(d2min),
                       torch.log(torch.clamp(d2min, min=1e-30)), 0.0)
    score = torch.where(wb > 0, base + noise, float("-inf"))
    best, i = torch.max(score, dim=-1)
    return best, torch.index_select(xb, 0, i)


def kmeans_plusplus_streaming(seed: int, source: DataSource, k: int,
                              chunk_size: Optional[int] = None,
                              device="cuda",
                              n_init: Optional[int] = None) -> torch.Tensor:
    """k-means++ seeding over a :class:`DataSource` -> (k, d) on
    ``device``, or (n_init, k, d): ``n_init`` independent seedings from one
    stream of passes. Each of the k rounds streams the blocks once,
    recomputing the min distances to the centers so far (O(k²·N·d) instead
    of the resident pass's O(k·N·d): the price of holding no (N,) state).
    The running best scores and rows stay on the device, the first block
    winning ties; nothing is read by the host."""
    chunk_size = resolve_source_chunk(chunk_size)
    device = resolve_device(device)
    dtype = source.dtype
    b = 1 if n_init is None else int(n_init)
    centers = torch.zeros((b, k, source.dim), dtype=dtype, device=device)
    valid = torch.zeros((k,), dtype=torch.bool, device=device)
    gen = torch.Generator(device=device)
    seeds: dict = {}
    for r in range(k):
        best_score = torch.full((b,), float("-inf"), dtype=dtype,
                                device=device)
        best_row = centers[:, 0].clone()
        start = 0
        for xb, wb in prefetch_blocks(source, chunk_size, device=device):
            noise = _gumbel(seed, r, start, xb.shape[0], b, seeds, gen,
                            dtype, device)
            score, row = _seed_block(centers, valid, noise, xb, wb)
            better = score > best_score
            best_score = torch.where(better, score, best_score)
            best_row = torch.where(better.unsqueeze(-1), row, best_row)
            start += xb.shape[0]
        centers[:, r] = best_row
        valid[r] = True
    return centers[0] if n_init is None else centers


def _lloyd_block(centers: torch.Tensor, xb: torch.Tensor, wb: torch.Tensor,
                 backend: str):
    """(counts, sums, inertia) of one block against ``centers`` (K, d), or
    against a batch of restarts' centers (B, K, d), as one batch (one
    ``kmeans_sweep_stats`` launch on the fused backend); ``wb`` is the pad
    mask."""
    single = centers.ndim == 2
    cb = centers[None] if single else centers
    m = cb.shape[0]
    counts, sums, inertia = _sweep_block(xb.expand((m,) + xb.shape),
                                         wb.expand(m, -1), cb, backend)
    if single:
        return counts[0], sums[0], inertia[0]
    return counts, sums, inertia


def kmeans_label_block(centers: torch.Tensor, xb: torch.Tensor,
                       wb: torch.Tensor, covariance_type: str,
                       backend: str) -> SufficientStats:
    """Hard-assignment label statistics of one block against fixed centers,
    the out-of-core ``label_stats``: assignment and labelling in one pass,
    so the (N,) label vector never exists. On the fused backend the block
    goes through the ``kmeans_assign`` kernel, then the weighted one-hot
    products; ``wb`` masks the pad rows out of every sum."""
    if backend == "fused":
        from repro_torch.kernels import ops
        idx, _ = ops.kmeans_assign(xb, centers)
    else:
        idx, _ = _assign_block(xb, centers)
    oh = _labels_onehot(idx, centers.shape[0], wb, xb.dtype)
    ot = oh.transpose(0, 1)
    if covariance_type == "diag":
        s2 = ot @ (xb * xb)
    else:
        s2 = torch.einsum("nk,ni,nj->kij", oh, xb, xb)
    return SufficientStats(oh.sum(dim=0), ot @ xb, s2,
                           xb.new_zeros(()), wb.sum())


def _lloyd_update(centers: torch.Tensor, counts: torch.Tensor,
                  sums: torch.Tensor) -> torch.Tensor:
    cnt = counts.unsqueeze(-1)
    return torch.where(cnt > 0, sums / torch.clamp(cnt, min=1e-12), centers)


def kmeans_source(seed: int, source: DataSource, k: int,
                  max_iter: int = 100, tol: float = 1e-4,
                  chunk_size: Optional[int] = None,
                  assign_backend: str = "auto",
                  init_centers: Optional[torch.Tensor] = None,
                  device="cuda") -> KMeansResult:
    """Lloyd's algorithm over a :class:`DataSource` on ``device``: streamed
    k-means++ seeding, then host-driven sweeps summing (counts, sums,
    inertia) block by block, reading one center shift a sweep. The same
    update, stopping rule and final re-score as :func:`kmeans`, without the
    assignments (the only O(N) output). ``init_centers`` skips seeding."""
    chunk_size = resolve_source_chunk(chunk_size)
    if init_centers is not None:
        device = init_centers.device
    device = resolve_device(device)
    backend = resolve_backend(assign_backend, device)
    if init_centers is None:
        centers = kmeans_plusplus_streaming(seed, source, k, chunk_size,
                                            device)
    else:
        centers = init_centers

    def sweep(c):
        return streaming_reduce(
            lambda xb, wb: _lloyd_block(c, xb, wb, backend), source,
            chunk_size, device)

    it, shift, tol = 0, float("inf"), float(tol)
    while it < max_iter and shift > tol:
        counts, sums, _ = sweep(centers)
        new_centers = _lloyd_update(centers, counts, sums)
        shift = float(torch.sum((new_centers - centers) ** 2))
        centers, it = new_centers, it + 1
    counts, _, inertia = sweep(centers)
    return KMeansResult(centers, None, inertia,
                        torch.tensor(it, device=device), counts)


def kmeans_multi_source(seed: int, source: DataSource, k: int,
                        max_iter: int = 100, tol: float = 1e-4,
                        n_init: int = 4,
                        chunk_size: Optional[int] = None,
                        assign_backend: str = "auto",
                        pilot_iters: int = PILOT_ITERS,
                        device="cuda") -> KMeansResult:
    """Best of ``n_init`` out-of-core restarts, pilot-pruned as
    :func:`kmeans_multi`: the restarts seed together (one stream of k
    passes, :func:`kmeans_plusplus_streaming` with ``n_init``) and sweep
    together for ``pilot_iters`` passes (one batched sweep a block); the
    lowest pilot inertia wins (one host read), and only the winner iterates
    to convergence."""
    if n_init == 1:
        return kmeans_source(seed, source, k, max_iter, tol, chunk_size,
                             assign_backend, device=device)
    chunk_size = resolve_source_chunk(chunk_size)
    device = resolve_device(device)
    backend = resolve_backend(assign_backend, device)
    centers = kmeans_plusplus_streaming(seed, source, k, chunk_size, device,
                                        n_init=n_init)
    inertia = None
    for _ in range(pilot_iters):
        counts, sums, inertia = streaming_reduce(
            lambda xb, wb: _lloyd_block(centers, xb, wb, backend), source,
            chunk_size, device)
        centers = _lloyd_update(centers, counts, sums)
    best = 0 if inertia is None else int(torch.argmin(inertia))
    res = kmeans_source(seed, source, k, max_iter, tol, chunk_size, backend,
                        init_centers=centers[best])
    return res._replace(n_iter=res.n_iter + pilot_iters)
