// k-means assignment (nearest center and its squared distance), and the
// weighted Lloyd-sweep statistics of that assignment, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign.py::_assign_kernel
// (launched by kmeans_assign_pallas, pallas_call at kmeans_assign.py:38),
// and the one-hot reductions that consume it in
// src/repro/core/kmeans.py::_sweep_block.
//
//   d2[n, k] = max(|x_n|^2 - 2 x_n . C_k + |C_k|^2, 0)
//   idx[n] = argmin_k d2 (first index on ties, as jnp.argmin), dmin[n] = min_k d2
//   kmeans_sweep: counts[k] = sum_{idx[n] = k} w[n],
//                 sums[k, :] = sum_{idx[n] = k} w[n] x[n, :],
//                 inertia = sum_n w[n] dmin[n]
//
// What bounds it: 2*d*K flops per row against (d + 2)*4 bytes (assignment)
// or (d + 1)*4 bytes (sweep), about 14 flop/byte at d = 24, K = 30: below
// the f32 CUDA-core ridge (about 20 flop/byte), so the bound is reading x.
// The kernel reads each row once; the (N, K) distances and the (N, K)
// one-hot matrix never exist.
//
// Design:
// * Assignment core: a block of 128 threads takes a tile of 256 rows, staged
//   into shared memory by coalesced cp.async (tile_reduce.cuh). Each thread
//   holds 2 rows of x in registers (loaded as float4, DC dims, DC = 8, 16,
//   24 or 32 by d; dims beyond 32 are read from shared memory; where d is too
//   wide for two 256-row buffers, one buffer, then 128-row tiles) and reads the
//   transposed centers as float4 broadcasts, so one shared load feeds
//   4 centers x 2 rows of FMAs. Each dot product is one FMA chain over j
//   ascending, then the clamped distance and a strict `<` compare, which
//   keeps the first index on ties. Padded centers have |C|^2 = +inf.
// * Sweep statistics in the kernel: the tile's rows are sorted by label with
//   a stable counting sort in shared memory (__match_any_sync ranks within
//   each 32-row segment, a prefix over segments, a prefix over clusters);
//   then each (cluster, 4 consecutive dims) output has one owner thread that
//   walks its cluster's rows in row order: O(rows*d) work per tile, not
//   O(rows*K*d). Inertia comes from fixed-order butterflies.
// * A leading batch axis (grid.y) carries independent problems: the k-means
//   of every client and restart is one launch per sweep. Blocks walk chunks
//   of consecutive tiles, double-buffering the x tiles where shared memory
//   allows, and the sweep's
//   per-(problem, chunk) partials are summed in chunk order by the second
//   pass of tile_reduce.cuh. No float atomics: two launches give the same
//   bits.

#include <cuda_runtime.h>

#include <cmath>

#include "tile_reduce.cuh"

namespace {

using tile_reduce::kFullMask;
using tile_reduce::ld4;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;

struct Layout {
  int rows;  // rows per thread: 2, or 1 (128-row tiles) where 2 do not fit
  int nbuf;  // x tile buffers: 2 (the next tile staged during this one) or 1
  int dc;    // dims held in registers per row
  int kp;    // K padded to a multiple of 4
  int cr;    // rows of the staged centers: max(d padded to 4, dc)
  int xs;    // shared row stride of the x tile
  size_t smem;
};

// The first of (2 rows a thread, 2 buffers), (2, 1), (1, 2), (1, 1) whose
// shared memory fits; the last one if none does (the launch then fails).
Layout layout(int d, int k, bool stats) {
  Layout l;
  const int dp = (d + 3) & ~3;
  l.kp = (k + 3) & ~3;
  for (int option = 0; option < 4; ++option) {
    l.rows = option < 2 ? 2 : 1;
    l.nbuf = option % 2 ? 1 : 2;
    l.dc = l.rows == 1 ? 32 : dp <= 8 ? 8 : dp <= 16 ? 16 : dp <= 24 ? 24 : 32;
    l.cr = dp > l.dc ? dp : l.dc;
    l.xs = tile_reduce::row_stride(l.cr);
    const int tile = kThreads * l.rows;
    size_t words = (size_t)l.cr * l.kp + l.kp + (size_t)l.nbuf * tile * l.xs;
    if (stats)  // wts, lab, ord; segment counts; cluster starts; warp sums
      words += 3 * tile + (tile / 32) * l.kp + l.kp + 4 + kWarps;
    l.smem = 4 * words;
    if (l.smem <= kSmemLimit) break;
  }
  return l;
}

template <int DC, int TR, bool STATS>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ ct, const float* __restrict__ c2,
             int* __restrict__ idx, float* __restrict__ dmin,
             float* __restrict__ partial, int n, int d, int k,
             int tiles_per_chunk, int nbuf, int vec) {
  constexpr int kRowsPerThread = TR;
  constexpr int kTileRows = kThreads * TR;
  constexpr int kSegments = kTileRows / 32;
  extern __shared__ __align__(16) float smem[];
  const int kp = (k + 3) & ~3;
  const int dp = (d + 3) & ~3;
  const int cr = dp > DC ? dp : DC;
  const int xstride = tile_reduce::row_stride(cr);
  float* cts = smem;                           // cr * kp
  float* c2s = cts + cr * kp;                  // kp
  float* xbuf = c2s + kp;                      // nbuf * kTileRows * xstride
  // STATS only
  float* wts = xbuf + nbuf * kTileRows * xstride;  // kTileRows
  int* lab = reinterpret_cast<int*>(wts + kTileRows);  // kTileRows
  int* ord = lab + kTileRows;                  // kTileRows
  int* seg = ord + kTileRows;                  // kSegments * kp
  int* start = seg + kSegments * kp;           // kp + 4
  float* inw = reinterpret_cast<float*>(start + kp + 4);  // kWarps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.y;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int t_begin = blockIdx.x * tiles_per_chunk;
  const int t_end = min(t_begin + tiles_per_chunk, tiles);
  const int p_len = k + k * d + 1;
  float* part = STATS
      ? partial + ((size_t)bi * gridDim.x + blockIdx.x) * p_len : nullptr;

  const float* xb = x + (size_t)bi * n * d;
  const float* ctb = ct + (size_t)bi * d * k;
  const float* c2b = c2 + (size_t)bi * k;

  tile_reduce::stage_rows(xbuf, xb + (size_t)t_begin * kTileRows * d,
                          min(kTileRows, n - t_begin * kTileRows), d, xstride,
                          vec, tid, kThreads);
  for (int i = tid; i < cr * kp; i += kThreads) {
    const int j = i / kp;
    const int kk = i - j * kp;
    cts[i] = (j < d && kk < k) ? ctb[j * k + kk] : 0.f;
  }
  for (int i = tid; i < kp; i += kThreads) c2s[i] = i < k ? c2b[i] : INFINITY;
  if (cr > d) {  // the x tiles' padding columns, never written by a copy
    const int pad = cr - d;
    for (int i = tid; i < nbuf * kTileRows * pad; i += kThreads) {
      const int r = i / pad;
      xbuf[r * xstride + d + (i - r * pad)] = 0.f;
    }
  }
  if (STATS)
    for (int i = tid; i < kSegments * kp; i += kThreads) seg[i] = 0;

  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    float* xs = xbuf + ((t - t_begin) % nbuf) * kTileRows * xstride;
    if (nbuf == 1) {  // one buffer: this tile's copy, unless already started
      if (!first)
        tile_reduce::stage_rows(xs, xb + (size_t)t * kTileRows * d,
                                min(kTileRows, n - t * kTileRows), d, xstride,
                                vec, tid, kThreads);
      tile_reduce::cp_async_wait<0>();
    } else if (t + 1 < t_end) {
      float* next = xbuf + ((t + 1 - t_begin) & 1) * kTileRows * xstride;
      tile_reduce::stage_rows(next, xb + (size_t)(t + 1) * kTileRows * d,
                              min(kTileRows, n - (t + 1) * kTileRows), d,
                              xstride, vec, tid, kThreads);
      tile_reduce::cp_async_wait<1>();
    } else {
      tile_reduce::cp_async_wait<0>();
    }
    __syncthreads();
    const int row0 = t * kTileRows;
    const int rows = min(kTileRows, n - row0);

    // 1. assignment of rows tid (and tid + 128), x in registers
    float xr[kRowsPerThread][DC];
    float x2[kRowsPerThread], best[kRowsPerThread];
    int bk[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float* src = xs + (tid + i * kThreads) * xstride;
#pragma unroll
      for (int q = 0; q < DC; q += 4) {
        const float4 v = ld4(src + q);
        xr[i][q] = v.x; xr[i][q + 1] = v.y; xr[i][q + 2] = v.z; xr[i][q + 3] = v.w;
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DC; ++j) s = fmaf(xr[i][j], xr[i][j], s);
      for (int j = DC; j < dp; ++j) s = fmaf(src[j], src[j], s);
      x2[i] = s;
      best[i] = 0.f;
      bk[i] = 0;
    }
    for (int k4 = 0; k4 < kp; k4 += 4) {
      float acc[kRowsPerThread][4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float4 cv = ld4(cts + j * kp + k4);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[i][0] = fmaf(xr[i][j], cv.x, acc[i][0]);
          acc[i][1] = fmaf(xr[i][j], cv.y, acc[i][1]);
          acc[i][2] = fmaf(xr[i][j], cv.z, acc[i][2]);
          acc[i][3] = fmaf(xr[i][j], cv.w, acc[i][3]);
        }
      }
      for (int j = DC; j < dp; ++j) {  // d > 32: the rest from shared memory
        const float4 cv = ld4(cts + j * kp + k4);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float xj = xs[(tid + i * kThreads) * xstride + j];
          acc[i][0] = fmaf(xj, cv.x, acc[i][0]);
          acc[i][1] = fmaf(xj, cv.y, acc[i][1]);
          acc[i][2] = fmaf(xj, cv.z, acc[i][2]);
          acc[i][3] = fmaf(xj, cv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = k4 + q;
        const float cc = c2s[kk];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float dd = fmaxf(x2[i] - 2.f * acc[i][q] + cc, 0.f);
          if (kk == 0 || dd < best[i]) {
            best[i] = dd;
            bk[i] = kk;
          }
        }
      }
    }

    if (!STATS) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = tid + i * kThreads;
        if (r < rows) {
          const size_t o = (size_t)bi * n + row0 + r;
          idx[o] = bk[i];
          dmin[o] = best[i];
        }
      }
    } else {
      // 2. labels, weights, ranks within each 32-row segment, inertia
      const float* wb = w + (size_t)bi * n + row0;
      int rank[kRowsPerThread];
      float inl = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = tid + i * kThreads;
        const bool valid = r < rows;
        const int label = valid ? bk[i] : -1;
        const float wr = valid ? wb[r] : 0.f;
        wts[r] = wr;
        lab[r] = label;
        if (valid) {
          inl += wr * best[i];
          if (idx != nullptr) idx[(size_t)bi * n + row0 + r] = label;
        }
        // segment i * kWarps + warp holds rows [32 * segment, + 32)
        const unsigned peers = __match_any_sync(kFullMask, label);
        rank[i] = __popc(peers & ((1u << lane) - 1u));
        if (valid && lane == __ffs(peers) - 1)
          seg[(i * kWarps + warp) * kp + label] = __popc(peers);
      }
      for (int off = 1; off < 32; off <<= 1)
        inl += __shfl_xor_sync(kFullMask, inl, off);
      if (lane == 0) inw[warp] = inl;
      __syncthreads();
      // 3. per cluster: exclusive prefix over segments, then over clusters
      for (int kk = tid; kk < k; kk += kThreads) {
        int run = 0;
        for (int s = 0; s < kSegments; ++s) {
          const int cnt = seg[s * kp + kk];
          seg[s * kp + kk] = run;
          run += cnt;
        }
        start[kk] = run;
      }
      __syncthreads();
      if (warp == 0) {
        int carry = 0;
        for (int base = 0; base < k; base += 32) {
          const int kk = base + lane;
          const int v = kk < k ? start[kk] : 0;
          int incl = v;
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(kFullMask, incl, off);
            if (lane >= off) incl += y;
          }
          if (kk < k) start[kk] = carry + incl - v;
          carry += __shfl_sync(kFullMask, incl, 31);
        }
        if (lane == 0) start[k] = carry;
      } else if (tid == kThreads - 1) {
        float v = inw[0];
        for (int wi = 1; wi < kWarps; ++wi) v += inw[wi];
        part[p_len - 1] = first ? v : part[p_len - 1] + v;
      }
      __syncthreads();
      // 4. the stable order of the tile's rows by label
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = tid + i * kThreads;
        if (r < rows) {
          const int label = bk[i];
          ord[start[label] + seg[(i * kWarps + warp) * kp + label] + rank[i]] =
              r;
        }
      }
      __syncthreads();
      // 5. each (cluster, 4 dims) owner walks its cluster's rows in order
      const int dg = dp >> 2;
      for (int e = tid; e < k * dg; e += kThreads) {
        const int kk = e / dg;
        const int j0 = 4 * (e - kk * dg);
        float* ps = part + k + kk * d + j0;
        float s[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          s[q] = (!first && j0 + q < d) ? ps[q] : 0.f;
        float cnt = (j0 == 0 && !first) ? part[kk] : 0.f;
        const int p_end = start[kk + 1];
        for (int p = start[kk]; p < p_end; ++p) {
          const int r = ord[p];
          const float wr = wts[r];
          const float4 xv = ld4(xs + r * xstride + j0);
          s[0] = fmaf(wr, xv.x, s[0]);
          s[1] = fmaf(wr, xv.y, s[1]);
          s[2] = fmaf(wr, xv.z, s[2]);
          s[3] = fmaf(wr, xv.w, s[3]);
          cnt += wr;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q < d) ps[q] = s[q];
        if (j0 == 0) part[kk] = cnt;
      }
      for (int i = tid; i < kSegments * kp; i += kThreads) seg[i] = 0;
    }
    __syncthreads();  // before the next tile's copy and sort
  }
}

template <int DC, int TR, bool STATS>
cudaError_t launch(const float* x, const float* w, const float* ct,
                   const float* c2, int* idx, float* dmin, float* partial,
                   float* out, int batch, int n, int d, int k,
                   int tiles_per_chunk, const Layout& l, cudaStream_t st) {
  cudaError_t err =
      tile_reduce::allow_smem(sweep_kernel<DC, TR, STATS>, l.smem);
  if (err != cudaSuccess) return err;
  const int tile = kThreads * TR;
  const int tiles = (n + tile - 1) / tile;
  const int chunks = (tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  sweep_kernel<DC, TR, STATS><<<dim3(chunks, batch), kThreads, l.smem, st>>>(
      x, w, ct, c2, idx, dmin, partial, n, d, k, tiles_per_chunk, l.nbuf,
      tile_reduce::vector_rows(x, d));
  err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return err;
  return tile_reduce::reduce(partial, out, batch, chunks, k + k * d + 1, st);
}

template <bool STATS>
cudaError_t dispatch(const float* x, const float* w, const float* ct,
                     const float* c2, int* idx, float* dmin, float* partial,
                     float* out, int batch, int n, int d, int k,
                     int tiles_per_chunk, void* stream) {
  if (k < 1 || tiles_per_chunk < 1) return cudaErrorInvalidValue;
  const Layout l = layout(d, k, STATS);
  cudaStream_t st = (cudaStream_t)stream;
#define SWEEP_LAUNCH(DC, TR)                                                 \
  launch<DC, TR, STATS>(x, w, ct, c2, idx, dmin, partial, out, batch, n, d, \
                        k, tiles_per_chunk, l, st)
  if (l.rows == 1) return SWEEP_LAUNCH(32, 1);
  switch (l.dc) {
    case 8: return SWEEP_LAUNCH(8, 2);
    case 16: return SWEEP_LAUNCH(16, 2);
    case 24: return SWEEP_LAUNCH(24, 2);
    default: return SWEEP_LAUNCH(32, 2);
  }
#undef SWEEP_LAUNCH
}

template <bool STATS>
cudaError_t occupancy(int d, int k, int* out) {
  const Layout l = layout(d, k, STATS);
#define SWEEP_OCCUPANCY(DC, TR)                                         \
  tile_reduce::blocks_per_sm(sweep_kernel<DC, TR, STATS>, kThreads, l.smem, \
                             out)
  if (l.rows == 1) return SWEEP_OCCUPANCY(32, 1);
  switch (l.dc) {
    case 8: return SWEEP_OCCUPANCY(8, 2);
    case 16: return SWEEP_OCCUPANCY(16, 2);
    case 24: return SWEEP_OCCUPANCY(24, 2);
    default: return SWEEP_OCCUPANCY(32, 2);
  }
#undef SWEEP_OCCUPANCY
}

}  // namespace

extern "C" {

// The launch plan at (d, k) of the assignment (stats = 0) or the sweep
// kernel (stats = 1): rows per tile, and blocks one SM holds at once.
// Returns a cudaError_t code (0 = success; an error where no layout fits).
int kmeans_plan(int d, int k, int stats, int* tile_rows, int* blocks_per_sm) {
  const Layout l = layout(d, k, stats != 0);
  *tile_rows = kThreads * l.rows;
  return (int)(stats ? occupancy<true>(d, k, blocks_per_sm)
                     : occupancy<false>(d, k, blocks_per_sm));
}

// x (batch, n, d), ct (batch, d, k), c2 (batch, k) float32; idx (batch, n)
// int32 and dmin (batch, n) float32 outputs; contiguous, on the device.
// Blocks walk chunks of tiles_per_chunk tiles of 256 rows (128 where d is
// too wide for 256). Returns a cudaError_t code (0 = launched).
int kmeans_assign_launch(const float* x, const float* ct, const float* c2,
                         int* idx, float* dmin, int batch, int n, int d, int k,
                         int tiles_per_chunk, void* stream) {
  return (int)dispatch<false>(x, nullptr, ct, c2, idx, dmin, nullptr,
                              nullptr, batch, n, d, k, tiles_per_chunk,
                              stream);
}

// x (batch, n, d), w (batch, n), ct (batch, d, k), c2 (batch, k) float32;
// partial (batch, chunks, p) scratch with chunks = ceil(ceil(n / tile) /
// tiles_per_chunk), tile = 256 (128 where d is too wide for 256), and out
// (batch, p), p = k + k*d + 1, laid out as
// counts | sums | inertia; idx (batch, n) int32, or null when the labels are
// not wanted. Contiguous, on the device. Returns a cudaError_t code (0 =
// both passes launched).
int kmeans_sweep_launch(const float* x, const float* w, const float* ct,
                        const float* c2, int* idx, float* partial, float* out,
                        int batch, int n, int d, int k, int tiles_per_chunk,
                        void* stream) {
  return (int)dispatch<true>(x, w, ct, c2, idx, nullptr, partial, out, batch,
                             n, d, k, tiles_per_chunk, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
