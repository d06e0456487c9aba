// Fused EM E-step sufficient statistics on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/estep_stats.py::_estep_kernel
// (launched by estep_stats_pallas, pallas_call at estep_stats.py:68).
//
// Per client c and row n (weight w[c, n], 0 on padded rows):
//   lp[n, k]    = (x*x) . A[:, k] + x . B[:, k] + c[k]
//   log_norm[n] = max_k lp + log sum_k exp(lp - max)
//   resp[n, k]  = exp(lp - max) / sum * w[n]
//   s0 = sum_n resp, s1 = resp^T x, s2 = resp^T (x*x), ll = sum_n w log_norm.
// The (N, K) responsibilities never leave shared memory.
//
// What bounds it: 8*d*K flops per row (two contractions in, two out) against
// (d + 1)*4 bytes read, about 58 flop/byte at d = 24, K = 30. That is above
// the f32 CUDA-core ridge (about 20 flop/byte), so the bound is the f32
// operations, and the design feeds the FMA units from registers:
//
// * Logits as a register-blocked product. The block's 256 threads cover a
//   tile of 64 rows (fewer where d is too wide for two 64-row buffers);
//   `lanes` neighbouring lanes of a warp share a row, each holding KT (4, or
//   16 when K > 128) components of kRowsPerThread rows in registers. x comes
//   from shared memory as float4, A and B as float4 broadcasts: about 2.5
//   shared loads feed 18 FMAs. K is padded inside the block to lanes * KT
//   with A = B = 0 and c = -inf, so the padded components get zero
//   responsibility.
// * Softmax by the lanes that hold a row: the max by __shfl_xor_sync
//   butterflies, the sum by a chain through the row's lanes in component
//   order (a shuffle per lane). The division p / sum is Markstein's
//   correction with the correctly rounded reciprocal, which rounds as IEEE
//   division does wherever the quotient is a normal float (so a
//   responsibility can differ by an ulp only below 2^-126); the IEEE
//   division's range check and slow path took a quarter of the kernel's
//   time, since many responsibilities underflow.
// * Statistics: each (k, 4 consecutive j) output of s1 and s2, each s0[k]
//   and ll have one owner thread, which walks the tile's rows in row order
//   (2 shared loads per 8 FMAs for s1/s2).
// * Summation order, kept from the one-thread-per-output design this kernel
//   replaced, because the fused and reference EM are held to 1e-4 apart in
//   final log-likelihood and the local fits sit close to that bound
//   (chip_smoke.py phase 4): each partial covers a chunk of 256 rows, which
//   its owners sum from zero in row order across the chunk's tiles, and the
//   second pass of tile_reduce.cuh sums the chunks in order; the softmax
//   sums components in order; each logit is one FMA chain over j ascending,
//   (x*x)*A and x*B accumulated apart, then sa + sb + c. No float atomics,
//   so two launches give the same bits.
// * Grid (chunks, clients): 580 blocks at 20 x 7,320 rows; the refit's
//   1 x 30,000 rows are 118 chunks, one block per SM. A block walks its
//   chunk's tiles and stages the next x tile with 16-byte cp.async into a
//   second buffer while it computes the current one (tile_reduce.cuh).

#include <cuda_runtime.h>

#include <cmath>

#include "tile_reduce.cuh"

namespace {

using tile_reduce::kFullMask;
using tile_reduce::ld4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileRows = 64;
constexpr int kChunkRows = 256;
constexpr int kRowsPerThread = 2;
constexpr int kSmemLimit = 232448;

struct Layout {
  int kt;     // components per thread: 4, or 16 when K > 128
  int lanes;  // lanes sharing a row: a power of two, lanes * kt >= K
  int kp;     // K padded to lanes * kt
  int dp;     // d padded to a multiple of 4
  int xs;     // shared row stride of the x tile
  int rows;   // rows per tile: 64, halved (to 8 at least) until it fits;
              // a chunk is kChunkRows / rows tiles
  size_t smem;
};

Layout layout(int d, int k) {
  Layout l;
  l.kt = k <= 128 ? 4 : 16;
  l.lanes = 1;
  while (l.lanes * l.kt < k) l.lanes <<= 1;
  l.kp = l.lanes * l.kt;
  l.dp = (d + 3) & ~3;
  l.xs = tile_reduce::row_stride(l.dp);
  for (l.rows = kMaxTileRows;; l.rows /= 2) {
    l.smem = sizeof(float) * (size_t)(2 * l.dp * l.kp + l.kp +
                                      2 * l.rows * l.xs + l.rows * l.kp +
                                      3 * l.rows);
    if (l.smem <= kSmemLimit || l.rows == 8) break;
  }
  return l;
}

// RN(p / s) for s >= 1 and rcp = RN(1 / s): q0 = RN(p * rcp), then one
// correction with the exact residual p - q0 * s (Markstein), correctly
// rounded when no step underflows.
__device__ __forceinline__ float quotient(float p, float s, float rcp) {
  const float q0 = p * rcp;
  return fmaf(fmaf(-q0, s, p), rcp, q0);
}

template <int KT>
__global__ void __launch_bounds__(kThreads)
estep_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ partial, int n,
             int d, int k, int lanes, int tile_rows, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int kp = lanes * KT;
  const int dp = (d + 3) & ~3;
  const int xstride = tile_reduce::row_stride(dp);
  float* as = smem;                          // dp * kp
  float* bs = as + dp * kp;                  // dp * kp
  float* cs = bs + dp * kp;                  // kp
  float* xbuf = cs + kp;                     // 2 * tile_rows * xstride
  float* rs = xbuf + 2 * tile_rows * xstride;  // tile_rows * kp
  float* lw = rs + tile_rows * kp;           // tile_rows: w * log_norm
  float* wbuf = lw + tile_rows;              // 2 * tile_rows: row weights

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cl = blockIdx.y;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const int tiles_per_chunk = kChunkRows / tile_rows;
  const int t_begin = blockIdx.x * tiles_per_chunk;
  const int t_end = min(t_begin + tiles_per_chunk, tiles);
  const int p_len = k + 2 * k * d + 1;
  float* part = partial + ((size_t)cl * gridDim.x + blockIdx.x) * p_len;

  const float* xc = x + (size_t)cl * n * d;
  const float* wc = w + (size_t)cl * n;
  const float* ac = a + (size_t)cl * d * k;
  const float* bc = b + (size_t)cl * d * k;
  const float* cc = c + (size_t)cl * k;

  // the first tile's copy starts before the parameters are staged
  tile_reduce::stage_rows(wbuf, wc + (size_t)t_begin * tile_rows,
                          min(tile_rows, n - t_begin * tile_rows), 1, 1, false,
                          tid, kThreads);
  tile_reduce::stage_rows(xbuf, xc + (size_t)t_begin * tile_rows * d,
                          min(tile_rows, n - t_begin * tile_rows), d, xstride,
                          vec, tid, kThreads);
  for (int i = tid; i < dp * kp; i += kThreads) {
    const int j = i / kp;
    const int kk = i - j * kp;
    const bool in = j < d && kk < k;
    as[i] = in ? ac[j * k + kk] : 0.f;
    bs[i] = in ? bc[j * k + kk] : 0.f;
  }
  for (int i = tid; i < kp; i += kThreads) cs[i] = i < k ? cc[i] : -INFINITY;
  if (dp > d) {  // the x tiles' padding columns, never written by a copy
    const int pad = dp - d;
    for (int i = tid; i < 2 * tile_rows * pad; i += kThreads) {
      const int r = i / pad;
      xbuf[r * xstride + d + (i - r * pad)] = 0.f;
    }
  }

  // lanes [g + lanes * rg] of a warp: component group g, row group rg
  const int g = lane & (lanes - 1);
  const int rg = lane / lanes;
  const int groups = 32 / lanes;
  const int pass_rows = kWarps * groups * kRowsPerThread;
  const int k0 = g * KT;
  const int dg = dp >> 2;

  for (int t = t_begin; t < t_end; ++t) {
    const bool first = t == t_begin;
    float* xs = xbuf + ((t - t_begin) & 1) * tile_rows * xstride;
    const float* ws = wbuf + ((t - t_begin) & 1) * tile_rows;
    if (t + 1 < t_end) {
      const int nb = (t + 1 - t_begin) & 1;
      const int nrows = min(tile_rows, n - (t + 1) * tile_rows);
      tile_reduce::stage_rows(wbuf + nb * tile_rows,
                              wc + (size_t)(t + 1) * tile_rows, nrows, 1, 1,
                              false, tid, kThreads);
      tile_reduce::stage_rows(xbuf + nb * tile_rows * xstride,
                              xc + (size_t)(t + 1) * tile_rows * d, nrows, d,
                              xstride, vec, tid, kThreads);
      tile_reduce::cp_async_wait<2>();
    } else {
      tile_reduce::cp_async_wait<0>();
    }
    __syncthreads();
    const int row0 = t * tile_rows;
    const int rows = min(tile_rows, n - row0);

    for (int pass = 0; pass < tile_rows; pass += pass_rows) {
      int row[kRowsPerThread];
      const float* xr[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        row[i] = pass + (warp * kRowsPerThread + i) * groups + rg;
        xr[i] = xs + min(row[i], tile_rows - 1) * xstride;
      }
      // 1. logits
      float sa[kRowsPerThread][KT], sb[kRowsPerThread][KT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q = 0; q < KT; ++q) sa[i][q] = sb[i][q] = 0.f;
      for (int j = 0; j < dp; j += 4) {
        float4 xv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) xv[i] = ld4(xr[i] + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* arow = as + (j + jj) * kp + k0;
          const float* brow = bs + (j + jj) * kp + k0;
          float av[KT], bv[KT];
#pragma unroll
          for (int q = 0; q < KT; q += 4) {
            const float4 a4 = ld4(arow + q);
            const float4 b4 = ld4(brow + q);
            av[q] = a4.x; av[q + 1] = a4.y; av[q + 2] = a4.z; av[q + 3] = a4.w;
            bv[q] = b4.x; bv[q + 1] = b4.y; bv[q + 2] = b4.z; bv[q + 3] = b4.w;
          }
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float xj = tile_reduce::lane(xv[i], jj);
            const float xx = xj * xj;
#pragma unroll
            for (int q = 0; q < KT; ++q) {
              sa[i][q] = fmaf(xx, av[q], sa[i][q]);
              sb[i][q] = fmaf(xj, bv[q], sb[i][q]);
            }
          }
        }
      }
      // 2. softmax over the row's lanes, responsibilities into shared memory
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const bool valid = row[i] < rows;
        float lg[KT];
#pragma unroll
        for (int q = 0; q < KT; ++q) lg[q] = sa[i][q] + sb[i][q] + cs[k0 + q];
        float m = lg[0];
#pragma unroll
        for (int q = 1; q < KT; ++q) m = fmaxf(m, lg[q]);
        for (int off = 1; off < lanes; off <<= 1)
          m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
#pragma unroll
        for (int q = 0; q < KT; ++q) lg[q] = expf(lg[q] - m);
        // the sum in component order: lane g adds its KT terms, then passes
        // the running sum on to lane g + 1 of the row
        float s = 0.f;
        for (int src = 0; src < lanes; ++src) {
          if (g == src) {
#pragma unroll
            for (int q = 0; q < KT; ++q) s += lg[q];
          }
          s = __shfl_sync(kFullMask, s, (lane & ~(lanes - 1)) + src);
        }
        const float wr = valid ? ws[row[i]] : 0.f;
        const float rcp = __frcp_rn(s);
#pragma unroll
        for (int q = 0; q < KT; ++q) lg[q] = quotient(lg[q], s, rcp) * wr;
        if (valid) {
          float* dst = rs + row[i] * kp + k0;
#pragma unroll
          for (int q = 0; q < KT; q += 4)
            *reinterpret_cast<float4*>(dst + q) =
                make_float4(lg[q], lg[q + 1], lg[q + 2], lg[q + 3]);
          if (g == 0) lw[row[i]] = (m + logf(s)) * wr;
        }
      }
    }
    __syncthreads();
    // 3. the tile's rows added to the chunk's partial, each output by its
    // owner in row order: s1/s2 (k, 4 dims), then s0[k], then ll
    for (int e = tid; e < k * dg + k + 1; e += kThreads) {
      if (e >= k * dg) {  // s0[e - k * dg], or ll at the end
        const int kk = e - k * dg;
        float* dst = part + (kk < k ? kk : p_len - 1);
        float v = first ? 0.f : *dst;
        if (kk < k) {
          for (int r = 0; r < rows; ++r) v += rs[r * kp + kk];
        } else {
          for (int r = 0; r < rows; ++r) v += lw[r];
        }
        *dst = v;
        continue;
      }
      const int kk = e / dg;
      const int j0 = 4 * (e - kk * dg);
      float* p1 = part + k + kk * d + j0;
      float* p2 = p1 + k * d;
      float s1[4], s2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = !first && j0 + q < d;
        s1[q] = in ? p1[q] : 0.f;
        s2[q] = in ? p2[q] : 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const float rv = rs[r * kp + kk];
        const float4 xv = ld4(xs + r * xstride + j0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xj = tile_reduce::lane(xv, q);
          s1[q] = fmaf(rv, xj, s1[q]);
          s2[q] = fmaf(rv, xj * xj, s2[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j0 + q < d) {
          p1[q] = s1[q];
          p2[q] = s2[q];
        }
      }
    }
    __syncthreads();  // before the next tile's copy and responsibilities
  }
}

template <int KT>
cudaError_t launch(const float* x, const float* w, const float* a,
                   const float* b, const float* c, float* partial, float* out,
                   int clients, int n, int d, int k, const Layout& l,
                   cudaStream_t st) {
  cudaError_t err = tile_reduce::allow_smem(estep_kernel<KT>, l.smem);
  if (err != cudaSuccess) return err;
  const int chunks = (n + kChunkRows - 1) / kChunkRows;
  estep_kernel<KT><<<dim3(chunks, clients), kThreads, l.smem, st>>>(
      x, w, a, b, c, partial, n, d, k, l.lanes, l.rows,
      tile_reduce::vector_rows(x, d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return tile_reduce::reduce(partial, out, clients, chunks,
                             k + 2 * k * d + 1, st);
}

}  // namespace

extern "C" {

// x (clients, n, d), w (clients, n), a/b (clients, d, k), c (clients, k);
// partial (clients, ceil(n / 256), p) scratch and out (clients, p) with
// p = k + 2*k*d + 1 laid out as s0 | s1 | s2 | ll. float32, contiguous, on
// the device; 1 <= k <= 512. Returns a cudaError_t code (0 = both passes
// launched).
int estep_stats_launch(const float* x, const float* w, const float* a,
                       const float* b, const float* c, float* partial,
                       float* out, int clients, int n, int d, int k,
                       void* stream) {
  if (k < 1 || k > 512) return (int)cudaErrorInvalidValue;
  const Layout l = layout(d, k);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(l.kt == 4 ? launch<4>(x, w, a, b, c, partial, out, clients, n,
                                     d, k, l, st)
                         : launch<16>(x, w, a, b, c, partial, out, clients, n,
                                      d, k, l, st));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
