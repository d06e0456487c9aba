// Diagonal-GMM log densities on Hopper (sm_90a): per component, and the
// mixture's log density of each row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm_logpdf.py::_logpdf_kernel
// (launched by gmm_logpdf_pallas, pallas_call at gmm_logpdf.py:53), and the
// row logsumexp that its scoring caller runs after it
// (src/repro/core/em.py::_log_prob_block).
//
//   lp[n, k]     = (x[n]*x[n]) . A[:, k] + x[n] . B[:, k] + c[k]
//   A = -1/2 var^-1, B = mu / var  (d, K);  c (K) folds the constants and log w.
//   gmm_logpdf:   out[n, k] = lp[n, k]                            (N, K)
//   gmm_log_prob: out[n] = m + log(sum_k exp(lp[n, k] - m)),
//                 m = max_k lp[n, k] (0 where that is infinite)   (N,)
//
// What bounds each entry on this card, at the main path's 60,000 x 24 x 30:
// * gmm_logpdf moves (d + K)*4 = 216 bytes a row for 4*d*K = 2,880 flops,
//   about 13 flop/byte, under the f32 CUDA-core ridge (67 TFLOP/s over
//   3.35 TB/s, about 20 flop/byte): bytes bound it, 3.87 us, most of them the
//   (N, K) store.
// * gmm_log_prob moves (d + 1)*4 = 100 bytes a row for the same flops,
//   about 29 flop/byte: the f32 operations bound it, 2.60 us. The (N, K)
//   matrix never reaches device memory, and no second launch reads it back.
//
// Design (one core, two epilogues):
// * Rows in registers. A block takes a tile of rows, staged into shared
//   memory by coalesced cp.async (tile_reduce.cuh): 256 rows (128 threads, 2
//   rows a thread, only where d <= 24), 128, 64 or 32 (1 row a thread), the
//   largest that still gives every SM a block, so that a small request is
//   spread over several SMs instead of queueing on one. Each thread holds its
//   rows' first DC dims (DC = 8, 16, 24 or 32 by d) and their squares in
//   registers; dims beyond 32 are read from the shared tile.
// * Panels in shared memory. A and B for all K are staged once per block as
//   (d, K) panels (fewer components at a time only where they do not fit),
//   by cp.async like the rows, so that a block waits for one memory latency
//   and not one a copy; they are read as float4 broadcasts: two shared loads
//   feed 4 components x 2 rows x 2 FMAs. Blocks tile rows only.
// * Each logit keeps the order of the plain version: one FMA chain over
//   j = 0..d-1 for the x*x term, one for the x term, then acc_a + acc_b + c.
//   Plain f32 FMAs, no TF32: the identity cancels large terms.
// * A row's result depends on that row and the model only: every tile shape
//   runs the same operations on a row in the same order, and the component
//   chunks depend on (d, K) only, so a row scores the same bits alone, in a
//   request or in a large call.
// * gmm_logpdf stages the block's (rows, K) output tile in shared memory and
//   writes it as one contiguous run of 16-byte stores.
// * gmm_log_prob keeps a row's logits in registers, 32 components at a time,
//   and returns torch.logsumexp's formula with the sum in component order,
//   expf/logf at full precision. Where K > 32 the chunks are merged in order
//   by rescaling the running sum to the new maximum. One float a row is
//   written, coalesced.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tile_reduce.cuh"

namespace {

using tile_reduce::ld4;

constexpr int kMaxThreads = 128;
constexpr int kChunk = 32;  // components a thread's log-prob holds at once
constexpr int kSmemLimit = 232448;
// tile shapes, largest first: (threads, rows a thread)
constexpr int kShapes[4][2] = {{128, 2}, {128, 1}, {64, 1}, {32, 1}};

struct Layout {
  int threads;  // threads per block
  int tr;       // rows per thread
  int rows;     // rows per tile: threads * tr
  int dc;       // dims of a row held in registers
  int cr;       // columns of the x tile and rows of the panels: max(dp, dc)
  int xs;       // shared row stride of the x tile
  int ks;       // components staged at once: K padded to 4, fewer where the
                // panels do not fit (multiples of 32, then 16, 8, 4)
  int os;       // shared row stride of the staged output tile (0: log-prob)
  size_t smem;
};

// The largest tile shape that gives each of the `sms` SMs a block (2 rows a
// thread only where d <= 24), smaller where shared memory needs it.
Layout layout(int n, int d, int k, bool log_prob, int sms) {
  Layout l;
  const int dp = (d + 3) & ~3;
  const int kp = (k + 3) & ~3;
  l.dc = dp <= 8 ? 8 : dp <= 16 ? 16 : dp <= 24 ? 24 : 32;
  l.cr = dp > l.dc ? dp : l.dc;
  l.xs = tile_reduce::row_stride(l.cr);
  int s = dp <= 24 ? 0 : 1;
  while (s < 3 && (n + kShapes[s][0] * kShapes[s][1] - 1) /
                          (kShapes[s][0] * kShapes[s][1]) < sms)
    ++s;
  for (;; ++s) {
    l.threads = kShapes[s][0];
    l.tr = kShapes[s][1];
    l.rows = l.threads * l.tr;
    for (l.ks = kp;;) {
      l.os = log_prob ? 0 : (l.ks | 1);
      l.smem = sizeof(float) * ((size_t)l.rows * l.xs + 2 * (size_t)l.cr * l.ks +
                                l.ks + (size_t)l.rows * l.os);
      if (l.smem <= kSmemLimit || l.ks == 4) break;
      l.ks = l.ks > kChunk ? (l.ks - 1) / kChunk * kChunk
                           : ((l.ks / 2) + 3) & ~3;
    }
    if (l.smem <= kSmemLimit || s == 3) break;
  }
  return l;
}

// SMs of the current device, read once per device.
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 1;
  return counts[dev];
}

// Start copying components [k0, k0 + kv) of A and B into (cr, ks) panels
// and of c into (ks), as one cp.async group, so that every copy is in flight
// at once; zeros past d and past kv, and c = -inf past kv.
// Warps walk the panels' rows and lanes their components, so no index is
// divided.
__device__ __forceinline__ void stage_panels(
    float* as, float* bs, float* cs, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c, int d, int k,
    int cr, int ks, int k0, int kv, int tid, int threads) {
  for (int j = tid >> 5; j < cr; j += threads >> 5) {
    for (int kl = tid & 31; kl < ks; kl += 32) {
      const int i = j * ks + kl;
      if (j < d && kl < kv) {
        const size_t g = (size_t)j * k + k0 + kl;
        tile_reduce::cp_async4(as + i, a + g);
        tile_reduce::cp_async4(bs + i, b + g);
      } else {
        as[i] = 0.f;
        bs[i] = 0.f;
      }
    }
  }
  for (int i = tid; i < ks; i += threads) {
    if (i < kv)
      tile_reduce::cp_async4(cs + i, c + k0 + i);
    else
      cs[i] = -INFINITY;
  }
  tile_reduce::cp_async_commit();
}

template <int DC, int TR, bool LOG_PROB>
__global__ void __launch_bounds__(kMaxThreads)
logpdf_kernel(const float* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ c,
              float* __restrict__ out, int n, int d, int k, int rows, int ks,
              int os, int vec_x, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) & ~3;
  const int cr = dp > DC ? dp : DC;
  const int xstride = tile_reduce::row_stride(cr);
  float* xs = smem;                   // rows * xstride
  float* as = xs + rows * xstride;    // cr * ks
  float* bs = as + cr * ks;           // cr * ks
  float* cs = bs + cr * ks;           // ks
  float* ot = cs + ks;                // rows * os (gmm_logpdf only)

  const int tid = threadIdx.x;
  const int threads = blockDim.x;  // rows = threads * TR
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, n - row0);

  tile_reduce::stage_rows(xs, x + (size_t)row0 * d, nrows, d, xstride, vec_x,
                          tid, threads);
  if (cr > d) {  // the tile's padding columns, never written by a copy
    const int pad = cr - d;
    for (int i = tid; i < rows * pad; i += threads) {
      const int r = i / pad;
      xs[r * xstride + d + (i - r * pad)] = 0.f;
    }
  }
  stage_panels(as, bs, cs, a, b, c, d, k, cr, ks, 0, min(ks, k), tid,
               threads);
  tile_reduce::cp_async_wait<0>();
  __syncthreads();

  // rows tid (and tid + threads) of the tile
  int rr[TR];
  float xr[TR][DC], x2[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    rr[i] = tid + i * threads;
    const float* src = xs + rr[i] * xstride;
#pragma unroll
    for (int q = 0; q < DC; q += 4) {
      const float4 v = ld4(src + q);
      xr[i][q] = v.x; xr[i][q + 1] = v.y; xr[i][q + 2] = v.z; xr[i][q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) x2[i][j] = xr[i][j] * xr[i][j];
  }

  float run_s[TR], run_m[TR], run_sh[TR];  // gmm_log_prob's running sums
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    run_s[i] = 0.f;
    run_m[i] = -INFINITY;
    run_sh[i] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += ks) {
    const int kv = min(ks, k - k0);
    const int kvp = (kv + 3) & ~3;
    if (k0 > 0) {  // the next components' panels, once the last are read
      __syncthreads();
      stage_panels(as, bs, cs, a, b, c, d, k, cr, ks, k0, kv, tid, threads);
      tile_reduce::cp_async_wait<0>();
      __syncthreads();
    }
    for (int base = 0; base < kvp; base += kChunk) {
      float lp[TR][kChunk];
#pragma unroll
      for (int g = 0; g < kChunk / 4; ++g) {
        const int k4 = base + 4 * g;
        if (k4 < kvp) {
          float sa[TR][4], sb[TR][4];
#pragma unroll
          for (int i = 0; i < TR; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) sa[i][q] = sb[i][q] = 0.f;
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            const float4 av = ld4(as + j * ks + k4);
            const float4 bv = ld4(bs + j * ks + k4);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              sa[i][0] = fmaf(x2[i][j], av.x, sa[i][0]);
              sa[i][1] = fmaf(x2[i][j], av.y, sa[i][1]);
              sa[i][2] = fmaf(x2[i][j], av.z, sa[i][2]);
              sa[i][3] = fmaf(x2[i][j], av.w, sa[i][3]);
              sb[i][0] = fmaf(xr[i][j], bv.x, sb[i][0]);
              sb[i][1] = fmaf(xr[i][j], bv.y, sb[i][1]);
              sb[i][2] = fmaf(xr[i][j], bv.z, sb[i][2]);
              sb[i][3] = fmaf(xr[i][j], bv.w, sb[i][3]);
            }
          }
          for (int j = DC; j < dp; ++j) {  // d > 32: the rest from shared memory
            const float4 av = ld4(as + j * ks + k4);
            const float4 bv = ld4(bs + j * ks + k4);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              const float xj = xs[rr[i] * xstride + j];
              const float xx = xj * xj;
              sa[i][0] = fmaf(xx, av.x, sa[i][0]);
              sa[i][1] = fmaf(xx, av.y, sa[i][1]);
              sa[i][2] = fmaf(xx, av.z, sa[i][2]);
              sa[i][3] = fmaf(xx, av.w, sa[i][3]);
              sb[i][0] = fmaf(xj, bv.x, sb[i][0]);
              sb[i][1] = fmaf(xj, bv.y, sb[i][1]);
              sb[i][2] = fmaf(xj, bv.z, sb[i][2]);
              sb[i][3] = fmaf(xj, bv.w, sb[i][3]);
            }
          }
          const float4 cv = ld4(cs + k4);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float v = sa[i][q] + sb[i][q] + tile_reduce::lane(cv, q);
              if (LOG_PROB)
                lp[i][4 * g + q] = v;
              else if (k4 + q < kv)
                ot[rr[i] * os + k4 + q] = v;
            }
          }
        }
      }
      if (LOG_PROB) {
        // merge this chunk's components, in order, into the running sum
        const int kc = min(kChunk, kv - base);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          float mc = -INFINITY;
#pragma unroll
          for (int q = 0; q < kChunk; ++q)
            if (q < kc) mc = fmaxf(mc, lp[i][q]);
          const float m = fmaxf(run_m[i], mc);
          const float sh = isinf(m) ? 0.f : m;  // torch.logsumexp's shift
          // __fmul_rn: never contracted with the next add, so every
          // instance of the kernel rounds the rescale alike
          float s = run_s[i];
          if (s != 0.f && sh != run_sh[i]) s = __fmul_rn(s, expf(run_sh[i] - sh));
#pragma unroll
          for (int q = 0; q < kChunk; ++q)
            if (q < kc) s += expf(lp[i][q] - sh);
          run_s[i] = s;
          run_m[i] = m;
          run_sh[i] = sh;
        }
      }
    }
    if (!LOG_PROB) {
      // the tile's outputs for components [k0, k0 + kv), coalesced
      __syncthreads();
      float* dst = out + (size_t)row0 * k + k0;
      if (vec_out && kv == k) {  // one contiguous run of nrows * k floats
        const int total = nrows * k;
        for (int e = 4 * tid; e < total; e += 4 * threads) {
          int r = e / k;
          int kl = e - r * k;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = e + q < total ? ot[r * os + kl] : 0.f;
            if (++kl == k) {
              kl = 0;
              ++r;
            }
          }
          if (e + 4 <= total) {
            *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (e + q < total) dst[e + q] = v[q];
          }
        }
      } else {
        for (int e = tid; e < nrows * kv; e += threads) {
          const int r = e / kv;
          const int kl = e - r * kv;
          dst[(size_t)r * k + kl] = ot[r * os + kl];
        }
      }
    }
  }

  if (LOG_PROB) {
#pragma unroll
    for (int i = 0; i < TR; ++i)
      if (rr[i] < nrows) out[row0 + rr[i]] = logf(run_s[i]) + run_sh[i];
  }
}

template <int DC, int TR, bool LOG_PROB>
cudaError_t launch(const float* x, const float* a, const float* b,
                   const float* c, float* out, int n, int d, int k,
                   const Layout& l, cudaStream_t st) {
  cudaError_t err =
      tile_reduce::allow_smem(logpdf_kernel<DC, TR, LOG_PROB>, l.smem);
  if (err != cudaSuccess) return err;
  const int vec_out = reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  logpdf_kernel<DC, TR, LOG_PROB>
      <<<(n + l.rows - 1) / l.rows, l.threads, l.smem, st>>>(
          x, a, b, c, out, n, d, k, l.rows, l.ks, l.os,
          tile_reduce::vector_rows(x, d), vec_out);
  return cudaGetLastError();
}

template <bool LOG_PROB>
cudaError_t dispatch(const float* x, const float* a, const float* b,
                     const float* c, float* out, int n, int d, int k,
                     void* stream) {
  if (n < 1 || d < 1 || k < 1) return cudaErrorInvalidValue;
  const Layout l = layout(n, d, k, LOG_PROB, sm_count());
  if (l.smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LOGPDF_LAUNCH(DC, TR) \
  launch<DC, TR, LOG_PROB>(x, a, b, c, out, n, d, k, l, st)
  if (l.tr == 2) {
    switch (l.dc) {
      case 8: return LOGPDF_LAUNCH(8, 2);
      case 16: return LOGPDF_LAUNCH(16, 2);
      default: return LOGPDF_LAUNCH(24, 2);
    }
  }
  switch (l.dc) {
    case 8: return LOGPDF_LAUNCH(8, 1);
    case 16: return LOGPDF_LAUNCH(16, 1);
    case 24: return LOGPDF_LAUNCH(24, 1);
    default: return LOGPDF_LAUNCH(32, 1);
  }
#undef LOGPDF_LAUNCH
}

}  // namespace

extern "C" {

// x (n, d), a/b (d, k), c (k), out (n, k): float32, contiguous, on the device.
// Returns a cudaError_t code (0 = launched).
int gmm_logpdf_launch(const float* x, const float* a, const float* b,
                      const float* c, float* out, int n, int d, int k,
                      void* stream) {
  return (int)dispatch<false>(x, a, b, c, out, n, d, k, stream);
}

// The same operands; out (n): the row's log density logsumexp_k lp[n, k].
// Returns a cudaError_t code (0 = launched).
int gmm_log_prob_launch(const float* x, const float* a, const float* b,
                        const float* c, float* out, int n, int d, int k,
                        void* stream) {
  return (int)dispatch<true>(x, a, b, c, out, n, d, k, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
