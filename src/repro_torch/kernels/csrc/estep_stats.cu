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
// operations, and the design keeps every operand in shared memory.
//
// Design:
// * The TPU kernel adds into its output across grid steps, which is safe
//   only because a TPU grid runs in order. CUDA blocks run concurrently, so
//   pass 1 writes one partial (s0 | s1 | s2 | ll) per (client, row tile) to
//   scratch, and pass 2 sums the partials of each client in tile order.
// * Inside a block every output element (k, j) is owned by one thread that
//   walks the tile's rows in order, and ll is summed by one thread. No float
//   atomics anywhere, so two launches on one input give the same bits.
// * Grid (row tiles, clients): a batch of local fits is one launch per EM
//   iteration; the server refit is the same kernel with one client.
// * Shared memory holds the client's A, B, c, the x tile, its weights and the
//   (rows, K) logits, which become the responsibilities in place. The tile's
//   row count is chosen by the caller from d and K; above 48 KB the launcher
//   raises the block's dynamic shared memory limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
estep_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c, float* __restrict__ partial,
                     int n, int d, int k, int bn) {
  extern __shared__ float smem[];
  float* as = smem;              // d * k
  float* bs = as + d * k;        // d * k
  float* cs = bs + d * k;        // k
  float* xs = cs + k;            // bn * d
  float* ws = xs + bn * d;       // bn
  float* lp = ws + bn;           // bn * k: logits, then responsibilities
  float* lw = lp + bn * k;       // bn: w * log_norm

  const int tile = blockIdx.x;
  const int cl = blockIdx.y;
  const int tid = threadIdx.x;
  const int row0 = tile * bn;
  const int rows = min(bn, n - row0);

  const float* xc = x + (size_t)cl * n * d;
  const float* wc = w + (size_t)cl * n;
  const float* ac = a + (size_t)cl * d * k;
  const float* bc = b + (size_t)cl * d * k;
  const float* cc = c + (size_t)cl * k;

  for (int i = tid; i < d * k; i += kThreads) {
    as[i] = ac[i];
    bs[i] = bc[i];
  }
  for (int i = tid; i < k; i += kThreads) cs[i] = cc[i];
  for (int i = tid; i < rows * d; i += kThreads) xs[i] = xc[(size_t)row0 * d + i];
  for (int i = tid; i < rows; i += kThreads) ws[i] = wc[row0 + i];
  __syncthreads();

  // 1. logits, (x*x).A and x.B accumulated apart as in the plain version
  for (int i = tid; i < rows * k; i += kThreads) {
    const int r = i / k;
    const int kk = i - r * k;
    const float* xr = xs + r * d;
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < d; ++j) {
      const float xv = xr[j];
      sa = fmaf(xv * xv, as[j * k + kk], sa);
      sb = fmaf(xv, bs[j * k + kk], sb);
    }
    lp[i] = sa + sb + cs[kk];
  }
  __syncthreads();

  // 2. row softmax: one thread per row
  for (int r = tid; r < rows; r += kThreads) {
    float* l = lp + r * k;
    float m = l[0];
    for (int kk = 1; kk < k; ++kk) m = fmaxf(m, l[kk]);
    float s = 0.f;
    for (int kk = 0; kk < k; ++kk) {
      const float p = expf(l[kk] - m);
      l[kk] = p;
      s += p;
    }
    const float wr = ws[r];
    for (int kk = 0; kk < k; ++kk) l[kk] = (l[kk] / s) * wr;
    lw[r] = (m + logf(s)) * wr;
  }
  __syncthreads();

  // 3. reductions over the tile's rows, each output owned by one thread
  const int p_len = k + 2 * k * d + 1;
  float* part = partial + ((size_t)cl * gridDim.x + tile) * p_len;
  for (int e = tid; e < k; e += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += lp[r * k + e];
    part[e] = s;
  }
  for (int e = tid; e < k * d; e += kThreads) {
    const int kk = e / d;
    const int j = e - kk * d;
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float rv = lp[r * k + kk];
      const float xv = xs[r * d + j];
      s1 = fmaf(rv, xv, s1);
      s2 = fmaf(rv, xv * xv, s2);
    }
    part[k + e] = s1;
    part[k + k * d + e] = s2;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += lw[r];
    part[k + 2 * k * d] = s;
  }
}

// Pass 2: out[c, e] = sum over tiles t, in order, of partial[c, t, e].
__global__ void __launch_bounds__(kThreads)
estep_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int tiles, int p_len) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int cl = blockIdx.y;
  if (e >= p_len) return;
  const float* src = partial + (size_t)cl * tiles * p_len + e;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += src[(size_t)t * p_len];
  out[(size_t)cl * p_len + e] = s;
}

}  // namespace

extern "C" {

// x (clients, n, d), w (clients, n), a/b (clients, d, k), c (clients, k);
// partial (clients, ceil(n / bn), p) scratch and out (clients, p) with
// p = k + 2*k*d + 1 laid out as s0 | s1 | s2 | ll. float32, contiguous, on
// the device. Returns a cudaError_t code (0 = both passes launched).
int estep_stats_launch(const float* x, const float* w, const float* a,
                       const float* b, const float* c, float* partial,
                       float* out, int clients, int n, int d, int k, int bn,
                       void* stream) {
  const int tiles = (n + bn - 1) / bn;
  const int p_len = k + 2 * k * d + 1;
  const size_t smem =
      (size_t)(2 * d * k + k + bn * d + bn + bn * k + bn) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        estep_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  estep_partial_kernel<<<dim3(tiles, clients), kThreads, smem, st>>>(
      x, w, a, b, c, partial, n, d, k, bn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  estep_reduce_kernel<<<dim3((p_len + kThreads - 1) / kThreads, clients),
                        kThreads, 0, st>>>(partial, out, tiles, p_len);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
