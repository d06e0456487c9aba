// Diagonal-GMM per-component log densities on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmm_logpdf.py::_logpdf_kernel
// (launched by gmm_logpdf_pallas, pallas_call at gmm_logpdf.py:53).
//
//   out[n, k] = (x[n]*x[n]) . A[:, k] + x[n] . B[:, k] + c[k]
//   A = -1/2 var^-1, B = mu / var  (d, K);  c (K) folds the constants and log w.
//
// What bounds it: at the main-path shapes (d = 24, K = 30) each row costs
// 4*d*K = 2880 flops against (d + K)*4 = 216 bytes read and written, about
// 13 flop/byte: below the card's f32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s, about 20 flop/byte), so the bound is the bytes, mostly the
// (N, K) output. The kernel reads x once, writes each output once, and keeps
// every operand of the inner loop in registers or shared memory so that the
// arithmetic stays under the memory time.
//
// Design: one block computes a 32-row x 32-component output tile. The x tile
// and the (d, 32) panels of A and B are staged in shared memory (sized from
// d at launch; above 48 KB the launcher raises the block's dynamic shared
// memory limit, and the K axis is tiled over grid.y so the panels never grow
// with K). Each warp owns 4 rows and each lane one component: per step of the
// d loop a lane reads one A and one B value, the four x values are warp
// broadcasts, x is squared in registers, and 8 FMAs follow. The two
// contractions are accumulated separately and summed at the end, in the
// order of the plain version. Writes along K are coalesced. Plain f32 FMAs:
// no TF32, because the identity cancels large terms.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                       // rows of x per block
constexpr int kCols = 32;                       // components per block
constexpr int kThreads = 256;                   // 8 warps
constexpr int kRowStep = kThreads / kCols;      // 8: rows r0, r0 + 8, ...
constexpr int kRowsPerThread = kRows / kRowStep;  // 4

__global__ void __launch_bounds__(kThreads)
logpdf_kernel(const float* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ c,
              float* __restrict__ out, int n, int d, int k) {
  extern __shared__ float smem[];
  float* xs = smem;                 // kRows * d
  float* as = xs + kRows * d;       // d * kCols
  float* bs = as + d * kCols;       // d * kCols

  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    xs[i] = (row0 + r < n) ? x[(size_t)row0 * d + i] : 0.f;
  }
  for (int i = tid; i < d * kCols; i += kThreads) {
    const int j = i / kCols;
    const int col = col0 + (i - j * kCols);
    const bool ok = col < k;
    as[i] = ok ? a[(size_t)j * k + col] : 0.f;
    bs[i] = ok ? b[(size_t)j * k + col] : 0.f;
  }
  __syncthreads();

  const int kk = tid % kCols;
  const int r0 = tid / kCols;
  float acc_a[kRowsPerThread];
  float acc_b[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    acc_a[i] = 0.f;
    acc_b[i] = 0.f;
  }
  for (int j = 0; j < d; ++j) {
    const float av = as[j * kCols + kk];
    const float bv = bs[j * kCols + kk];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float xv = xs[(r0 + i * kRowStep) * d + j];
      acc_a[i] = fmaf(xv * xv, av, acc_a[i]);
      acc_b[i] = fmaf(xv, bv, acc_b[i]);
    }
  }

  const int col = col0 + kk;
  if (col >= k) return;
  const float cv = c[col];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + r0 + i * kRowStep;
    if (row < n) out[(size_t)row * k + col] = acc_a[i] + acc_b[i] + cv;
  }
}

}  // namespace

extern "C" {

// x (n, d), a/b (d, k), c (k), out (n, k): float32, contiguous, on the device.
// Returns a cudaError_t code (0 = launched).
int gmm_logpdf_launch(const float* x, const float* a, const float* b,
                      const float* c, float* out, int n, int d, int k,
                      void* stream) {
  const size_t smem = (size_t)(kRows * d + 2 * d * kCols) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        logpdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + kRows - 1) / kRows, (k + kCols - 1) / kCols);
  logpdf_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, a, b, c,
                                                                out, n, d, k);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
