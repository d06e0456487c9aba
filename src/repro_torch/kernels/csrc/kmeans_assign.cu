// k-means assignment (nearest center and its squared distance) on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign.py::_assign_kernel
// (launched by kmeans_assign_pallas, pallas_call at kmeans_assign.py:38).
//
//   d2[n, k] = max(|x_n|^2 - 2 x_n . C_k + |C_k|^2, 0)
//   idx[n] = argmin_k d2 (first index on ties, as jnp.argmin), dmin[n] = min_k d2
//
// What bounds it: 2*d*K flops per row against (d + 2)*4 bytes, about
// 14 flop/byte at d = 24, K = 30: below the f32 CUDA-core ridge (about
// 20 flop/byte), so the bound is reading x. The kernel reads each row once
// and writes two scalars; the (N, K) distance matrix never exists.
//
// Design: a leading batch axis (grid.y) carries independent problems, so the
// k-means of every client (and every restart) is one launch per sweep. One
// block stages its problem's transposed centers, their squared norms and a
// 128-row x tile in shared memory (x rows padded to d + 1 floats so that the
// row-per-thread reads do not collide in one bank); above 48 KB the launcher
// raises the block's dynamic shared memory limit. One thread owns one row:
// |x|^2, then for each center the dot product, the clamped distance, and a
// strict `<` compare, which keeps the first index on ties.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows per block, one per thread

__global__ void __launch_bounds__(kRows)
assign_kernel(const float* __restrict__ x, const float* __restrict__ ct,
              const float* __restrict__ c2, int* __restrict__ idx,
              float* __restrict__ dmin, int n, int d, int k) {
  extern __shared__ float smem[];
  float* cts = smem;            // d * k
  float* c2s = cts + d * k;     // k
  float* xs = c2s + k;          // kRows * (d + 1)
  const int stride = d + 1;

  const int bi = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int rows = min(kRows, n - row0);
  const float* xb = x + (size_t)bi * n * d + (size_t)row0 * d;
  const float* ctb = ct + (size_t)bi * d * k;
  const float* c2b = c2 + (size_t)bi * k;

  for (int i = tid; i < d * k; i += kRows) cts[i] = ctb[i];
  for (int i = tid; i < k; i += kRows) c2s[i] = c2b[i];
  for (int i = tid; i < rows * d; i += kRows) {
    const int r = i / d;
    xs[r * stride + (i - r * d)] = xb[i];
  }
  __syncthreads();
  if (tid >= rows) return;

  const float* xr = xs + tid * stride;
  float x2 = 0.f;
  for (int j = 0; j < d; ++j) x2 = fmaf(xr[j], xr[j], x2);

  float best = 0.f;
  int best_k = 0;
  for (int kk = 0; kk < k; ++kk) {
    float dot = 0.f;
    for (int j = 0; j < d; ++j) dot = fmaf(xr[j], cts[j * k + kk], dot);
    const float d2 = fmaxf(x2 - 2.f * dot + c2s[kk], 0.f);
    if (kk == 0 || d2 < best) {
      best = d2;
      best_k = kk;
    }
  }
  const size_t out = (size_t)bi * n + row0 + tid;
  idx[out] = best_k;
  dmin[out] = best;
}

}  // namespace

extern "C" {

// x (batch, n, d), ct (batch, d, k), c2 (batch, k) float32; idx (batch, n)
// int32 and dmin (batch, n) float32 outputs; contiguous, on the device.
// Returns a cudaError_t code (0 = launched).
int kmeans_assign_launch(const float* x, const float* ct, const float* c2,
                         int* idx, float* dmin, int batch, int n, int d, int k,
                         void* stream) {
  const size_t smem = (size_t)(d * k + k + kRows * (d + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + kRows - 1) / kRows, batch);
  assign_kernel<<<grid, kRows, smem, (cudaStream_t)stream>>>(x, ct, c2, idx,
                                                             dmin, n, d, k);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
