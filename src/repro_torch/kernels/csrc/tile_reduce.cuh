// Shared by the kernels that reduce rows into per-problem statistics
// (estep_stats.cu, kmeans_assign.cu): how rows are cut into chunks, how a
// chunk's row tiles are staged into shared memory, and the second pass that
// sums the chunks.
//
// Each problem's rows (a client, a k-means restart) are cut into row tiles,
// and consecutive tiles into chunks: one block per (chunk, problem). A block
// walks its chunk's tiles in order, staging the next tile with cp.async
// while it computes the current one, and keeps one partial per (problem,
// chunk) in device memory; every element of it has one owner thread, which
// adds the tile's rows in row order. The second pass sums each problem's
// partials in chunk order. No float atomics anywhere, so two launches on
// one input give the same bits. The chunk length (tiles per chunk) is
// chosen by the caller from the card's SM count and the kernel's occupancy,
// so that the grid fills the card once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tile_reduce {

constexpr unsigned kFullMask = 0xffffffffu;

// A shared-memory row stride (floats) for rows of `width` floats, width a
// multiple of 4: an odd multiple of 4, so that eight consecutive rows read
// as float4 at one column fall in eight distinct groups of four banks.
__host__ __device__ inline int row_stride(int width) {
  return (width & 7) ? width : width + 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Start copying `rows` rows of `d` floats (row-major, contiguous from `src`)
// into shared rows of `stride` floats at `dst`, as one commit group. `vec`:
// src is 16-byte aligned and d % 4 == 0, so whole float4s are copied.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int d, int stride,
                                           bool vec, int tid, int threads) {
  if (vec) {
    const int q = d >> 2;
    for (int i = tid; i < rows * q; i += threads) {
      const int r = i / q;
      const int c = i - r * q;
      cp_async16(dst + r * stride + 4 * c, src + (size_t)r * d + 4 * c);
    }
  } else {
    for (int i = tid; i < rows * d; i += threads) {
      const int r = i / d;
      cp_async4(dst + r * stride + (i - r * d), src + i);
    }
  }
  cp_async_commit();
}

// Whether whole float4 copies may be used for a (.., d) float32 operand.
inline int vector_rows(const float* x, int d) {
  return (d % 4 == 0) && (reinterpret_cast<std::uintptr_t>(x) % 16 == 0);
}

// Second pass: out[b, e] = sum over chunks c = 0, 1, ... (in that order) of
// partial[b, c, e].
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
              int chunks, int p_len) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= p_len) return;
  const float* src = partial + (size_t)b * chunks * p_len + e;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += src[(size_t)c * p_len];
  out[(size_t)b * p_len + e] = s;
}

inline cudaError_t reduce(const float* partial, float* out, int problems,
                          int chunks, int p_len, cudaStream_t stream) {
  reduce_kernel<<<dim3((p_len + 255) / 256, problems), 256, 0, stream>>>(
      partial, out, chunks, p_len);
  return cudaGetLastError();
}

// Allow `smem` bytes of dynamic shared memory for `kernel` (needed above
// 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Blocks of `kernel` one SM holds at once with `threads` threads and `smem`
// bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem,
                          int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       smem);
}

}  // namespace tile_reduce
