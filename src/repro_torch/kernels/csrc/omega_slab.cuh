// What the two sketch GEMMs of the port share (sketch_kernels.cu `sketch_fwd`,
// sketch_t_kernels.cu `sketch_t`): the kernel that draws a call's Omega slab
// once into an f32 scratch, the ordered split-K reduce, and the copy and
// conversion helpers of their mainloops.
//
//   omega_slab_draw_kernel — S[k][i] = Omega[row0 + k, col0 + i] for k < K,
//       i < cols, and 0 in the pad columns cols <= i < ld (ld = cols
//       rounded up to 4, so every row starts 16 bytes apart).  The entries
//       are `omega_entry` at the same global coordinates as gen_omega
//       (row0 + k and col0 + i wrap at 2^32), so they are its bits.
//   split_reduce_kernel — out = acc? + (sum of the splits' partial sums,
//       added in split order), rounded once to out's type.  No atomics:
//       the bits depend on the split count alone.
//
// Everything here has internal linkage: each source that includes it
// compiles its own copy of these kernels (no relocatable device code).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace repro_torch {
namespace {

struct DrawArgs {
  PhiloxKey key;
  uint32_t row0, col0, salt;
  int kind;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy 16 (or 4) bytes from global to shared memory; with valid == false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(256)
    omega_slab_draw_kernel(float* __restrict__ S, int K, int cols, int ld,
                           DrawArgs om) {
  const long long total = static_cast<long long>(K) * ld;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += stride) {
    const int k = static_cast<int>(e / ld);
    const int i = static_cast<int>(e - static_cast<long long>(k) * ld);
    S[e] = i < cols ? omega_entry(om.key, om.row0 + static_cast<uint32_t>(k),
                                  om.col0 + static_cast<uint32_t>(i),
                                  om.salt, om.kind, om.scale)
                    : 0.0f;
  }
}

// Draw the K x ld slab (ld = cols rounded up to 4) into S; returns the
// launch's error.
inline cudaError_t draw_omega_slab(float* S, int K, int cols, int ld,
                                   DrawArgs om, cudaStream_t stream) {
  const long long total = static_cast<long long>(K) * ld;
  if (total <= 0) return cudaSuccess;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  omega_slab_draw_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      S, K, cols, ld, om);
  return cudaGetLastError();
}

template <typename TO>
__global__ void __launch_bounds__(256)
    split_reduce_kernel(const float* __restrict__ work, const TO* acc,
                        TO* out, long long mn, int splits) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float dot = 0.0f;
  for (int s = 0; s < splits; ++s) dot += work[s * mn + idx];
  float v = dot;
  if (acc != nullptr) v = to_f32(acc[idx]) + v;
  store(out + idx, v);
}

// out (mn elements) = acc? + the ordered sum of work[0..splits); returns
// the launch's error.
template <typename TO>
cudaError_t reduce_splits(const float* work, const void* acc, void* out,
                          long long mn, int splits, cudaStream_t stream) {
  split_reduce_kernel<TO><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                            stream>>>(work, static_cast<const TO*>(acc),
                                      static_cast<TO*>(out), mn, splits);
  return cudaGetLastError();
}

inline bool misaligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// cudaFuncGetAttributes' sharedSizeBytes of `kernel` into *bytes: the
// static shared memory a block takes, for the planner's fit
// (kernel_smem_bytes in kernels/sketch_matmul.py).
template <typename F>
cudaError_t static_smem(F kernel, int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

}  // namespace
}  // namespace repro_torch
