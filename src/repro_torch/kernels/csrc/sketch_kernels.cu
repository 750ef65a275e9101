// The fused sketch kernels of the port, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_gen_omega  — K8: a materialized Omega tile at global (row0, col0).
//                   Replaces src/repro/kernels/sketch_matmul.py
//                   `gen_omega_pallas`.  Bound by integer work: three
//                   Philox-4x32-10 calls per normal entry.
//   rt_sketch_fwd — K2/K6: out = acc? + A · Omega[row0:row0+K, col0:col0+n].
//                   Replaces src/repro/kernels/local.py `_sketch_block_pallas`
//                   and src/repro/kernels/sketch_matmul.py
//                   `sketch_matmul_pallas`.
//
// K3/K7 (`rt_sketch_t`, Omega^T · B) is in sketch_t_kernels.cu.
//
// Design of the forward GEMM: a block owns a BM x BN output
// tile and walks the contraction in BK steps.  At each step its threads
// stage the data operand (upcast to f32) and GENERATE the Omega tile into
// shared memory, so Omega never touches device memory, then each thread
// accumulates a TM x TN register tile with fmaf in a fixed k order.  There
// is no split-k, so every output element is the same sequential f32 sum
// whatever the grid: a streamed row of Y has the bits of the same row of a
// one-shot sketch.  The epilogue is `acc + dot` (the association of the
// reference's jnp body), rounded once to the output type.  `acc` may alias
// `out`: each element is read and then written by one thread.
//
// What bounds it on this card: the TPU design regenerates the Omega tile
// for every row tile of the data operand, i.e. (m/BM)·K·n·3 Philox calls of
// ~100 integer instructions for `normal`, against 2·m·K·n FMA flops; at
// Hopper's INT32:FP32 issue ratio of 1:2 the Philox work is several times
// the FMA work, so the kernel is integer-bound, not FMA-bound.  Amortizing
// each Omega tile over many row tiles is the next step, not this one.
//
// Numerics: IEEE f32 throughout; no TF32 and no bf16 tensor cores (a bf16
// wgmma would quantize Omega).  Each entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace repro_torch {

struct OmegaArgs {
  PhiloxKey key;
  uint32_t row0, col0, salt;
  int kind;
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__global__ void gen_omega_kernel(float* __restrict__ out, int rows, int cols,
                                 OmegaArgs om) {
  const long long total = static_cast<long long>(rows) * cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < total; e += stride) {
    const uint32_t i = static_cast<uint32_t>(e / cols);
    const uint32_t j = static_cast<uint32_t>(e % cols);
    out[e] = omega_entry(om.key, om.row0 + i, om.col0 + j, om.salt, om.kind,
                         om.scale);
  }
}

// out(m, n) = acc? + X(m, K) · Omega[row0+k, col0+j], X = A row-major
template <int BM, int BN, int BK, int TM, int TN, typename TI, typename TO>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    sketch_gemm_kernel(const TI* __restrict__ X, const TO* acc, TO* out, int m,
                       int n, int K, OmegaArgs om) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  __shared__ float sL[BK][BM + 4];
  __shared__ float sR[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int bm0 = blockIdx.x * BM;
  const int bn0 = blockIdx.y * BN;

  float sum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) sum[i][j] = 0.0f;

  for (int kt = 0; kt < K; kt += BK) {
    const int kmax = min(BK, K - kt);
    for (int e = tid; e < BM * BK; e += kThreads) {
      float v = 0.0f;
      const int row = e / BK, kk = e % BK;
      if (bm0 + row < m && kk < kmax)
        v = to_f32(X[static_cast<long long>(bm0 + row) * K + kt + kk]);
      sL[kk][row] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, j = e % BN;
      float v = 0.0f;
      if (bn0 + j < n && kk < kmax)
        v = omega_entry(om.key, om.row0 + static_cast<uint32_t>(kt + kk),
                        om.col0 + static_cast<uint32_t>(bn0 + j), om.salt,
                        om.kind, om.scale);
      sR[kk][j] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sL[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sR[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sum[i][j] = fmaf(a[i], b[j], sum[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = bm0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = bn0 + tx * TN + j;
      if (c >= n) continue;
      const long long idx = static_cast<long long>(r) * n + c;
      float v = sum[i][j];
      if (acc != nullptr) v = to_f32(acc[idx]) + v;
      out[idx] = from_f32<TO>(v);
    }
  }
}

// Tile shape: 256 threads, tall row tiles (each generated Omega tile serves
// BM = 128 rows of A).
constexpr int kFwdBM = 128, kFwdBN = 64, kFwdBK = 16, kFwdTM = 8, kFwdTN = 4;

template <int BM, int BN, int BK, int TM, int TN, typename TI, typename TO>
void launch_gemm(const void* X, const void* acc, void* out, int m, int n,
                 int K, OmegaArgs om, cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  sketch_gemm_kernel<BM, BN, BK, TM, TN, TI, TO>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const TI*>(X), static_cast<const TO*>(acc),
          static_cast<TO*>(out), m, n, K, om);
}

template <int BM, int BN, int BK, int TM, int TN>
int dispatch_gemm(const void* X, const void* acc, void* out, int m, int n,
                  int K, int x_bf16, int out_bf16, OmegaArgs om,
                  cudaStream_t stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (!x_bf16 && !out_bf16)
    launch_gemm<BM, BN, BK, TM, TN, float, float>(X, acc, out, m, n, K, om,
                                                  stream);
  else if (!x_bf16 && out_bf16)
    launch_gemm<BM, BN, BK, TM, TN, float, __nv_bfloat16>(
        X, acc, out, m, n, K, om, stream);
  else if (x_bf16 && !out_bf16)
    launch_gemm<BM, BN, BK, TM, TN, __nv_bfloat16, float>(
        X, acc, out, m, n, K, om, stream);
  else
    launch_gemm<BM, BN, BK, TM, TN, __nv_bfloat16, __nv_bfloat16>(
        X, acc, out, m, n, K, om, stream);
  return static_cast<int>(cudaGetLastError());
}

OmegaArgs make_omega(uint32_t k0, uint32_t k1, uint32_t row0, uint32_t col0,
                     uint32_t salt, int kind, float scale) {
  return OmegaArgs{PhiloxKey{k0, k1}, row0, col0, salt, kind, scale};
}

}  // namespace repro_torch

using repro_torch::make_omega;

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_gen_omega(void* out, int rows, int cols, uint32_t k0, uint32_t k1,
                 uint32_t row0, uint32_t col0, uint32_t salt, int kind,
                 float scale, void* stream) {
  const long long total = static_cast<long long>(rows) * cols;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  repro_torch::gen_omega_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), rows, cols,
      make_omega(k0, k1, row0, col0, salt, kind, scale));
  return static_cast<int>(cudaGetLastError());
}

int rt_sketch_fwd(const void* A, const void* acc, void* out, int m, int K,
                  int n, int a_bf16, int out_bf16, uint32_t k0, uint32_t k1,
                  uint32_t row0, uint32_t col0, uint32_t salt, int kind,
                  float scale, void* stream) {
  using namespace repro_torch;
  return dispatch_gemm<kFwdBM, kFwdBN, kFwdBK, kFwdTM, kFwdTN>(
      A, acc, out, m, n, K, a_bf16, out_bf16,
      make_omega(k0, k1, row0, col0, salt, kind, scale),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
