// The dense fused GEMM of the port, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_gemm — K5: out = acc + (A·B)·alpha, or (A·B)·alpha without acc, in
//             f32, then one cast to out's type.  Replaces
//             src/repro/kernels/local.py `_gemm_pallas` (bodies `_gemm_body`
//             and `_gemm_acc_body`), with the association of the
//             reference's `_gemm_jnp`: the f32 dot is scaled by alpha, then
//             the accumulator is added.
//
// Its one caller is the sketched gradient exchange
// (src/repro_torch/parallel/grad_compress.py), three calls a compressed
// leaf, all f32, with r = 8 and the largest leaf m = 256000, n = 2304:
//   (a) Q^T_loc = P^T·M   : (r x m)·(m x n), K = m, an r x n output;
//   (b) g_hat   = P·Q^T   : (m x r)·(r x n), K = r;
//   (c) e'      = M - P·Q^T_loc, in place into M (acc = out, alpha = -1).
//
// What bounds it: bytes, in all three.  (a) reads M once (m·n words) for
// 2·r FLOPs a word; (b) writes m·n words, (c) reads and writes them.
//
// Design:
//   * out may be acc (the aliased accumulator of the reference): every
//     output element is read, then written, by one thread, so neither
//     pointer is __restrict__.
//   * A is read through its two strides, so the transposed view P^T of
//     call (a) is taken as it is, without a copy.  B, acc and out are
//     contiguous row-major.
//   * Ragged edges are masked, never padded: loads outside the matrix give
//     0 and the k loop stops at K.
//   * Skinny A (M <= 32 rows, call (a)): one tile of output rows would
//     leave most of the 132 SMs idle walking K alone, so K is split over
//     `splits` blocks.  Each thread owns one column and streams B's column
//     from device memory (a warp reads 128 consecutive bytes of a row),
//     with A's k-slab staged in shared memory and read as a broadcast.
//     The partial sums go to a [splits, M, N] f32 buffer and a second pass
//     adds them in split order, with no atomics, so two runs give the
//     same bits.
//   * Any other shape (calls (b) and (c)): a 64 x 64 output tile a block,
//     256 threads of 4 x 4 outputs each, k in slabs of 16 through shared
//     memory.  A thread's columns are tx, tx + 16, ... so a half-warp
//     stores 64 consecutive bytes of a row.  No wgmma and no TMA: the
//     kernel is plain f32 FMA (IEEE, no TF32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[idx] = acc[idx] + dot·alpha (acc may be null, and may be out).
template <typename TO>
__device__ __forceinline__ void finish(TO* out, const TO* acc, long long idx,
                                       float dot, float alpha) {
  float v = dot * alpha;
  if (acc != nullptr) v = load_f32(acc + idx) + v;
  store_f32(out + idx, v);
}

// --------------------------------------------------------------------------
// general tiled kernel
// --------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kT = 4, kTX = 16, kTY = 16;

template <typename TO>
__global__ void __launch_bounds__(kTX* kTY)
    gemm_tiled_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      const TO* acc, TO* out, int M, int N, int K,
                      long long sa_m, long long sa_k, float alpha) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;
  float c[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) c[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // 1024 elements of each tile, 4 a thread; masked loads give 0
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kTX * kTY) {
      const int kk = e / kBM, i = e % kBM;       // consecutive threads: rows
      const long long r = row0 + i, k = k0 + kk;
      As[kk][i] = (r < M && k < K) ? A[r * sa_m + k * sa_k] : 0.0f;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kTX * kTY) {
      const int kk = e / kBN, j = e % kBN;       // consecutive threads: cols
      const long long k = k0 + kk, col = col0 + j;
      Bs[kk][j] = (k < K && col < N) ? B[k * N + col] : 0.0f;
    }
    __syncthreads();
    const int kn = min(kBK, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float a[kT], b[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) a[i] = As[kk][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kT; ++j) b[j] = Bs[kk][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const long long r = row0 + ty + kTY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const long long col = col0 + tx + kTX * j;
      if (col < N) finish(out, acc, r * N + col, c[i][j], alpha);
    }
  }
}

// --------------------------------------------------------------------------
// skinny split-K kernel (M <= 32) and the fixed-order reduction
// --------------------------------------------------------------------------

constexpr int kSkinnyCols = 128;   // threads a block, one column each
constexpr int kSkinnyK = 256;      // k rows of A staged at a time

template <int MT, typename TO>
__global__ void __launch_bounds__(kSkinnyCols)
    gemm_skinny_kernel(const float* __restrict__ A,
                       const float* __restrict__ B, const TO* acc, TO* out,
                       float* __restrict__ work, int M, int N, int K,
                       long long sa_m, long long sa_k, int k_per_split,
                       float alpha) {
  __shared__ float As[kSkinnyK][MT];
  const long long col = static_cast<long long>(blockIdx.x) * kSkinnyCols +
                        threadIdx.x;
  const long long k_begin =
      static_cast<long long>(blockIdx.y) * k_per_split;
  const long long k_end = min(static_cast<long long>(K),
                              k_begin + k_per_split);
  float c[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) c[i] = 0.0f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kSkinnyK) {
    const int kn = static_cast<int>(min(static_cast<long long>(kSkinnyK),
                                        k_end - k0));
    for (int e = threadIdx.x; e < kSkinnyK * MT; e += kSkinnyCols) {
      const int kk = e / MT, i = e % MT;
      As[kk][i] = (i < M && kk < kn) ? A[i * sa_m + (k0 + kk) * sa_k]
                                     : 0.0f;
    }
    __syncthreads();
    if (col < N) {
      const float* bp = B + k0 * N + col;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float b = bp[static_cast<long long>(kk) * N];
#pragma unroll
        for (int i = 0; i < MT; ++i) c[i] = fmaf(As[kk][i], b, c[i]);
      }
    }
    __syncthreads();
  }
  if (col >= N) return;
  // unrolled over MT with a guard, so c stays in registers
  float* w = work == nullptr
                 ? nullptr
                 : work + static_cast<long long>(blockIdx.y) * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= M) break;
    const long long idx = static_cast<long long>(i) * N + col;
    if (w == nullptr)                    // one split: finish here
      finish(out, acc, idx, c[i], alpha);
    else
      w[idx] = c[i];
  }
}

template <typename TO>
__global__ void splitk_reduce_kernel(const float* __restrict__ work,
                                     const TO* acc, TO* out, long long MN,
                                     int splits, float alpha) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float dot = 0.0f;
  for (int s = 0; s < splits; ++s) dot += work[s * MN + idx];
  finish(out, acc, idx, dot, alpha);
}

template <int MT, typename TO>
void launch_skinny(const float* A, const float* B, const TO* acc, TO* out,
                   float* work, int M, int N, int K, long long sa_m,
                   long long sa_k, int splits, float alpha,
                   cudaStream_t stream) {
  const int k_per_split = (K + splits - 1) / splits;
  const dim3 grid((N + kSkinnyCols - 1) / kSkinnyCols, splits);
  gemm_skinny_kernel<MT, TO><<<grid, kSkinnyCols, 0, stream>>>(
      A, B, acc, out, splits > 1 ? work : nullptr, M, N, K, sa_m, sa_k,
      k_per_split, alpha);
  if (splits > 1) {
    const long long MN = static_cast<long long>(M) * N;
    const int threads = 256;
    splitk_reduce_kernel<TO><<<static_cast<unsigned>((MN + threads - 1) /
                                                     threads),
                               threads, 0, stream>>>(work, acc, out, MN,
                                                     splits, alpha);
  }
}

template <typename TO>
void launch_gemm(const float* A, const float* B, const TO* acc, TO* out,
                 float* work, int M, int N, int K, long long sa_m,
                 long long sa_k, int splits, float alpha,
                 cudaStream_t stream) {
  if (M <= 8)
    launch_skinny<8, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k, splits,
                         alpha, stream);
  else if (M <= 16)
    launch_skinny<16, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k, splits,
                          alpha, stream);
  else if (M <= 32)
    launch_skinny<32, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k, splits,
                          alpha, stream);
  else
    gemm_tiled_kernel<TO><<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                            dim3(kTX, kTY), 0, stream>>>(
        A, B, acc, out, M, N, K, sa_m, sa_k, alpha);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// A: f32, element (i, k) at A[i·sa_m + k·sa_k]; B: (K, N) row-major f32;
// acc: null or (M, N) row-major of out's type (it may be out itself);
// out: (M, N) row-major, f32 or bf16 (out_bf16).  With M <= 32 and
// splits > 1, work is an f32 buffer of splits·M·N words (else unused).
// The grid's second dimension holds the splits (at most 65535) and, for
// M > 32, the row tiles (M < 65535·64).
int rt_gemm(const void* A, const void* B, const void* acc, void* out,
            void* work, int M, int N, int K, long long sa_m, long long sa_k,
            int splits, float alpha, int out_bf16, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || N <= 0 || splits <= 0 || splits > 65535 ||
      (M > 32 && (M + kBM - 1) / kBM > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const float*>(A);
  const auto b = static_cast<const float*>(B);
  const auto w = static_cast<float*>(work);
  if (out_bf16)
    launch_gemm<__nv_bfloat16>(a, b, static_cast<const __nv_bfloat16*>(acc),
                               static_cast<__nv_bfloat16*>(out), w, M, N, K,
                               sa_m, sa_k, splits, alpha, st);
  else
    launch_gemm<float>(a, b, static_cast<const float*>(acc),
                       static_cast<float*>(out), w, M, N, K, sa_m, sa_k,
                       splits, alpha, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
