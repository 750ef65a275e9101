// The dense fused GEMM of the port, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_gemm — K5: out = acc + (A·B)·alpha, or (A·B)·alpha without acc, in
//             f32, then one cast to out's type; out may be acc.  Replaces
//             src/repro/kernels/local.py `_gemm_pallas` (bodies
//             `_gemm_body` and `_gemm_acc_body`, reached through
//             `gemm_block`), with the association of the reference's
//             `_gemm_jnp`: the f32 dot is scaled by alpha, then the
//             accumulator is added.
//
// Its one caller is the sketched gradient exchange
// (src/repro_torch/parallel/grad_compress.py), three calls a compressed
// leaf, r = 8, the largest leaf m = 256000, n = 2304, M f32 and the
// gradient g bf16 (gemma2-2b's parameters):
//   (a) Q^T_loc = P^T·M   : (r x m)·(m x n), K = m, an f32 r x n output;
//   (b) g_hat   = P·Q^T   : (m x r)·(r x n), K = r, written as bf16 into
//                           g's storage (out = a view of g);
//   (c) e'      = M - P·Q^T_loc, in place into M (acc = out, alpha = -1).
//
// What bounds it: bytes, in all three.  (a) reads M once (m·n f32 words)
// for 2·r FLOPs a word; (b) writes m·n bf16 values, 2·r FLOPs each; (c)
// reads and writes m·n f32 words.  At r = 8 every call is far below the
// card's f32 rate of 67 TFLOP/s per 3.35 TB/s (20 FLOPs a byte).
//
// The caller names the path (`gemm_plan` in sketch_matmul.py, from the
// path codes kPathTiled / kPathSkinny / kPathThin below); rt_gemm refuses a
// path that does not fit the shape:
//   * thin   (K <= kThinMaxK = 16, any M: calls (b) and (c)): a streaming
//     pass over acc and out.  Each thread owns 4 consecutive columns and
//     keeps B[0:K, its columns] in registers for the whole kernel; a block
//     is 64 x 2 threads over a stripe of 256 columns (every N of the main
//     path, 1024 to 9216, is a multiple of 256; at 512 columns one block in
//     five of N = 2304 would be half idle) and a group of 128 rows (grid.y;
//     more than 65535 groups are walked in a grid-stride loop).  The block
//     stages A[rows, 0:K] in shared memory, loaded along whichever of A's
//     strides is 1 (P from torch.linalg.qr is column-major), and every
//     thread of a warp reads the same row of it (a broadcast).  Each thread
//     has 4 rows in flight: it issues their acc loads first, then takes the
//     dots, then stores.  With N % 4 == 0 and acc and out at a 4-element
//     aligned base, acc and out move in one access of 4 elements — 16
//     bytes in f32, 8 in bf16 — with streaming hints (ld/st.global.cs: acc
//     and out, 2.36 GB at the embed leaf, are far larger than the 50 MB L2,
//     while A and B are reused); otherwise the same kernel, instantiated
//     with VEC = false, moves one element at a time.  Nothing falls back to
//     PyTorch.  On an H100 the f32 calls run within 5% of PyTorch's own
//     streaming passes over the same bytes (zero_, neg_), the bf16 (b)
//     about 1.25x its zero_.  Variants that were no faster there: 8 bf16
//     columns a thread (16-byte stores, but about 160 registers and half
//     the resident blocks), 2 or 8 rows in flight, 64- or 256-row groups,
//     256-thread blocks, a 64-register cap (spills) and plain loads and
//     stores without the hints.
//   * skinny (M <= 32 rows with K > 16: call (a)): one tile of output rows
//     would leave most of the 132 SMs idle walking K alone, so K is split
//     over `splits` blocks.  Each thread owns one column and streams B's
//     column from device memory (a warp reads 128 consecutive bytes of a
//     row), with A's k-slab staged in shared memory and read as a
//     broadcast.  The partial sums go to a [splits, M, N] f32 buffer and a
//     second pass adds them in split order, with no atomics, so two runs
//     give the same bits.
//   * tiled  (any other shape): a 64 x 64 output tile a block, 256 threads
//     of 4 x 4 outputs each, k in slabs of 16 through shared memory.  A
//     thread's columns are tx, tx + 16, ... so a half-warp stores 64
//     consecutive bytes of a row.
//
// The order of the f32 sum, the same in all three paths (so the thin path
// gives the bits the tiled and one-split skinny kernels gave at K <= 16):
// dot = 0; for k = 0 .. K-1: dot = fmaf(A[i,k], B[k,j], dot); v = dot·alpha
// rounded; with acc, v = acc + v rounded (__fmul_rn and __fadd_rn, so the
// compiler never contracts the two into one fma); one cast to out's type.
// A split skinny call adds its splits' partial dots in split order first.
// IEEE f32 FMA throughout: no TF32, no tensor cores, no --use_fast_math.
//
// Common to all paths: out may be acc (the aliased accumulator of the
// reference): every output element is read, then written, by one thread,
// so neither pointer is __restrict__.  A is read through its two strides,
// so the transposed view P^T of call (a) and the column-major P of calls
// (b) and (c) are taken as they are, without a copy.  B, acc and out are
// contiguous row-major.  Ragged edges are masked, never padded: loads
// outside the matrix give 0 and the k loop stops at K.  Index math is
// 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

// The path codes of rt_gemm; sketch_matmul.py's GEMM_PATHS names the same.
constexpr int kPathTiled = 0, kPathSkinny = 1, kPathThin = 2;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc + dot·alpha, each step rounded on its own.
__device__ __forceinline__ float epilogue(float dot, float alpha, bool use_acc,
                                          float a) {
  const float v = __fmul_rn(dot, alpha);
  return use_acc ? __fadd_rn(a, v) : v;
}

// out[idx] = acc[idx] + dot·alpha (acc may be null, and may be out).
template <typename TO>
__device__ __forceinline__ void finish(TO* out, const TO* acc, long long idx,
                                       float dot, float alpha) {
  const bool use_acc = acc != nullptr;
  store_f32(out + idx,
            epilogue(dot, alpha, use_acc, use_acc ? load_f32(acc + idx) : 0.f));
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

// --------------------------------------------------------------------------
// thin kernel (K <= 16): a streaming pass over acc and out
// --------------------------------------------------------------------------

constexpr int kThinMaxK = 16;      // GEMM_THIN_K of sketch_matmul.py
constexpr int kThinCols = 4;       // consecutive columns a thread owns
constexpr int kThinTX = 64;        // threads along a row: 256 columns
constexpr int kThinTY = 2;         // thread rows of a block
constexpr int kThinStripe = kThinTX * kThinCols;
constexpr int kThinRows = 128;     // rows of a block's group (A staged)
constexpr int kThinUnroll = 4;     // rows a thread has in flight

// Streaming (evict-first) accesses of acc and out: one element, or four
// consecutive ones in one 16-byte (f32) or 8-byte (bf16) access.
__device__ __forceinline__ float ld_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_cs(const __nv_bfloat16* p) {
  const unsigned h = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_cs(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         static_cast<unsigned short>(bf16_bits(v)));
}
__device__ __forceinline__ void ld4_cs(const float* p, float (&x)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld4_cs(const __nv_bfloat16* p,
                                       float (&x)[4]) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void st4_cs(float* p, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}
__device__ __forceinline__ void st4_cs(__nv_bfloat16* p,
                                       const float (&x)[4]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(bf16_bits(x[0]) | (bf16_bits(x[1]) << 16),
                    bf16_bits(x[2]) | (bf16_bits(x[3]) << 16)));
}

// KMAX (8 or 16) bounds K and sizes B's registers and A's staged rows;
// VEC: N % 4 == 0 and acc and out at a 4-element aligned base.
template <int KMAX, typename TO, bool VEC>
__global__ void __launch_bounds__(kThinTX* kThinTY)
    gemm_thin_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const TO* acc, TO* out, int M, int N, int K,
                     long long sa_m, long long sa_k, float alpha) {
  __shared__ __align__(16) float As[kThinRows][KMAX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThinTX + tx;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * kThinTX + tx) * kThinCols;
  const bool live = c0 < N;          // a thread past N only joins barriers
  const bool use_acc = acc != nullptr;
  // B[0:K, c0:c0+4] for the whole kernel; entries past K or N are 0 and
  // never reach an output
  float b[KMAX][kThinCols];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int j = 0; j < kThinCols; ++j)
      b[k][j] = (k < K && c0 + j < N)
                    ? B[static_cast<long long>(k) * N + c0 + j]
                    : 0.0f;
  // consecutive threads stage consecutive addresses of A
  const bool rows_fast = sa_m == 1;

  for (long long row0 = static_cast<long long>(blockIdx.y) * kThinRows;
       row0 < M; row0 += static_cast<long long>(gridDim.y) * kThinRows) {
    const int rows = static_cast<int>(
        min(static_cast<long long>(kThinRows), M - row0));
    __syncthreads();                 // the last group's reads of As are done
    for (int e = tid; e < kThinRows * KMAX; e += kThinTX * kThinTY) {
      const int i = rows_fast ? e % kThinRows : e / KMAX;
      const int k = rows_fast ? e / kThinRows : e % KMAX;
      As[i][k] = (i < rows && k < K) ? A[(row0 + i) * sa_m + k * sa_k]
                                     : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int r = ty; r < rows; r += kThinTY * kThinUnroll) {
      float x[kThinUnroll][kThinCols];
      // the acc loads of all kThinUnroll rows go out first
#pragma unroll
      for (int u = 0; u < kThinUnroll; ++u) {
        const int ru = r + u * kThinTY;
        const long long idx = (row0 + ru) * N + c0;
        if (!use_acc || ru >= rows) continue;
        if constexpr (VEC) {
          ld4_cs(acc + idx, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < kThinCols; ++j)
            if (c0 + j < N) x[u][j] = ld_cs(acc + idx + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kThinUnroll; ++u) {
        const int ru = r + u * kThinTY;
        if (ru >= rows) break;
        float a[KMAX];
#pragma unroll
        for (int q = 0; q < KMAX / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(As[ru])[q];
          a[4 * q] = v.x; a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
        }
        float dot[kThinCols];
#pragma unroll
        for (int j = 0; j < kThinCols; ++j) dot[j] = 0.0f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k >= K) break;
#pragma unroll
          for (int j = 0; j < kThinCols; ++j)
            dot[j] = fmaf(a[k], b[k][j], dot[j]);
        }
        float v[kThinCols];
#pragma unroll
        for (int j = 0; j < kThinCols; ++j)
          v[j] = epilogue(dot[j], alpha, use_acc, use_acc ? x[u][j] : 0.f);
        const long long idx = (row0 + ru) * N + c0;
        if constexpr (VEC) {
          st4_cs(out + idx, v);
        } else {
#pragma unroll
          for (int j = 0; j < kThinCols; ++j)
            if (c0 + j < N) st_cs(out + idx + j, v[j]);
        }
      }
    }
  }
}

template <int KMAX, typename TO>
void launch_thin(const float* A, const float* B, const TO* acc, TO* out,
                 int M, int N, int K, long long sa_m, long long sa_k,
                 float alpha, cudaStream_t stream) {
  const long long groups = (static_cast<long long>(M) + kThinRows - 1) /
                           kThinRows;
  const dim3 grid((N + kThinStripe - 1) / kThinStripe,
                  static_cast<unsigned>(groups < 65535 ? groups : 65535));
  const dim3 block(kThinTX, kThinTY);
  const auto align = static_cast<uintptr_t>(sizeof(TO) * kThinCols);
  const bool vec = N % kThinCols == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0 &&
                   reinterpret_cast<uintptr_t>(acc) % align == 0;
  if (vec)
    gemm_thin_kernel<KMAX, TO, true><<<grid, block, 0, stream>>>(
        A, B, acc, out, M, N, K, sa_m, sa_k, alpha);
  else
    gemm_thin_kernel<KMAX, TO, false><<<grid, block, 0, stream>>>(
        A, B, acc, out, M, N, K, sa_m, sa_k, alpha);
}

template <typename TO>
void launch_gemm(const float* A, const float* B, const TO* acc, TO* out,
                 float* work, int M, int N, int K, long long sa_m,
                 long long sa_k, int path, int splits, float alpha,
                 cudaStream_t stream) {
  if (path == kPathThin) {
    if (K <= 8)
      launch_thin<8, TO>(A, B, acc, out, M, N, K, sa_m, sa_k, alpha, stream);
    else
      launch_thin<16, TO>(A, B, acc, out, M, N, K, sa_m, sa_k, alpha,
                          stream);
  } else if (path == kPathSkinny) {
    if (M <= 8)
      launch_skinny<8, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k, splits,
                           alpha, stream);
    else if (M <= 16)
      launch_skinny<16, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k,
                            splits, alpha, stream);
    else
      launch_skinny<32, TO>(A, B, acc, out, work, M, N, K, sa_m, sa_k,
                            splits, alpha, stream);
  } else {
    gemm_tiled_kernel<TO><<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM),
                            dim3(kTX, kTY), 0, stream>>>(
        A, B, acc, out, M, N, K, sa_m, sa_k, alpha);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// A: f32, element (i, k) at A[i·sa_m + k·sa_k]; B: (K, N) row-major f32;
// acc: null or (M, N) row-major of out's type (it may be out itself);
// out: (M, N) row-major, f32 or bf16 (out_bf16).  path: kPathThin needs
// K <= 16, kPathSkinny M <= 32 (at most 65535 splits; with splits > 1,
// work is an f32 buffer of splits·M·N words, else unused), kPathTiled
// M < 65535·64 row tiles; only the skinny path takes splits > 1.  Returns
// cudaErrorInvalidValue for anything else, without launching.
int rt_gemm(const void* A, const void* B, const void* acc, void* out,
            void* work, int M, int N, int K, long long sa_m, long long sa_k,
            int path, int splits, float alpha, int out_bf16, void* stream) {
  using namespace repro_torch;
  const bool fits =
      (path == kPathThin && K <= kThinMaxK && splits == 1) ||
      (path == kPathSkinny && M <= 32 && splits <= 65535 &&
       (splits == 1 || work != nullptr)) ||
      (path == kPathTiled && (M + kBM - 1) / kBM <= 65535 && splits == 1);
  if (M <= 0 || N <= 0 || K < 0 || splits <= 0 || !fits)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const float*>(A);
  const auto b = static_cast<const float*>(B);
  const auto w = static_cast<float*>(work);
  if (out_bf16)
    launch_gemm<__nv_bfloat16>(a, b, static_cast<const __nv_bfloat16*>(acc),
                               static_cast<__nv_bfloat16*>(out), w, M, N, K,
                               sa_m, sa_k, path, splits, alpha, st);
  else
    launch_gemm<float>(a, b, static_cast<const float*>(acc),
                       static_cast<float*>(out), w, M, N, K, sa_m, sa_k,
                       path, splits, alpha, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
