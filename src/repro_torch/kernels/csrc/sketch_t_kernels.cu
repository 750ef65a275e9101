// The transposed sketch GEMM of the port (K3/K7), for Hopper (sm_90a), with
// a plain C interface loaded through ctypes
// (src/repro_torch/kernels/sketch_matmul.py `sketch_t_cuda`).
//
//   rt_sketch_t — out = acc? + Omega[row0:row0+K, col0:col0+m]^T · B, with
//                 B (K, n) float32 or bfloat16 row-major and out (m, n)
//                 float32 or bfloat16.  Replaces src/repro/kernels/local.py
//                 `_sketch_t_block_pallas` (:326) and
//                 src/repro/kernels/sketch_matmul.py `sketch_t_matmul_pallas`
//                 (:125).
//
// What bounds it: f32 FMA at every shape of the main path.  It does
// 2·m·n·K FLOPs on K·n + m·n words: at the streaming W update (m = l =
// 1025, n = 32768, K = 4096) 2.75e11 FLOPs, 4.1 ms at 67 TFLOP/s, against
// 0.7 GB, 0.2 ms at 3.35 TB/s; at the Nystrom C (m = n = 512, K = 32768)
// 1.7e10 FLOPs, 0.26 ms, against 0.07 GB.  Drawing Omega costs 3 Philox
// calls a normal entry: K·m of them are needed, and a kernel that draws
// the Omega tile again for every column tile of B (the TPU design) spends
// more on Philox than on FMAs.
//
// Design (one rt_sketch_t call: two launches, three with a split):
//   1. omega_slab_draw_kernel (omega_slab.cuh, shared with sketch_fwd)
//      draws Omega[row0:row0+K, col0:col0+m] ONCE into an f32 scratch of
//      K x ldm (ldm = m rounded up to 4; pad columns hold 0), by
//      `omega_entry` at the same global coordinates as gen_omega (row0 + k
//      and col0 + i wrap at 2^32), so its entries are bitwise those of
//      gen_omega.  Within the call Omega sits in device
//      memory (the caller's scratch, no larger than B on the main path);
//      it never outlives the call and never crosses a link.
//   2. sketch_t_gemm_kernel: a 128 x 128 output tile a block, 256 threads
//      with an 8 x 8 register tile each (rows ty·4 + {0..3} and
//      64 + ty·4 + {0..3}, columns likewise from tx, each read as two
//      float4 from shared memory), k in steps of 8.  Both operands are
//      K-major rows (the scratch and B), so their tiles go to shared memory
//      as [BK][BM] and [BK][BN] with no transpose, double-buffered:
//      cp.async fetches step t+1 while step t computes.  Rows and columns
//      outside the matrices are zero-filled by cp.async's src-size operand
//      and never read.  B is copied 16 bytes at a time only when its base
//      is 16-byte aligned and n % 4 == 0, decided at run time (a B of 70
//      columns, or a ragged lane's view that starts at an odd element,
//      takes 4-byte copies); a bfloat16 B is loaded into registers during
//      step t, upcast to f32 and stored to shared memory after step t's
//      FMAs.  Blocks are ordered with the row tiles fastest, so the row
//      tiles that share a column tile of B run together and B is read
//      from device memory about once.
//   3. Split K where the tiles do not fill the card: the caller picks
//      `splits` from (m, n, K) alone (sketch_matmul.py
//      `sketch_t_splits`).  Each split sums its k range in order into a
//      [splits, m, n] f32 work buffer, and split_reduce_kernel adds the
//      partial sums in split order, then forms acc + sum and rounds once.
//      No atomics: two runs give the same bits, and a ragged lane (the
//      same m, n, K) the bits of its solo update.
//
// Numerics: IEEE f32 fmaf in a fixed k order; no TF32, no bf16 products.
// The epilogue is `acc + dot` (the association of the reference's jnp
// body), rounded once to the output type.  `acc` may alias `out`: each
// element is read and then written by one thread, and neither pointer is
// __restrict__.  The kernels allocate nothing; each launch's
// cudaGetLastError() is returned.
#include "omega_slab.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kMaxSplits = 64;                       // gridDim.z
constexpr int kMaxTiles = 65535;                     // gridDim.y
// How B reaches shared memory.
constexpr int kB16 = 0;    // f32, 16-byte cp.async (aligned base, n % 4 == 0)
constexpr int kB4 = 1;     // f32, 4-byte cp.async
constexpr int kBf16 = 2;   // bf16 through registers, upcast to f32

static_assert(kThreads == 256 && kBK * kBM == 4 * kThreads &&
                  kBK * kBN == 4 * kThreads,
              "each thread copies 4 words of each tile a step");

// C(m, n) = S(K, ldm)[:, :m]^T · B(K, n) over split blockIdx.z's k range;
// with work == nullptr it writes acc? + C into out, else C into
// work[blockIdx.z].
template <int kMode, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
    sketch_t_gemm_kernel(const float* __restrict__ S, int ldm,
                         const void* __restrict__ Bv, const TO* acc, TO* out,
                         float* __restrict__ work, int m, int n, int K,
                         long long k_per_split) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int bm0 = blockIdx.x * kBM, bn0 = blockIdx.y * kBN;
  const long long kb = static_cast<long long>(blockIdx.z) * k_per_split;
  const long long ke = min(static_cast<long long>(K), kb + k_per_split);
  const int steps =
      ke > kb ? static_cast<int>((ke - kb + kBK - 1) / kBK) : 0;

  // A thread's 16-byte slot in a tile: row lk, columns lc .. lc + 3.
  const int lk = tid / 32, lc = (tid % 32) * 4;
  const float* Bf = static_cast<const float*>(Bv);
  const __nv_bfloat16* Bh = static_cast<const __nv_bfloat16*>(Bv);
  float breg[4];

  auto load_a = [&](int t, int buf) {
    const long long k = kb + static_cast<long long>(t) * kBK + lk;
    const bool ok = k < ke && bm0 + lc < ldm;   // ldm % 4 == 0
    cp_async16(&As[buf][lk][lc], ok ? S + k * ldm + bm0 + lc : S, ok);
  };
  // f32 B straight into shared memory; bf16 B into breg.
  auto load_b = [&](int t, int buf) {
    const long long k0 = kb + static_cast<long long>(t) * kBK;
    if constexpr (kMode == kB16) {
      const long long k = k0 + lk;
      const bool ok = k < ke && bn0 + lc < n;   // n % 4 == 0
      cp_async16(&Bs[buf][lk][lc], ok ? Bf + k * n + bn0 + lc : Bf, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + e * kThreads;
        const int kk = idx / kBN, c = idx % kBN;
        const long long k = k0 + kk;
        const bool ok = k < ke && bn0 + c < n;
        if constexpr (kMode == kB4)
          cp_async4(&Bs[buf][kk][c], ok ? Bf + k * n + bn0 + c : Bf, ok);
        else
          breg[e] = ok ? to_f32(Bh[k * n + bn0 + c]) : 0.0f;
      }
    }
  };
  auto store_b = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kThreads;
      Bs[buf][idx / kBN][idx % kBN] = breg[e];
    }
  };

  float sum[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) sum[i][j] = 0.0f;

  if (steps > 0) {
    load_a(0, 0);
    load_b(0, 0);
    if constexpr (kMode == kBf16) store_b(0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool more = t + 1 < steps;
    if (more) {             // buffer nxt was released by step t-1's barrier
      load_a(t + 1, nxt);
      load_b(t + 1, nxt);
    }
    cp_async_commit();
    cp_async_wait_prev();   // step t's copies have landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][kBM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][kBN / 2 + tx * 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) sum[i][j] = fmaf(a[i], b[j], sum[i][j]);
    }
    if constexpr (kMode == kBf16)
      if (more) store_b(nxt);
    __syncthreads();        // step t's tiles are free for step t+2
  }

  float* w = work == nullptr
                 ? nullptr
                 : work + static_cast<long long>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = bm0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = bn0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + j - 4);
      if (c >= n) continue;
      const long long idx = static_cast<long long>(r) * n + c;
      if (w != nullptr) {
        w[idx] = sum[i][j];
      } else {
        float v = sum[i][j];
        if (acc != nullptr) v = to_f32(acc[idx]) + v;
        store(out + idx, v);
      }
    }
  }
}

template <int kMode, typename TO>
int launch(const float* S, int ldm, const void* B, const void* acc, void* out,
           float* work, int m, int n, int K, int splits,
           cudaStream_t stream) {
  const long long kps_raw = (static_cast<long long>(K) + splits - 1) / splits;
  const long long k_per_split = (kps_raw + kBK - 1) / kBK * kBK;
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN, splits);
  sketch_t_gemm_kernel<kMode, TO><<<grid, kThreads, 0, stream>>>(
      S, ldm, B, static_cast<const TO*>(acc), static_cast<TO*>(out),
      splits > 1 ? work : nullptr, m, n, K, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(reduce_splits<TO>(
      work, acc, out, static_cast<long long>(m) * n, splits, stream));
}

template <typename TO>
int dispatch(const float* S, int ldm, const void* B, int b_mode,
             const void* acc, void* out, float* work, int m, int n, int K,
             int splits, cudaStream_t stream) {
  if (b_mode == kB16)
    return launch<kB16, TO>(S, ldm, B, acc, out, work, m, n, K, splits,
                            stream);
  if (b_mode == kB4)
    return launch<kB4, TO>(S, ldm, B, acc, out, work, m, n, K, splits,
                           stream);
  return launch<kBf16, TO>(S, ldm, B, acc, out, work, m, n, K, splits,
                           stream);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// B: (K, n) row-major, f32 or bf16 (b_bf16), any base alignment of its
// element type; acc: null or (m, n) row-major of out's type (it may be
// out); out: (m, n) row-major, f32 or bf16 (out_bf16); scratch: f32,
// 16-byte aligned, K·ldm words with ldm = m rounded up to 4; work: with
// splits > 1, f32, 16-byte aligned, splits·m·n words (else unused).
// 1 <= splits <= 64, ceil(m/128) and ceil(n/128) at most 65535.
int rt_sketch_t(const void* B, const void* acc, void* out, void* scratch,
                void* work, int K, int n, int m, int b_bf16, int out_bf16,
                int splits, uint32_t k0, uint32_t k1, uint32_t row0,
                uint32_t col0, uint32_t salt, int kind, float scale,
                void* stream) {
  using namespace repro_torch;
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (K < 0 || splits < 1 || splits > kMaxSplits ||
      (m + kBM - 1) / kBM > kMaxTiles || (n + kBN - 1) / kBN > kMaxTiles ||
      (K > 0 && (scratch == nullptr || misaligned16(scratch))) ||
      (splits > 1 && (work == nullptr || misaligned16(work))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldm = (m + 3) / 4 * 4;
  float* S = static_cast<float*>(scratch);
  const cudaError_t err = draw_omega_slab(
      S, K, m, ldm, DrawArgs{PhiloxKey{k0, k1}, row0, col0, salt, kind, scale},
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int b_mode =
      b_bf16 ? kBf16
             : (!misaligned16(B) && n % 4 == 0 ? kB16 : kB4);
  float* w = static_cast<float*>(work);
  if (out_bf16)
    return dispatch<__nv_bfloat16>(S, ldm, B, b_mode, acc, out, w, m, n, K,
                                   splits, st);
  return dispatch<float>(S, ldm, B, b_mode, acc, out, w, m, n, K, splits,
                         st);
}

// The shared memory a block of sketch_t_gemm_kernel takes, for the
// planner's fit: *static_bytes from cudaFuncGetAttributes; it asks for no
// dynamic shared memory.
int rt_sketch_t_smem(int* static_bytes, int* dynamic_bytes) {
  using namespace repro_torch;
  const auto k = sketch_t_gemm_kernel<kB16, float>;
  *dynamic_bytes = 0;
  return static_cast<int>(static_smem(k, static_bytes));
}

}  // extern "C"
