// The forward sketch kernels of the port, for Hopper (sm_90a), with a plain
// C interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_gen_omega  — K8: a materialized Omega tile at global (row0, col0).
//                   Replaces src/repro/kernels/sketch_matmul.py
//                   `gen_omega_pallas`.  Bound by integer work: three
//                   Philox-4x32-10 calls per normal entry.
//   rt_sketch_fwd — K2/K6: out = acc? + A · Omega[row0:row0+K, col0:col0+n],
//                   A (m, K) float32 or bfloat16 row-major, out (m, n)
//                   float32 or bfloat16.  Replaces src/repro/kernels/local.py
//                   `_sketch_block_pallas` (:286) and
//                   src/repro/kernels/sketch_matmul.py `sketch_matmul_pallas`
//                   (:76).
//
// K3/K7 (`rt_sketch_t`, Omega^T · B) is in sketch_t_kernels.cu; the slab
// draw and the split reduce both use are in omega_slab.cuh.
//
// What bounds sketch_fwd on this card, at the main path's shapes:
//   * one-shot and streaming, A 32768 x 32768 -> 512 columns (the streaming
//     slabs are 4096 rows of it): 2·m·n·K = 1.1e12 FLOPs, 16.4 ms at
//     67 TFLOP/s f32, against 4.3 GB of A, 1.3 ms at 3.35 TB/s: f32 FMA.
//   * a serving lane, k <= 256 rows of K = 8192 -> 128 columns: at most
//     2 x 1 output tiles of 128 x 128, so without a split 2 of 132 SMs work.
//   * the gradient exchange, n = r = 8 columns (M 256000 x 2304 at the
//     embed leaf): 9.4e9 FLOPs, 0.14 ms, against 2.36 GB of M, 0.70 ms:
//     bytes.
// The TPU design draws the Omega tile again for every row tile of A: at
// A = 32768² that is 4.3e9 normal draws of 3 Philox calls each, more
// integer work than the FMAs.
//
// Design (one rt_sketch_fwd call: two launches, three with a split):
//   1. omega_slab_draw_kernel draws Omega[row0:row0+K, col0:col0+n] ONCE
//      into an f32 scratch of K x ldn (ldn = n rounded up to 4; pad
//      columns hold 0), the bits of gen_omega.  Within the call Omega sits
//      in device memory (64 MiB at A = 32768², r = 512; 4 MiB on a serving
//      lane); it never outlives the call and never crosses a link.
//   2a. n > 16, sketch_fwd_gemm_kernel: a 128 x 128 output tile a block,
//      256 threads with an 8 x 8 register tile each, k in steps of 16,
//      double-buffered.  The scratch tile is K-major and goes to shared
//      memory by 16-byte cp.async, fetched for step t+1 while step t
//      computes.  A is row-major, so its 128 x 16 tile is M-major: each
//      thread loads 8 consecutive k of one row into registers during step
//      t (16-byte loads when A's base is 16-byte aligned and K % 4 == 0,
//      decided at run time; else 4-byte loads; bfloat16 upcast to f32)
//      and stores them transposed into the [BK][BM] tile after step t's
//      FMAs (a warp's threads take 32 consecutive rows, so the stores hit
//      32 banks).  The column tiles of one row tile are adjacent in the
//      grid, so A is read from device memory about once.
//   2b. n <= 16, sketch_fwd_narrow_kernel: the exchange's r = 8 would fill
//      8 of a 128-column tile.  A is streamed once: each warp takes R rows
//      at a time, lane l the k values 4l + 128j (16-byte loads when
//      aligned), and multiplies them against the Omega slab held in
//      shared memory transposed ([NP][KC + 4], NP = n rounded up to 4, 8
//      or 16), in chunks of KC rows (about 96 KB, dynamic shared memory,
//      two blocks an SM); a persistent grid walks the row groups.  Each
//      lane sums its k values in increasing k; the 32 lane sums are added
//      by a fixed xor tree (reduce-scatter over shuffles).
//   3. Split K where the tiles leave the card idle (wide path only): the
//      caller picks `splits` from (n, K) alone, never from m
//      (sketch_matmul.py `sketch_fwd_splits`).  Each split sums its k
//      range in order into a [splits, m, n] f32 work buffer and
//      split_reduce_kernel adds the partial sums in split order.  No
//      atomics.
// Every output element is thus a sum whose order depends on (n, K) alone:
// a row of a streamed slab has the bits of the same row of a one-shot
// sketch, and a ragged lane the bits of its solo update.
//
// Numerics: IEEE f32 fmaf; no TF32 and no bf16 tensor cores (a bf16 wgmma
// would quantize Omega).  The epilogue is `acc + dot` (the association of
// the reference's jnp body), rounded once to the output type.  `acc` may
// alias `out`: each element is read and then written by one thread, and
// neither pointer is __restrict__.  Index math is 64-bit.  The kernels
// allocate nothing; each launch's cudaGetLastError() is returned.
#include <algorithm>
#include <climits>

#include "omega_slab.cuh"

namespace repro_torch {
namespace {

__global__ void gen_omega_kernel(float* __restrict__ out, int rows, int cols,
                                 DrawArgs om) {
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

constexpr int kThreads = 256;
constexpr int kMaxSplits = 64;        // gridDim.y
constexpr int kNarrowMaxN = 16;       // n <= 16 takes the narrow kernel
// How A is read.
constexpr int kA16 = 0;    // f32, 16-byte loads (aligned base, K % 4 == 0)
constexpr int kA4 = 1;     // f32, 4-byte loads
constexpr int kAbf16 = 2;  // bf16, upcast to f32

template <int kMode>
__device__ __forceinline__ void load4(const void* A, long long base,
                                      long long k, long long kend,
                                      float (&a)[4]) {
  if constexpr (kMode == kA16) {
    const float4 v =
        *reinterpret_cast<const float4*>(static_cast<const float*>(A) + base);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k + q < kend) {
        if constexpr (kMode == kA4)
          a[q] = static_cast<const float*>(A)[base + q];
        else
          a[q] = to_f32(static_cast<const __nv_bfloat16*>(A)[base + q]);
      } else {
        a[q] = 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2a. the wide path
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 16, kTM = 8, kTN = 8;
constexpr int kAPer = kBM * kBK / kThreads;        // 8 words of A a step
constexpr int kBPer = kBK * kBN / (4 * kThreads);  // 2 16-byte copies
static_assert((kBM / kTM) * (kBN / kTN) == kThreads && kAPer == 8 &&
                  kBPer == 2,
              "each thread copies 8 words of each tile a step");

// C(m, n) = A(m, K) · S(K, ldn)[:, :n] over split blockIdx.y's k range,
// output tile blockIdx.x (column tiles fastest); with work == nullptr it
// writes acc? + C into out, else C into work[blockIdx.y].
template <int kMode, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
    sketch_fwd_gemm_kernel(const void* __restrict__ A,
                           const float* __restrict__ S, int ldn,
                           const TO* acc, TO* out, float* __restrict__ work,
                           int m, int n, int K, long long k_per_split,
                           int col_tiles) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const long long tile = blockIdx.x;
  const int bn0 = static_cast<int>(tile % col_tiles) * kBN;
  const long long bm0 = tile / col_tiles * kBM;
  const long long kb = static_cast<long long>(blockIdx.y) * k_per_split;
  const long long ke = min(static_cast<long long>(K), kb + k_per_split);
  const int steps =
      ke > kb ? static_cast<int>((ke - kb + kBK - 1) / kBK) : 0;

  // A thread's share of A's tile: row ar, columns ak .. ak + 7 (a warp
  // takes 32 consecutive rows, so its transposed stores hit 32 banks); of
  // the scratch's tile: rows lk and lk + 8, columns lc .. lc + 3.
  const int ar = tid % kBM, ak = (tid / kBM) * kAPer;
  const long long arow = bm0 + ar;
  const bool arow_ok = arow < m;
  const long long abase = arow_ok ? arow * K : 0;
  const int lk = tid / 32, lc = (tid % 32) * 4;
  float areg[kAPer];

  auto load_a = [&](int t) {
#pragma unroll
    for (int h = 0; h < kAPer / 4; ++h) {
      const long long k = kb + static_cast<long long>(t) * kBK + ak + 4 * h;
      float a4[4];
      if (arow_ok && k < ke) {
        load4<kMode>(A, abase + k, k, ke, a4);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) a4[q] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) areg[4 * h + q] = a4[q];
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kAPer; ++q) As[buf][ak + q][ar] = areg[q];
  };
  auto load_b = [&](int t, int buf) {
#pragma unroll
    for (int h = 0; h < kBPer; ++h) {
      const int kk = lk + 8 * h;
      const long long k = kb + static_cast<long long>(t) * kBK + kk;
      const bool ok = k < ke && bn0 + lc < ldn;   // ldn % 4 == 0
      cp_async16(&Bs[buf][kk][lc], ok ? S + k * ldn + bn0 + lc : S, ok);
    }
  };

  float sum[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) sum[i][j] = 0.0f;

  if (steps > 0) {
    load_a(0);
    store_a(0);
    load_b(0, 0);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const bool more = t + 1 < steps;
    if (more) {             // buffer nxt was released by step t-1's barrier
      load_a(t + 1);
      load_b(t + 1, nxt);
    }
    cp_async_commit();
    cp_async_wait_prev();   // step t's scratch tile has landed
    __syncthreads();        // ... and step t's A tile is stored
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
    if (more) store_a(nxt);
    __syncthreads();        // step t's tiles are free for step t+2
  }

  float* w = work == nullptr
                 ? nullptr
                 : work + static_cast<long long>(blockIdx.y) * m * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long r =
        bm0 + (i < 4 ? ty * 4 + i : kBM / 2 + ty * 4 + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = bn0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + j - 4);
      if (c >= n) continue;
      const long long idx = r * n + c;
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
cudaError_t launch_wide(const void* A, const float* S, int ldn,
                        const void* acc, void* out, float* work, int m, int n,
                        int K, int splits, cudaStream_t stream) {
  const long long kps_raw = (static_cast<long long>(K) + splits - 1) / splits;
  const long long k_per_split = (kps_raw + kBK - 1) / kBK * kBK;
  const int col_tiles = (n + kBN - 1) / kBN;
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * col_tiles;
  sketch_fwd_gemm_kernel<kMode, TO>
      <<<dim3(static_cast<unsigned>(tiles), splits), kThreads, 0, stream>>>(
          A, S, ldn, static_cast<const TO*>(acc), static_cast<TO*>(out),
          splits > 1 ? work : nullptr, m, n, K, k_per_split, col_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_splits<TO>(work, acc, out, static_cast<long long>(m) * n,
                           splits, stream);
}

// ---------------------------------------------------------------------------
// 2b. the narrow path (n <= 16)
// ---------------------------------------------------------------------------

// NP: n rounded up to 4, 8 or 16.  R rows a warp, 8 warps a block; the
// Omega slab in chunks of KC rows (a multiple of 128, so the k values a
// lane sums do not depend on the chunking), stored [NP][KC + 4].
template <int NP>
struct Narrow {
  static constexpr int R = NP == 16 ? 4 : 8;
  static constexpr int kRows = (kThreads / 32) * R;
  static constexpr int KC = 24576 / NP;
  static constexpr int LD = KC + 4;
  static constexpr int V = R * NP;       // sums a lane carries
  static constexpr int F = V / 32;       // of them a lane writes
  static constexpr int kSmem = static_cast<int>(sizeof(float)) * NP * LD;
  static_assert(KC % 128 == 0 && V % 32 == 0, "narrow tiling");
};

// Add the 32 lanes' v[0..V) by an xor tree, halving the values a lane
// carries at each level; at the end lane l holds the totals of
// v[F·l .. F·l + F) in v[0..F).  Every total is the same tree of adds.
template <int V, int S>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  constexpr int H = V * S / 32;
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
  if constexpr (S > 1) reduce_scatter<V, S / 2>(v, lane);
}

template <int NP, int kMode, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
    sketch_fwd_narrow_kernel(const void* __restrict__ A,
                             const float* __restrict__ S, int ldn,
                             const TO* acc, TO* out, int m, int n, int K) {
  using P = Narrow<NP>;
  constexpr int R = P::R, KC = P::KC, LD = P::LD, V = P::V, F = P::F;
  extern __shared__ __align__(16) float Ws[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nchunks = (K + KC - 1) / KC;
  const long long groups = (static_cast<long long>(m) + P::kRows - 1) /
                           P::kRows;
  bool resident = false;   // the only chunk is in shared memory
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long r0 = g * P::kRows + static_cast<long long>(warp) * R;
    float v[V];
#pragma unroll
    for (int p = 0; p < V; ++p) v[p] = 0.0f;
    for (int c = 0; c < nchunks; ++c) {
      const int kc0 = c * KC;
      const int kc = min(KC, K - kc0);
      if (nchunks > 1 || !resident) {
        __syncthreads();     // every warp is done with the last chunk
        const int kc4 = min(KC, (kc + 3) / 4 * 4);
#pragma unroll 8
        for (int e = threadIdx.x; e < NP * kc4; e += kThreads) {
          const int k = e / NP, j = e - k * NP;
          Ws[j * LD + k] =
              k < kc && j < n
                  ? S[static_cast<long long>(kc0 + k) * ldn + j]
                  : 0.0f;
        }
        __syncthreads();
        resident = true;
      }
      for (int k4 = lane * 4; k4 < kc; k4 += 128) {
        const long long k = static_cast<long long>(kc0) + k4;
        float a[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r0 + r < m) {
            load4<kMode>(A, (r0 + r) * K + k, k, K, a[r]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) a[r][q] = 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(&Ws[j * LD + k4]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float s = v[r * NP + j];
            s = fmaf(a[r][0], w.x, s);
            s = fmaf(a[r][1], w.y, s);
            s = fmaf(a[r][2], w.z, s);
            s = fmaf(a[r][3], w.w, s);
            v[r * NP + j] = s;
          }
        }
      }
    }
    reduce_scatter<V, 16>(v, lane);
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int p = F * lane + i;
      const int j = p % NP;
      const long long r = r0 + p / NP;
      if (r < m && j < n) {
        const long long idx = r * n + j;
        float o = v[i];
        if (acc != nullptr) o = to_f32(acc[idx]) + o;
        store(out + idx, o);
      }
    }
  }
}

template <int NP, int kMode, typename TO>
cudaError_t launch_narrow_np(const void* A, const float* S, int ldn,
                             const void* acc, void* out, int m, int n, int K,
                             cudaStream_t stream) {
  using P = Narrow<NP>;
  const auto kernel = sketch_fwd_narrow_kernel<NP, kMode, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, P::kSmem)) != cudaSuccess)
    return err;
  const long long groups =
      (static_cast<long long>(m) + P::kRows - 1) / P::kRows;
  const long long blocks =
      std::min(groups, static_cast<long long>(std::max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(blocks), kThreads, P::kSmem, stream>>>(
      A, S, ldn, static_cast<const TO*>(acc), static_cast<TO*>(out), m, n, K);
  return cudaGetLastError();
}

template <int kMode, typename TO>
cudaError_t launch_narrow(const void* A, const float* S, int ldn,
                          const void* acc, void* out, int m, int n, int K,
                          cudaStream_t stream) {
  if (n <= 4)
    return launch_narrow_np<4, kMode, TO>(A, S, ldn, acc, out, m, n, K,
                                          stream);
  if (n <= 8)
    return launch_narrow_np<8, kMode, TO>(A, S, ldn, acc, out, m, n, K,
                                          stream);
  return launch_narrow_np<16, kMode, TO>(A, S, ldn, acc, out, m, n, K,
                                         stream);
}

template <int kMode, typename TO>
cudaError_t launch_fwd(const void* A, const float* S, int ldn,
                       const void* acc, void* out, float* work, int m, int n,
                       int K, int splits, cudaStream_t stream) {
  if (n <= kNarrowMaxN)
    return launch_narrow<kMode, TO>(A, S, ldn, acc, out, m, n, K, stream);
  return launch_wide<kMode, TO>(A, S, ldn, acc, out, work, m, n, K, splits,
                                stream);
}

template <typename TO>
cudaError_t dispatch_fwd(const void* A, int a_mode, const float* S, int ldn,
                         const void* acc, void* out, float* work, int m,
                         int n, int K, int splits, cudaStream_t stream) {
  if (a_mode == kA16)
    return launch_fwd<kA16, TO>(A, S, ldn, acc, out, work, m, n, K, splits,
                                stream);
  if (a_mode == kA4)
    return launch_fwd<kA4, TO>(A, S, ldn, acc, out, work, m, n, K, splits,
                               stream);
  return launch_fwd<kAbf16, TO>(A, S, ldn, acc, out, work, m, n, K, splits,
                                stream);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_gen_omega(void* out, int rows, int cols, uint32_t k0, uint32_t k1,
                 uint32_t row0, uint32_t col0, uint32_t salt, int kind,
                 float scale, void* stream) {
  using namespace repro_torch;
  const long long total = static_cast<long long>(rows) * cols;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  gen_omega_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), rows, cols,
      DrawArgs{PhiloxKey{k0, k1}, row0, col0, salt, kind, scale});
  return static_cast<int>(cudaGetLastError());
}

// A: (m, K) row-major, f32 or bf16 (a_bf16), any base alignment of its
// element type; acc: null or (m, n) row-major of out's type (it may be
// out); out: (m, n) row-major, f32 or bf16 (out_bf16); scratch: f32,
// 16-byte aligned, K·ldn words with ldn = n rounded up to 4; work: with
// splits > 1, f32, 16-byte aligned, splits·m·n words (else unused).
// 1 <= splits <= 64, and 1 when n <= 16 (the narrow path does not split).
int rt_sketch_fwd(const void* A, const void* acc, void* out, void* scratch,
                  void* work, int m, int K, int n, int a_bf16, int out_bf16,
                  int splits, uint32_t k0, uint32_t k1, uint32_t row0,
                  uint32_t col0, uint32_t salt, int kind, float scale,
                  void* stream) {
  using namespace repro_torch;
  if (m <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  if (K < 0 || splits < 1 || splits > kMaxSplits ||
      (n <= kNarrowMaxN && splits != 1) || tiles > INT_MAX ||
      (K > 0 && (scratch == nullptr || misaligned16(scratch))) ||
      (splits > 1 && (work == nullptr || misaligned16(work))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldn = (n + 3) / 4 * 4;
  float* S = static_cast<float*>(scratch);
  const cudaError_t err = draw_omega_slab(
      S, K, n, ldn, DrawArgs{PhiloxKey{k0, k1}, row0, col0, salt, kind, scale},
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int a_mode =
      a_bf16 ? kAbf16 : (!misaligned16(A) && K % 4 == 0 ? kA16 : kA4);
  float* w = static_cast<float*>(work);
  if (out_bf16)
    return static_cast<int>(dispatch_fwd<__nv_bfloat16>(
        A, a_mode, S, ldn, acc, out, w, m, n, K, splits, st));
  return static_cast<int>(
      dispatch_fwd<float>(A, a_mode, S, ldn, acc, out, w, m, n, K, splits,
                          st));
}

// The shared memory a block of this file's kernels takes, for the
// planner's fit: *static_bytes from cudaFuncGetAttributes, *dynamic_bytes
// what the launch asks for.  which: 0 gen_omega_kernel, 1
// omega_slab_draw_kernel, 2 split_reduce_kernel, 3 sketch_fwd_gemm_kernel,
// 4 / 5 / 6 sketch_fwd_narrow_kernel for n <= 4 / 8 / 16.
int rt_sketch_fwd_smem(int which, int* static_bytes, int* dynamic_bytes) {
  using namespace repro_torch;
  cudaError_t err = cudaErrorInvalidValue;
  int dyn = 0;
  if (which == 0) {
    const auto k = gen_omega_kernel;
    err = static_smem(k, static_bytes);
  } else if (which == 1) {
    const auto k = omega_slab_draw_kernel;
    err = static_smem(k, static_bytes);
  } else if (which == 2) {
    const auto k = split_reduce_kernel<float>;
    err = static_smem(k, static_bytes);
  } else if (which == 3) {
    const auto k = sketch_fwd_gemm_kernel<kA16, float>;
    err = static_smem(k, static_bytes);
  } else if (which == 4) {
    const auto k = sketch_fwd_narrow_kernel<4, kA16, float>;
    err = static_smem(k, static_bytes);
    dyn = Narrow<4>::kSmem;
  } else if (which == 5) {
    const auto k = sketch_fwd_narrow_kernel<8, kA16, float>;
    err = static_smem(k, static_bytes);
    dyn = Narrow<8>::kSmem;
  } else if (which == 6) {
    const auto k = sketch_fwd_narrow_kernel<16, kA16, float>;
    err = static_smem(k, static_bytes);
    dyn = Narrow<16>::kSmem;
  }
  *dynamic_bytes = dyn;
  return static_cast<int>(err);
}

}  // extern "C"
