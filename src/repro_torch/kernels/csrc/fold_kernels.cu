// The row-slab fold of the port, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_fold_rows — K4: y_i <- y_i + [0_m; d_i; 0_m][start_i : start_i + m]
//                  for every lane i, y_i updated in place, optionally
//                  masked to the first nvalid_i rows of d_i.  Replaces
//                  src/repro/kernels/local.py `_fold_rows_pallas` (body
//                  `_fold_rows_body`), and the `jax.vmap` of it over lanes
//                  that src/repro/stream/state.py `local_rowblock_ragged_prog`
//                  builds.
//
// Semantics, exactly those of the reference (`_fold_rows_jnp`):
//   * the frame [0_m; d; 0_m] is never built: a y row reads d row
//     `clamp(start, 0, m + k) + row - m` when that lies in [0, k), else 0
//     (jax.lax.dynamic_slice clamps `start` into [0, m + k]);
//   * the mask uses the UNCLAMPED start: row is live iff
//     m <= start + row < m + nvalid.  A row that is not live is not
//     written at all, so it keeps y's exact bits (a resident -0.0 stays
//     -0.0, and a NaN in a dead row of d never reaches y);
//   * the unmasked form writes every row as y + win, so outside the
//     window -0.0 becomes +0.0, as in the reference.
//   * the sum is taken in f32 and rounded once to y's type: a bf16 y with
//     an f32 d is rounded once, which is what keeps a lane of the ragged
//     update bitwise equal to the solo update (`acc + dot`, one rounding).
//
// What bounds it: bytes.  Each live element reads y and d and writes y,
// with no arithmetic to speak of: at the service's bucket (64 lanes of
// kb = 256 rows, heights in (128, 256], r = 128, f32) about 18.9 MB, 5.6 us
// at 3.35 TB/s.  The design serves that bound:
//   * Lane metadata by value.  A launch takes up to kLaneCap = 240 lanes;
//     their y pointers, starts and nvalids (16 bytes a lane) travel in the
//     launch's parameter block as one `__grid_constant__` struct, so a
//     block reads its lane's words from the constant bank (the lane index
//     is blockIdx.y, uniform) and the struct is never copied to local
//     memory.  3,872 bytes in all: inside the classic 4 KB parameter limit,
//     without the 32 KB of CUDA >= 12.1.  rt_fold_rows copies the lanes
//     from a host buffer into the struct: no device metadata, no pinned
//     buffer, no host-to-device copy.  A bucket of more lanes is several
//     launches of this kernel on the same stream (the caller's loop).
//   * Only live rows.  The grid is (chunks of `rows` rows, lanes); a block
//     covers rows [lo + x·rows, ...) of its lane's live rows [lo, hi) (all
//     m rows unmasked), flattened with the columns into vector slots, so a
//     Y of 16384 rows costs its k live rows, not m.  Blocks past hi exit.
//   * 16-byte vectors.  When every y base and d's base sit on a multiple of
//     the access and c % 4 == 0 (the caller decides from the pointers; this
//     file refuses a vector launch that does not fit), a thread moves 4
//     columns at once: 16 bytes of f32, 8 of bf16.  Otherwise the same
//     kernel, instantiated with V = 1, moves one element at a time.
//   * Several rows in flight.  A thread takes kUnroll = 4 slots a pass,
//     kThreads apart, issues all their y and d loads, then adds and stores.
//     d is read once, with streaming loads (ld.global.cs).
// On an H100 at that bucket the kernel takes about 0.005 ms back to back
// (its 14 MB stay in the 50 MB L2) and 0.007-0.008 ms from device memory
// (the L2 flushed by a read), 73-77% of the byte bound; blocks of 64, 128
// or 512 threads, 2 or 8 slots in flight and streaming stores of y were no
// faster.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace repro_torch {
namespace {

constexpr int kLaneCap = 240;              // FOLD_LANE_CAPACITY
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kSlots = kThreads * kUnroll;  // FOLD_BLOCK_SLOTS

struct FoldParams {
  void* y[kLaneCap];
  int start[kLaneCap];
  int nvalid[kLaneCap];
  const void* d;  // (lanes, k, c) row-major, this launch's first lane
  int m, k, c;
  int rows;       // rows a block
  int slots;      // vector slots a row: c / V
};
static_assert(sizeof(FoldParams) <= 4096,
              "the lanes must fit the 4 KB parameter block");

// V elements of T as they move in one access.
template <typename T, int V>
struct Access;
template <>
struct Access<float, 1> {
  using type = float;
};
template <>
struct Access<float, 4> {
  using type = float4;
};
template <>
struct Access<__nv_bfloat16, 1> {
  using type = unsigned short;
};
template <>
struct Access<__nv_bfloat16, 4> {
  using type = uint2;
};

__device__ __forceinline__ float bf16_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);  // exact, as __bfloat162float
}
__device__ __forceinline__ uint32_t f32_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void unpack(float4 v, float (&f)[4]) {
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void unpack(unsigned short v, float (&f)[1]) {
  f[0] = bf16_f32(v);
}
__device__ __forceinline__ void unpack(uint2 v, float (&f)[4]) {
  f[0] = bf16_f32(v.x & 0xFFFFu);
  f[1] = bf16_f32(v.x >> 16);
  f[2] = bf16_f32(v.y & 0xFFFFu);
  f[3] = bf16_f32(v.y >> 16);
}

__device__ __forceinline__ void pack(const float (&f)[1], float& v) {
  v = f[0];
}
__device__ __forceinline__ void pack(const float (&f)[4], float4& v) {
  v = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack(const float (&f)[1], unsigned short& v) {
  v = static_cast<unsigned short>(f32_bf16(f[0]));
}
__device__ __forceinline__ void pack(const float (&f)[4], uint2& v) {
  v.x = f32_bf16(f[0]) | (f32_bf16(f[1]) << 16);
  v.y = f32_bf16(f[2]) | (f32_bf16(f[3]) << 16);
}

template <typename TY, typename TD, int V, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    fold_rows_kernel(const __grid_constant__ FoldParams p) {
  using AY = typename Access<TY, V>::type;
  using AD = typename Access<TD, V>::type;
  const int lane = blockIdx.y;
  const long long m = p.m, k = p.k;
  const long long s = p.start[lane];
  long long lo = 0, hi = m;
  if (kMasked) {
    lo = max(0LL, m - s);
    hi = min(m, m + p.nvalid[lane] - s);
  }
  const long long row0 = lo + static_cast<long long>(blockIdx.x) * p.rows;
  if (row0 >= hi) return;
  const int slots = p.slots;
  const int items =
      static_cast<int>(min(static_cast<long long>(p.rows), hi - row0)) *
      slots;
  // y row `row` reads d row `row + shift` (the clamped start's window)
  const long long shift = min(max(s, 0LL), m + k) - m;
  AY* y = reinterpret_cast<AY*>(static_cast<TY*>(p.y[lane]));
  const AD* d = reinterpret_cast<const AD*>(static_cast<const TD*>(p.d) +
                                            lane * k * p.c);
  for (int base = 0; base < items; base += kSlots) {
    AY yv[kUnroll];
    AD dv[kUnroll];
    long long at[kUnroll];
    bool in[kUnroll], fed[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = base + u * kThreads + static_cast<int>(threadIdx.x);
      const int r = it / slots;
      const long long row = row0 + r;
      const long long col = it - r * slots;
      const long long src = row + shift;
      in[u] = it < items;
      fed[u] = in[u] && src >= 0 && src < k;
      at[u] = row * slots + col;
      if (in[u]) yv[u] = y[at[u]];
      if (fed[u]) dv[u] = __ldcs(d + src * slots + col);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!in[u]) continue;
      float a[V], w[V];
      unpack(yv[u], a);
      if (fed[u]) {
        unpack(dv[u], w);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) w[q] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < V; ++q) a[q] = a[q] + w[q];
      pack(a, yv[u]);
      y[at[u]] = yv[u];
    }
  }
}

template <typename TY, typename TD, int V>
void launch_fold(const FoldParams& p, int lanes, int span, bool masked,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(
                      (static_cast<long long>(span) + p.rows - 1) / p.rows),
                  lanes);
  if (masked)
    fold_rows_kernel<TY, TD, V, true><<<grid, kThreads, 0, stream>>>(p);
  else
    fold_rows_kernel<TY, TD, V, false><<<grid, kThreads, 0, stream>>>(p);
}

template <typename TY, typename TD>
void launch_fold(const FoldParams& p, int lanes, int span, bool masked,
                 int vec, cudaStream_t stream) {
  if (vec == 4)
    launch_fold<TY, TD, 4>(p, lanes, span, masked, stream);
  else
    launch_fold<TY, TD, 1>(p, lanes, span, masked, stream);
}

bool on(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// One launch as the caller packs it in host memory (little-endian, no
// padding; sketch_matmul.py `_fold_pack`): this header, then n uint64 y
// pointers, n int32 starts and n int32 nvalids.
struct FoldCall {
  uint64_t d;     // device (n, k, c) row-major, this launch's first lane
  int32_t n, m, k, c;
  int32_t span;   // rows a lane can change: min(m, max nvalid), or m
  int32_t masked, vec, rows, y_bf16, d_bf16;
};
static_assert(sizeof(FoldCall) == 48, "FoldCall is packed as <Q10i");

}  // namespace
}  // namespace repro_torch

extern "C" {

// call: HOST memory, a FoldCall and its n <= 240 lanes (nvalids read only
// when masked).  vec: 4 (every y base and d on a multiple of the 4-element
// access, c % 4 == 0) or 1.  rows: rows a block (at least 1).  One launch
// on `stream`; returns cudaErrorInvalidValue for anything else, without
// launching.
int rt_fold_rows(const void* call, void* stream) {
  using namespace repro_torch;
  FoldCall h;
  std::memcpy(&h, call, sizeof(h));
  const int n = h.n, c = h.c, vec = h.vec;
  if (n <= 0 || n > kLaneCap || h.m <= 0 || h.k < 0 || c <= 0 ||
      h.span <= 0 || h.rows <= 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && c % 4 != 0) ||
      // a block's slots, rows x c / vec, and a pass past them fit an int
      static_cast<long long>(h.rows) * (c / vec) > INT_MAX - kSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  FoldParams p;
  const auto* lanes = static_cast<const unsigned char*>(call) + sizeof(h);
  std::memcpy(p.y, lanes, sizeof(void*) * n);
  std::memcpy(p.start, lanes + sizeof(void*) * n, sizeof(int) * n);
  if (h.masked)
    std::memcpy(p.nvalid, lanes + (sizeof(void*) + sizeof(int)) * n,
                sizeof(int) * n);
  p.d = reinterpret_cast<const void*>(h.d);
  const int y_access = vec * (h.y_bf16 ? 2 : 4);
  if (!on(p.d, vec * (h.d_bf16 ? 2 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i)
    if (!on(p.y[i], y_access)) return static_cast<int>(cudaErrorInvalidValue);
  p.m = h.m;
  p.k = h.k;
  p.c = c;
  p.rows = h.rows;
  p.slots = c / vec;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool mk = h.masked != 0;
  if (!h.y_bf16 && !h.d_bf16)
    launch_fold<float, float>(p, n, h.span, mk, vec, st);
  else if (!h.y_bf16 && h.d_bf16)
    launch_fold<float, __nv_bfloat16>(p, n, h.span, mk, vec, st);
  else if (h.y_bf16 && !h.d_bf16)
    launch_fold<__nv_bfloat16, float>(p, n, h.span, mk, vec, st);
  else
    launch_fold<__nv_bfloat16, __nv_bfloat16>(p, n, h.span, mk, vec, st);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block of fold_rows_kernel takes, for the planner's
// fit: *static_bytes from cudaFuncGetAttributes; it asks for no dynamic
// shared memory.
int rt_fold_rows_smem(int* static_bytes, int* dynamic_bytes) {
  using namespace repro_torch;
  cudaFuncAttributes attr;
  const auto k = fold_rows_kernel<float, float, 4, true>;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err == cudaSuccess) *static_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_bytes = 0;
  return static_cast<int>(err);
}

}  // extern "C"
