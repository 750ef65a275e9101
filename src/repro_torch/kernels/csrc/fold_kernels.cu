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
// Lanes: y is a device array of lane pointers (each lane's Y is its own
// allocation, updated in place: no stacking copy); d is one contiguous
// (lanes, k, c) buffer; start and nvalid are device int32 arrays.  Nothing
// is read back to the host.
//
// What bounds it: bytes.  Each live element reads y and d and writes y,
// with no arithmetic to speak of.  The grid is (column tiles of 32, row
// tiles of 8, lanes); in the masked form a block walks only the rows that
// can be live (at most `span` = max nvalid of them, starting at lane i's
// first live row), so a Y of 16384 rows costs only its k live rows, not
// m.  A warp reads 32 consecutive columns of one row: 128 bytes in f32.
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

constexpr int kCols = 32, kRows = 8;

template <typename TY, typename TD, bool kMasked>
__global__ void __launch_bounds__(kCols * kRows)
    fold_rows_kernel(TY* const* __restrict__ ys, const TD* __restrict__ d,
                     const int* __restrict__ start,
                     const int* __restrict__ nvalid, int m, int k, int c) {
  const int lane = blockIdx.z;
  const int col = blockIdx.x * kCols + threadIdx.x;
  if (col >= c) return;
  const long long s = start[lane];
  const long long s_clamped = min(max(s, 0LL), static_cast<long long>(m) + k);
  long long lo = 0, hi = m;
  if (kMasked) {
    lo = max(0LL, m - s);
    hi = min(static_cast<long long>(m),
             static_cast<long long>(m) + nvalid[lane] - s);
  }
  TY* y = ys[lane];
  const TD* dl = d + static_cast<long long>(lane) * k * c;
  for (long long row = lo + blockIdx.y * kRows + threadIdx.y; row < hi;
       row += static_cast<long long>(gridDim.y) * kRows) {
    const long long src = s_clamped + row - m;
    float w = 0.0f;
    if (src >= 0 && src < k) w = load_f32(dl + src * c + col);
    TY* p = y + row * c + col;
    store_f32(p, load_f32(p) + w);
  }
}

template <typename TY, typename TD>
void launch_fold(void* const* ys, const void* d, const int* start,
                 const int* nvalid, int lanes, int m, int k, int c, int span,
                 cudaStream_t stream) {
  const int row_tiles = (span + kRows - 1) / kRows;
  const dim3 grid((c + kCols - 1) / kCols, row_tiles < 65535 ? row_tiles
                                                             : 65535,
                  lanes);
  const dim3 block(kCols, kRows);
  auto y = reinterpret_cast<TY* const*>(ys);
  auto dd = static_cast<const TD*>(d);
  if (nvalid != nullptr)
    fold_rows_kernel<TY, TD, true>
        <<<grid, block, 0, stream>>>(y, dd, start, nvalid, m, k, c);
  else
    fold_rows_kernel<TY, TD, false>
        <<<grid, block, 0, stream>>>(y, dd, start, nvalid, m, k, c);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// ys: device array of `lanes` pointers to (m, c) row-major y's; d: device
// (lanes, k, c) row-major; start, nvalid: device int32[lanes] (nvalid null
// for the unmasked form); span: the number of rows a lane can change (the
// largest nvalid, or m unmasked), which sizes the grid.
int rt_fold_rows(void* const* ys, const void* d, const int* start,
                 const int* nvalid, int lanes, int m, int k, int c, int span,
                 int y_bf16, int d_bf16, void* stream) {
  using namespace repro_torch;
  if (lanes <= 0 || m <= 0 || c <= 0 || span <= 0)
    return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (!y_bf16 && !d_bf16)
    launch_fold<float, float>(ys, d, start, nvalid, lanes, m, k, c, span, st);
  else if (!y_bf16 && d_bf16)
    launch_fold<float, __nv_bfloat16>(ys, d, start, nvalid, lanes, m, k, c,
                                      span, st);
  else if (y_bf16 && !d_bf16)
    launch_fold<__nv_bfloat16, float>(ys, d, start, nvalid, lanes, m, k, c,
                                      span, st);
  else
    launch_fold<__nv_bfloat16, __nv_bfloat16>(ys, d, start, nvalid, lanes, m,
                                              k, c, span, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
