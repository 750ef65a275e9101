// The sparse fold of the port's COO row slabs, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (src/repro_torch/kernels/sketch_matmul.py).
//
//   rt_sparse_fold — S1: for every destination segment s of acc (a row of
//                    it, or a column) and every element j of the segment,
//
//                      sum = from_zero ? 0 : acc[s, j]
//                      for each entry e of segment s, in entry order:
//                          sum = T(sum + T(val[e] * x[e, j]))
//                      acc[s, j] = from_zero ? T(acc[s, j] + sum) : sum
//
//                    where x[e, j] = table[src[e], j] (the dense kinds: a
//                    row of the Omega tile, or of Psi's) or, for the sparse
//                    kinds, coef[e] at j == cell[e] and nothing elsewhere
//                    (one cell an entry).  T is the stream's type.
//
// It replaces no Pallas kernel: the reference's sparse update is a plain
// XLA scatter (src/repro/stream/state.py:368 `_local_sparse_update`), which
// adds in entry order, rounding to the stream's type at each product and
// each add.  This kernel gives those bits in one launch, with no atomics:
//   * The host hands it a CSR over destinations (a stable sort, so entry
//     order survives within a destination): ptr[s] .. ptr[s+1] are the
//     entries of segment s, and val / src / cell / coef come in that order.
//   * One lane owns an element of a segment for the whole walk, so nothing
//     is summed by two threads and the order is fixed.  The lanes of a warp
//     hold elements of ONE segment and walk its entries together.
//   * Products and adds are __fmul_rn / __fadd_rn, which nvcc never
//     contracts into an FMA.  A bfloat16 stream computes each in f32 and
//     rounds to bfloat16 after it (__float2bfloat16_rn): what XLA and torch
//     do on the CPU; no f32 partial is carried across entries.
//   * from_zero (the range sketch's dY): every segment is written, also one
//     with no entries (acc + 0.0 turns a -0.0 into +0.0, as the reference's
//     `Yk + dY` does).  Otherwise (the co-range sketch's W, which the
//     reference accumulates straight into itself) a segment with no entries
//     keeps its bits, and so does an element of a sparse-kind segment that
//     no entry names.
//
// What bounds it: bytes (each gathered table row, the segments it changes
// read and written once, the CSR payload).  Two things stand between it and
// them.
//   * A chain of dependent loads: each entry's index, then its table row.
//     Both forms load up to 32 of a segment's entries at once (one a lane,
//     one coalesced read), hand them round with __shfl_sync, and issue the
//     table loads of kAhead entries before the ordered adds that use them,
//     so the loads overlap and the adds keep their order.  In the sparse
//     kinds a ballot over the prefetched cells finds the entries that name
//     one of the warp's elements; only their owners add, and a warp that
//     owns none skips the walk.  kAhead is measured, not maximal: a
//     distinct table row is gathered once an entry (at a full-width slab
//     an Omega row about 4 times, a Psi row about 34), so on the H100 the
//     gathers are bound by the L2's throughput more than by latency; the
//     tile form was fastest at 2 ahead (4 and 8 slower), the rows form at
//     8 (2, 4 and 16 slower).
//   * Strided segments.  W is row-major (l, n2) and its segments are its
//     columns (axis 1), so a warp's 32 elements of one column are 32 rows
//     of W and every load or store of them takes a sector of its own.  The
//     tile form stages W through shared memory instead: a block owns kTC
//     consecutive columns (128 bytes of a row: 32 f32 or 64 bf16) by at
//     most kTileRows rows, reads them in whole 128-byte rows (16-byte
//     vectors where the rows are aligned), lets its warps walk the columns
//     out of shared memory (a row of the table is contiguous along the
//     segment, so those reads are whole lines too) and writes the rows
//     back.  Tile rows are padded by one word, so a warp's walk down a
//     column hits 32 banks.  A tile with no entry is neither read nor
//     written (unless from_zero); an untouched column of a touched tile
//     goes back as the bits it came with.
//   Rows of acc (axis 0, the Y fold) are contiguous already: the rows form
//   keeps a warp on 32 elements of one row and a block on kWarps rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kLanes = 32;           // elements of a segment a warp takes at once
constexpr int kWarps = 8;            // warps a block, both forms
constexpr int kThreads = kLanes * kWarps;
constexpr int kRowBytes = 128;       // a row of the tile: one 128-byte line
constexpr int kPitch = kRowBytes / 4 + 1;  // a tile row in shared memory, words
constexpr int kSlots = 4;            // elements a lane holds in the tile form
constexpr int kTileRows = kLanes * kSlots;  // most rows (elements) a tile
constexpr int kAheadRows = 8;        // entries loaded ahead of the adds, rows form
constexpr int kAheadTile = 2;        // ... tile form (kSlots loads an entry)
constexpr unsigned kFull = 0xffffffffu;

enum Form { kRowsForm = 0, kTileForm = 1 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Num<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <typename T>
__device__ __forceinline__ float add_product(float sum, float v, float x) {
  return Num<T>::round(__fadd_rn(sum, Num<T>::round(__fmul_rn(v, x))));
}

// One warp folds the entries lo .. hi of one segment, in entry order, into
// x[i], the sum of element j0 + lane + 32·i of the segment (i < NI).  An
// element at or past `end` reads no table word and must not be stored;
// `width` is the table's row length.  Bit i of `named` is set when an entry
// named element i (the sparse kinds; the dense kinds name every element).
template <typename T, int NI, int kAhead, bool kDense>
__device__ __forceinline__ void walk(float (&x)[NI], unsigned& named, int lo,
                                     int hi, int j0, int end, int width,
                                     const T* __restrict__ val,
                                     const T* __restrict__ table,
                                     const int* __restrict__ src,
                                     const int* __restrict__ cell,
                                     const T* __restrict__ coef) {
  const int lane = threadIdx.x;
  for (int base = lo; base < hi; base += kLanes) {
    const int n = min(kLanes, hi - base);
    int idx = 0;        // src (dense) or cell (sparse) of entry base + lane
    float v = 0.0f;     // val; for the sparse kinds the rounded product
    if (lane < n) {
      v = Num<T>::load(val + base + lane);
      if (kDense) {
        idx = src[base + lane];
      } else {
        idx = cell[base + lane];
        v = Num<T>::round(__fmul_rn(v, Num<T>::load(coef + base + lane)));
      }
    }
    if (kDense) {
      for (int q0 = 0; q0 < n; q0 += kAhead) {
        float t[kAhead][NI];
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
          const int r = __shfl_sync(kFull, idx, (q0 + d) % kLanes);
          const T* row = table + static_cast<long long>(r) * width + j0 + lane;
#pragma unroll
          for (int i = 0; i < NI; ++i)
            t[d][i] = q0 + d < n && j0 + lane + kLanes * i < end
                          ? Num<T>::load(row + kLanes * i)
                          : 0.0f;
        }
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
          const float vd = __shfl_sync(kFull, v, (q0 + d) % kLanes);
          if (q0 + d < n) {
#pragma unroll
            for (int i = 0; i < NI; ++i)
              x[i] = add_product<T>(x[i], vd, t[d][i]);
          }
        }
      }
      named = (1u << NI) - 1;
    } else {
      const int off = idx - j0;
      unsigned mine = __ballot_sync(
          kFull, lane < n && off >= 0 && off < min(kLanes * NI, end - j0));
      while (mine != 0) {            // the entries that name our elements
        const int q = __ffs(mine) - 1;
        mine &= mine - 1;
        const int o = __shfl_sync(kFull, off, q);
        const float prod = __shfl_sync(kFull, v, q);
        if (lane == o % kLanes) {
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (i == o / kLanes) {
              x[i] = Num<T>::round(__fadd_rn(x[i], prod));
              named |= 1u << i;
            }
          }
        }
      }
    }
  }
}

// The rows form (elem_stride 1): block (32, kWarps), warp y takes segment
// blockIdx.x·kWarps + y, lane x its element blockIdx.y·32 + x.
template <typename T, bool kDense, bool kFromZero>
__global__ void __launch_bounds__(kThreads)
sparse_fold_rows_kernel(T* acc, int nseg, int width, long long seg_stride,
                        const int* __restrict__ ptr, const T* __restrict__ val,
                        const T* __restrict__ table,
                        const int* __restrict__ src,
                        const int* __restrict__ cell,
                        const T* __restrict__ coef) {
  const int s = blockIdx.x * kWarps + threadIdx.y;
  if (s >= nseg) return;                // the whole warp
  const int lo = ptr[s];
  const int hi = ptr[s + 1];
  if (!kFromZero && lo == hi) return;  // an untouched segment keeps its bits
  const int j0 = blockIdx.y * kLanes;
  const bool live = j0 + threadIdx.x < width;
  T* dst = acc + s * seg_stride + j0 + threadIdx.x;
  float x[1] = {kFromZero || !live ? 0.0f : Num<T>::load(dst)};
  unsigned named = 0;
  walk<T, 1, kAheadRows, kDense>(x, named, lo, hi, j0, width, width, val,
                                 table, src, cell, coef);
  if (!live) return;
  if (kFromZero)
    Num<T>::store(dst, __fadd_rn(Num<T>::load(dst), x[0]));
  else if (named != 0)
    Num<T>::store(dst, x[0]);  // rounds to T: exact, x[0] is a T already
}

// The tile form (seg_stride 1, elem_stride `pitch`): block (32, kWarps)
// owns segments s0 .. s0 + kTC and elements j0 .. j0 + rows, staged in
// shared memory as `rows` tile rows of kPitch words, then ptr[s0 .. s0 +
// kTC].  Warp y walks columns y, y + kWarps, ...; lane x holds rows x + 32·i.
template <typename T, bool kDense, bool kFromZero>
__global__ void __launch_bounds__(kThreads)
sparse_fold_tile_kernel(T* acc, int nseg, int width, int rows,
                        long long pitch, bool vec,
                        const int* __restrict__ ptr, const T* __restrict__ val,
                        const T* __restrict__ table,
                        const int* __restrict__ src,
                        const int* __restrict__ cell,
                        const T* __restrict__ coef) {
  using Bits = typename Num<T>::Bits;
  constexpr int kTC = kRowBytes / sizeof(T);   // segments a tile
  constexpr int kPitchT = kPitch * 4 / sizeof(T);
  constexpr int kVec = 16 / sizeof(T);         // elements a 16-byte vector
  constexpr int kVecs = kRowBytes / 16;        // vectors a tile row
  extern __shared__ uint32_t tile[];
  const int s0 = blockIdx.x * kTC;
  const int j0 = blockIdx.y * rows;
  const int tc = min(kTC, nseg - s0);          // segments of this tile
  const int tr = min(rows, width - j0);        // its rows
  if (!kFromZero && ptr[s0] == ptr[s0 + tc]) return;  // no entry: untouched
  int* sptr = reinterpret_cast<int*>(tile + rows * kPitch);
  Bits* tb = reinterpret_cast<Bits*>(tile);
  const int t = threadIdx.x + kLanes * threadIdx.y;
  T* base = acc + j0 * pitch + s0;
  if (t <= tc) sptr[t] = ptr[s0 + t];
  if (vec && tc == kTC) {                      // whole 128-byte rows
    for (int e = t; e < tr * kVecs; e += kThreads) {
      const int r = e / kVecs, c = e % kVecs;
      const uint4 w =
          *reinterpret_cast<const uint4*>(base + r * pitch + c * kVec);
      uint32_t* dst = tile + r * kPitch + 4 * c;
      dst[0] = w.x;
      dst[1] = w.y;
      dst[2] = w.z;
      dst[3] = w.w;
    }
  } else {
    const Bits* src_bits = reinterpret_cast<const Bits*>(base);
    for (int e = t; e < tr * kTC; e += kThreads) {
      const int r = e / kTC, c = e % kTC;
      if (c < tc) tb[r * kPitchT + c] = src_bits[r * pitch + c];
    }
  }
  __syncthreads();
  T* ts = reinterpret_cast<T*>(tile);
  const int lane = threadIdx.x;
  for (int c = threadIdx.y; c < tc; c += kWarps) {
    const int lo = sptr[c];
    const int hi = sptr[c + 1];
    if (!kFromZero && lo == hi) continue;      // goes back with its bits
    float x[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = lane + kLanes * i;
      x[i] = kFromZero || r >= tr ? 0.0f : Num<T>::load(ts + r * kPitchT + c);
    }
    unsigned named = 0;
    walk<T, kSlots, kAheadTile, kDense>(x, named, lo, hi, j0, j0 + tr, width,
                                        val, table, src, cell, coef);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = lane + kLanes * i;
      if (r >= tr) continue;
      T* e = ts + r * kPitchT + c;
      if (kFromZero)
        Num<T>::store(e, __fadd_rn(Num<T>::load(e), x[i]));
      else if (named >> i & 1u)
        Num<T>::store(e, x[i]);
    }
  }
  __syncthreads();
  if (vec && tc == kTC) {
    for (int e = t; e < tr * kVecs; e += kThreads) {
      const int r = e / kVecs, c = e % kVecs;
      const uint32_t* s = tile + r * kPitch + 4 * c;
      *reinterpret_cast<uint4*>(base + r * pitch + c * kVec) =
          make_uint4(s[0], s[1], s[2], s[3]);
    }
  } else {
    Bits* dst_bits = reinterpret_cast<Bits*>(base);
    for (int e = t; e < tr * kTC; e += kThreads) {
      const int r = e / kTC, c = e % kTC;
      if (c < tc) dst_bits[r * pitch + c] = tb[r * kPitchT + c];
    }
  }
}

struct Launch {
  void* acc;
  int nseg, width;
  long long seg_stride, elem_stride;
  const int* ptr;
  const void* val;
  const void* table;
  const int* src;
  const int* cell;
  const void* coef;
  bool from_zero;
  int form, rows, smem;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T, bool kDense, bool kFromZero>
void launch_kernel(const Launch& a) {
  const dim3 block(kLanes, kWarps);
  T* acc = static_cast<T*>(a.acc);
  const T* val = static_cast<const T*>(a.val);
  const T* table = static_cast<const T*>(a.table);
  const T* coef = static_cast<const T*>(a.coef);
  if (a.form == kRowsForm) {
    sparse_fold_rows_kernel<T, kDense, kFromZero>
        <<<a.grid, block, 0, a.stream>>>(acc, a.nseg, a.width, a.seg_stride,
                                         a.ptr, val, table, a.src, a.cell,
                                         coef);
  } else {
    const bool vec = reinterpret_cast<uintptr_t>(a.acc) % 16 == 0
                     && a.elem_stride * sizeof(T) % 16 == 0;
    sparse_fold_tile_kernel<T, kDense, kFromZero>
        <<<a.grid, block, a.smem, a.stream>>>(
            acc, a.nseg, a.width, a.rows, a.elem_stride, vec, a.ptr, val,
            table, a.src, a.cell, coef);
  }
}

template <typename T>
void launch(const Launch& a) {
  const bool dense = a.table != nullptr;
  if (dense && a.from_zero) launch_kernel<T, true, true>(a);
  else if (dense) launch_kernel<T, true, false>(a);
  else if (a.from_zero) launch_kernel<T, false, true>(a);
  else launch_kernel<T, false, false>(a);
}

long long blocks(long long n, long long per) { return (n + per - 1) / per; }

// Whether (form, tc, rows, smem, grid) is the launch the plan of
// sparse_fold_plan (sketch_matmul.py) gives for this call.
bool plan_fits(int size, int nseg, int width, long long seg_stride,
               long long elem_stride, int form, int tc, int rows, int smem,
               int grid_x, int grid_y) {
  if (form == kRowsForm)
    return elem_stride == 1 && tc == kWarps && rows == kLanes && smem == 0
           && grid_x == blocks(nseg, kWarps) && grid_y == blocks(width, kLanes);
  if (form == kTileForm)
    return seg_stride == 1 && tc == kRowBytes / size && rows >= 1
           && rows <= kTileRows
           && smem == (rows * kPitch + tc + 1) * 4
           && grid_x == blocks(nseg, tc) && grid_y == blocks(width, rows)
           && grid_y <= 65535;
  return false;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// dtype: 0 float32, 1 bfloat16 (acc, val, table and coef alike).  Exactly
// one form: table and src (dense), or cell and coef (sparse); the other
// pair null.  ptr has nseg + 1 entries; val, src, cell and coef have nnz,
// in CSR order (null when nnz is 0: an empty tensor has no address).
// acc[s, j] sits at acc + s·seg_stride + j·elem_stride.  form, tc, rows,
// smem and grid are sparse_fold_plan's (0 the rows form, elem_stride 1;
// 1 the tile form, seg_stride 1); a plan that does not fit is refused.
int rt_sparse_fold(void* acc, int dtype, int nseg, int width, int nnz,
                   long long seg_stride, long long elem_stride,
                   const void* ptr, const void* val, const void* table,
                   const void* src, const void* cell, const void* coef,
                   int from_zero, int form, int tc, int rows, int smem,
                   int grid_x, int grid_y, void* stream) {
  using repro_torch::kLanes;
  if (nseg <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const bool dense = table != nullptr;
  const bool entries = nnz > 0;
  if (acc == nullptr || ptr == nullptr || nnz < 0
      || (entries && (val == nullptr
                      || (dense ? (src == nullptr || cell != nullptr
                                   || coef != nullptr)
                                : (cell == nullptr || coef == nullptr
                                   || src != nullptr))))
      || (width + kLanes - 1) / kLanes > 65535 || dtype < 0 || dtype > 1
      || !repro_torch::plan_fits(dtype == 0 ? 4 : 2, nseg, width, seg_stride,
                                 elem_stride, form, tc, rows, smem, grid_x,
                                 grid_y))
    return static_cast<int>(cudaErrorInvalidValue);
  const repro_torch::Launch a{
      acc, nseg, width, seg_stride, elem_stride,
      static_cast<const int*>(ptr), val, table,
      static_cast<const int*>(src), static_cast<const int*>(cell), coef,
      from_zero != 0, form, rows, smem,
      dim3(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y)),
      static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    repro_torch::launch<float>(a);
  else
    repro_torch::launch<__nv_bfloat16>(a);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a block of S1 takes, for the planner's fit:
// *static_bytes from cudaFuncGetAttributes, *dynamic_bytes the most a
// launch asks for (the tile form's f32 tile of kTileRows rows and its
// kTC + 1 offsets; the rows form asks for none).  which: 0 the rows form,
// 1 the tile form.
int rt_sparse_fold_smem(int which, int* static_bytes, int* dynamic_bytes) {
  using namespace repro_torch;
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  int dyn = 0;
  if (which == 0) {
    const auto k = sparse_fold_rows_kernel<float, true, false>;
    err = cudaFuncGetAttributes(&attr, k);
  } else if (which == 1) {
    const auto k = sparse_fold_tile_kernel<float, true, false>;
    err = cudaFuncGetAttributes(&attr, k);
    dyn = 4 * (kTileRows * kPitch + kRowBytes / 4 + 1);
  }
  if (err == cudaSuccess) *static_bytes = static_cast<int>(attr.sharedSizeBytes);
  *dynamic_bytes = dyn;
  return static_cast<int>(err);
}

}  // extern "C"
