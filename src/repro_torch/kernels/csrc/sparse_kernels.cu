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
// It has no Pallas counterpart: the reference's sparse update is a plain
// XLA scatter (src/repro/stream/state.py `_local_sparse_update`), which adds
// in entry order, rounding to the stream's type at each product and each
// add.  This kernel gives those bits in one launch, with no atomics:
//   * The host hands it a CSR over destinations (a stable sort, so entry
//     order survives within a destination): ptr[s] .. ptr[s+1] are the
//     entries of segment s, and val / src / cell / coef come in that order.
//   * One thread owns one element of one segment for the whole walk, so
//     nothing is summed by two threads and the order is fixed.  A warp takes
//     32 elements of ONE segment: its 32 lanes walk the same entries in step
//     (no divergence), read the entry's index and value as a broadcast, and
//     for the dense kinds read 32 neighbouring words of the table row.
//   * Products and adds are __fmul_rn / __fadd_rn, which nvcc never
//     contracts into an FMA.  A bfloat16 stream computes each in f32 and
//     rounds to bfloat16 after it (__float2bfloat16_rn): what XLA and torch
//     do on the CPU; no f32 partial is carried across entries.
//   * from_zero (the range sketch's dY): every segment is written, also one
//     with no entries (acc + 0.0 turns a -0.0 into +0.0, as the reference's
//     `Yk + dY` does).  Otherwise (the co-range sketch's W, which the
//     reference accumulates straight into itself) a segment with no entries
//     is not read or written at all.
// What bounds it: bytes.  Each thread reads one table word (or one cell
// test) an entry of its segment and reads and writes its own element once.
// A segment that is a column of a row-major W (axis 1) is strided by the
// row length, so a warp's 32 elements are 32 rows: its loads and stores
// take a sector each, and only the block's 8 neighbouring columns share a
// sector.  That is the simple first design; a layout that keeps W's columns
// of a block in shared memory is for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kLanes = 32;  // elements of one segment a warp takes
constexpr int kSegs = 8;    // segments a block takes, one a warp

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Num<__nv_bfloat16> {
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

template <typename T, bool kDense, bool kFromZero>
__global__ void __launch_bounds__(kLanes * kSegs)
sparse_fold_kernel(T* acc, int nseg, int width, long long seg_stride,
                   long long elem_stride, const int* __restrict__ ptr,
                   const T* __restrict__ val, const T* __restrict__ table,
                   const int* __restrict__ src, const int* __restrict__ cell,
                   const T* __restrict__ coef) {
  const int s = blockIdx.x * kSegs + threadIdx.y;
  const int j = blockIdx.y * kLanes + threadIdx.x;
  if (s >= nseg || j >= width) return;
  const int lo = ptr[s];
  const int hi = ptr[s + 1];
  if (!kFromZero && lo == hi) return;  // an untouched segment keeps its bits
  T* dst = acc + s * seg_stride + j * elem_stride;
  float sum = kFromZero ? 0.0f : Num<T>::load(dst);
  for (int p = lo; p < hi; ++p) {
    float x;
    if (kDense) {
      x = Num<T>::load(table + static_cast<long long>(src[p]) * width + j);
    } else {
      if (cell[p] != j) continue;
      x = Num<T>::load(coef + p);
    }
    const float prod = Num<T>::round(__fmul_rn(Num<T>::load(val + p), x));
    sum = Num<T>::round(__fadd_rn(sum, prod));
  }
  if (kFromZero) sum = __fadd_rn(Num<T>::load(dst), sum);
  Num<T>::store(dst, sum);  // rounds to T: the one rounding of acc + sum
}

template <typename T, bool kDense>
void launch_form(void* acc, int nseg, int width, long long seg_stride,
                 long long elem_stride, const int* ptr, const void* val,
                 const void* table, const int* src, const int* cell,
                 const void* coef, bool from_zero, cudaStream_t stream) {
  const dim3 block(kLanes, kSegs);
  const dim3 grid((nseg + kSegs - 1) / kSegs, (width + kLanes - 1) / kLanes);
  auto kernel = from_zero ? sparse_fold_kernel<T, kDense, true>
                          : sparse_fold_kernel<T, kDense, false>;
  kernel<<<grid, block, 0, stream>>>(
      static_cast<T*>(acc), nseg, width, seg_stride, elem_stride, ptr,
      static_cast<const T*>(val), static_cast<const T*>(table), src, cell,
      static_cast<const T*>(coef));
}

template <typename T>
void launch(void* acc, int nseg, int width, long long seg_stride,
            long long elem_stride, const int* ptr, const void* val,
            const void* table, const int* src, const int* cell,
            const void* coef, bool from_zero, cudaStream_t stream) {
  if (table != nullptr)
    launch_form<T, true>(acc, nseg, width, seg_stride, elem_stride, ptr, val,
                         table, src, cell, coef, from_zero, stream);
  else
    launch_form<T, false>(acc, nseg, width, seg_stride, elem_stride, ptr,
                          val, table, src, cell, coef, from_zero, stream);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// dtype: 0 float32, 1 bfloat16 (acc, val, table and coef alike).  Exactly
// one form: table and src (dense), or cell and coef (sparse); the other
// pair null.  ptr has nseg + 1 entries; val, src, cell and coef have nnz,
// in CSR order (null when nnz is 0: an empty tensor has no address).
// acc[s, j] sits at acc + s·seg_stride + j·elem_stride.
int rt_sparse_fold(void* acc, int dtype, int nseg, int width, int nnz,
                   long long seg_stride, long long elem_stride,
                   const void* ptr, const void* val, const void* table,
                   const void* src, const void* cell, const void* coef,
                   int from_zero, void* stream) {
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
      || (width + kLanes - 1) / kLanes > 65535 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int*>(ptr);
  const auto* sr = static_cast<const int*>(src);
  const auto* ce = static_cast<const int*>(cell);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    repro_torch::launch<float>(acc, nseg, width, seg_stride, elem_stride, p,
                               val, table, sr, ce, coef, from_zero != 0, st);
  else
    repro_torch::launch<__nv_bfloat16>(acc, nseg, width, seg_stride,
                                       elem_stride, p, val, table, sr, ce,
                                       coef, from_zero != 0, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
