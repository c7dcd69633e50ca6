// CRS (CSR) sparse matrix-vector product for Hopper (sm_90a): K14 of the
// port.
//
//     y[i] = sum_{row_ptr[i] <= j < row_ptr[i+1]}  val[j] * x[col[j]]
//
// summed in stored (column) order, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn), starting from 0: the sum that the reference's row
// loop takes (src/matrix-CRS.c:46-64). No TPU kernel computes this: the JAX
// package's CRS SpMV is XLA's gather and segment sum, and the port's plain
// version (ops/crs_spmv.py crs_spmv_torch) is torch's index_select and
// segment_reduce, whose order of sums is torch's own. K14 and the plain
// version therefore agree to the bound on the error of a sum of a row's
// terms, not bit for bit (tests/test_torch_crs.py states it).
//
// Design: a block of kThreads threads takes kThreads consecutive rows. Their
// entries are one contiguous range of val and col, [row_ptr[r0],
// row_ptr[r0 + kThreads]), which the block walks in chunks of kChunk
// entries:
// * stage: consecutive threads take consecutive entries of the chunk (each
//   warp load is one or two 128 B lines of the stream); every thread issues
//   its kChunk / kThreads loads of values and columns, then its gathers of
//   x[col] through L1/L2, then stores the rounded products in shared memory;
// * sum: thread t adds up the products of row r0 + t that lie in the chunk,
//   in order, into its running sum.
// Values and columns are read from device memory once; x (32 MB at 200^3 in
// f32) is read through the 50 MB L2, where the three z-planes a block's rows
// reach (480 KB at 200^3) stay while they are read. A row longer than a
// chunk is summed across chunks by its thread, in order; an empty row is 0.
// At 200^3 f32 (PERF.md §6) this took 0.648 ms against 0.691 ms for the same
// blocks staging values and columns and gathering x in the sum, a thread a
// row (where the k-th entries of 32 consecutive rows are 32 consecutive
// entries of x): the gathers in stream order overlap the stream's loads.
// Fewer loads a thread per chunk then took it to 0.609 ms: 6 a thread hold
// fewer registers, so more warps keep loads in flight.
//
// Instances: f32 values, x and y (6 KB of shared memory for the products)
// and f64 (12 KB), int32 columns; crs_spmv_kernel takes int32 row pointers
// and at most 2^31 - 1 - kChunk entries (its last chunk's start steps by
// kChunk past the last entry and must stay an int; ops/crs_spmv.py
// NARROW_ENTRIES), crs_spmv_wide_kernel int64 ones, for larger matrices
// (the 27-point stencil from 431^3 on). Both run one body,
// crs_rows, templated on the row pointers' type: the wide form holds the
// staged pointers, the chunk bounds and every entry offset in 64 bits,
// while rows and columns stay int. The two forms add the same products in
// the same order, so where both apply their results are equal bit for bit.
// The entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::kThreads;
using sb::mul_rn;

// entries a chunk: 6 a thread (PERF.md §6: 4, 6, 8, 12 and 16 a thread, and
// blocks of 128 and 512 threads, were timed at 100^3 and 200^3)
constexpr int kChunk = 1536;

// the rows of block blockIdx.x; Ptr is the row pointers' type, and with it
// every entry offset's
template <typename T, typename Ptr>
__device__ __forceinline__ void crs_rows(const T* __restrict__ val,
                                         const int* __restrict__ col,
                                         const Ptr* __restrict__ row_ptr,
                                         const T* __restrict__ x,
                                         T* __restrict__ y, int n) {
  constexpr int kPer = kChunk / kThreads;
  static_assert(kChunk % kThreads == 0, "a chunk is whole loads a thread");
  __shared__ T s_prod[kChunk];
  __shared__ Ptr s_ptr[kThreads + 1];

  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n - r0);
  for (int i = t; i <= rows; i += kThreads) s_ptr[i] = row_ptr[r0 + i];
  __syncthreads();
  const Ptr b0 = s_ptr[0];
  const Ptr b1 = s_ptr[rows];
  const Ptr mine0 = t < rows ? s_ptr[t] : b1;
  const Ptr mine1 = t < rows ? s_ptr[t + 1] : b1;

  T acc = T(0);
  for (Ptr c0 = b0; c0 < b1; c0 += kChunk) {
    const int len = static_cast<int>(min(static_cast<Ptr>(kChunk), b1 - c0));
    T v[kPer];
    int c[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + t;
      if (j < len) {
        v[k] = val[c0 + j];
        c[k] = col[c0 + j];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + t;
      if (j < len) s_prod[j] = mul_rn(v[k], x[c[k]]);
    }
    __syncthreads();
    // within the chunk: offsets below kChunk, or past it where the thread's
    // row starts in a later chunk (the loop then runs no step)
    const int e = static_cast<int>(min(mine1, c0 + len) - c0);
    for (int j = static_cast<int>(max(mine0, c0) - c0); j < e; ++j)
      acc = add_rn(acc, s_prod[j]);
    __syncthreads();  // the next chunk overwrites the staged one
  }
  if (t < rows) y[r0 + t] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crs_spmv_kernel(const T* __restrict__ val, const int* __restrict__ col,
                const int* __restrict__ row_ptr, const T* __restrict__ x,
                T* __restrict__ y, int n) {
  crs_rows<T, int>(val, col, row_ptr, x, y, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crs_spmv_wide_kernel(const T* __restrict__ val, const int* __restrict__ col,
                     const long long* __restrict__ row_ptr,
                     const T* __restrict__ x, T* __restrict__ y, int n) {
  crs_rows<T, long long>(val, col, row_ptr, x, y, n);
}

template <typename T, typename Ptr>
int launch(void (*kernel)(const T*, const int*, const Ptr*, const T*, T*, int),
           const void* val, const void* col, const void* row_ptr,
           const void* x, void* y, long long n, void* stream) {
  if (n <= 0 || n > 0x7fffffffLL - kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(val), static_cast<const int*>(col),
      static_cast<const Ptr*>(row_ptr), static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sb_crs_spmv_f32(const void* val, const void* col, const void* row_ptr,
                    const void* x, void* y, long long n, void* stream) {
  return launch(crs_spmv_kernel<float>, val, col, row_ptr, x, y, n, stream);
}

int sb_crs_spmv_f64(const void* val, const void* col, const void* row_ptr,
                    const void* x, void* y, long long n, void* stream) {
  return launch(crs_spmv_kernel<double>, val, col, row_ptr, x, y, n, stream);
}

int sb_crs_spmv_wide_f32(const void* val, const void* col,
                         const void* row_ptr, const void* x, void* y,
                         long long n, void* stream) {
  return launch(crs_spmv_wide_kernel<float>, val, col, row_ptr, x, y, n,
                stream);
}

int sb_crs_spmv_wide_f64(const void* val, const void* col,
                         const void* row_ptr, const void* x, void* y,
                         long long n, void* stream) {
  return launch(crs_spmv_wide_kernel<double>, val, col, row_ptr, x, y, n,
                stream);
}

}  // extern "C"
