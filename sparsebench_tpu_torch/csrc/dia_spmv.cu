// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_d  data[d * nr_pad + i] * x[i + offsets[d]],   0 <= i < n
//
// summed over the diagonals in ascending offset order, in the x dtype.
//
// Replaces the TPU kernel in sparsebench_tpu/ops/dia_pallas.py:
// dia_spmv_pallas -> _dia_kernel_xres (whole x resident in VMEM) and
// _dia_kernel_dbuf (double-buffered x window), the two schedules its
// choose_schedule picks. It computes what they compute and none of how: the
// lane rolls, sublane carries and VMEM windows there exist only to get
// around the TPU's (8, 128) tiling.
//
// Design: one thread per output row over a 1-D grid. For each diagonal a
// warp reads 32 consecutive entries of data (coalesced) and 32 consecutive
// entries of x (coalesced, shifted). The kernel is bound by memory: per SpMV
// it moves the stored diagonals (ndiag * nr_pad * sizeof(data)), one read of
// x and one write of y, and does 2 flops per stored entry. x is read through
// L1/L2 rather than staged in shared memory: at 200^3 the x window a row tile
// needs is 2 * 40201 elements plus the tile, over 321 KB in f32, above the
// 227 KB a block may use, while all of x (32 MB at 200^3) fits the 50 MB L2.
// A faster schedule (several rows per thread with vector loads, grouping the
// 9 runs of 3 adjacent stencil offsets, TMA staging) is later work.
//
// x is read only where 0 <= i + offsets[d] < n, and 0 is used elsewhere: the
// JAX package pads x with zeros instead, and reading past x would turn a
// stored zero into NaN (garbage * 0). Products and sums are rounded one by
// one (__fmul_rn / __fadd_rn, no FMA contraction), so the kernel gives the
// same bits as the plain PyTorch version (ops/dia_spmv.py dia_spmv_torch),
// which sums the same terms in the same order.
//
// Instances (data, x): (bf16, f32) is the default f32 path with the
// diagonals stored losslessly compressed, (f32, f32) the uncompressed path,
// (f64, f64) --dtype f64. The entry points launch on the stream they are
// given, do not synchronise, allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::kThreads;
using sb::mul_rn;
using sb::widen;

constexpr int kMaxDiags = 64;

// Offsets travel by value in the kernel's parameter space: no device copy.
struct Offsets {
  long long v[kMaxDiags];
};

template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                TX* __restrict__ y, long long n, long long nr_pad, int ndiag,
                Offsets off) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  TX acc = TX(0);
  for (int d = 0; d < ndiag; ++d) {
    const long long j = i + off.v[d];
    const TX a = static_cast<TX>(widen(data[d * nr_pad + i]));
    const TX xv = (j >= 0 && j < n) ? x[j] : TX(0);
    acc = add_rn(acc, mul_rn(a, xv));
  }
  y[i] = acc;
}

template <typename TD, typename TX>
int launch(const void* data, const void* x, void* y, long long n,
           long long nr_pad, int ndiag, const long long* offsets,
           void* stream) {
  if (n <= 0 || nr_pad < n || ndiag <= 0 || ndiag > kMaxDiags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets off = {};
  for (int d = 0; d < ndiag; ++d) off.v[d] = offsets[d];
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  dia_spmv_kernel<TD, TX><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TD*>(data), static_cast<const TX*>(x),
      static_cast<TX*>(y), n, nr_pad, ndiag, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sb_dia_spmv_bf16_f32(const void* data, const void* x, void* y, long long n,
                         long long nr_pad, int ndiag, const long long* offsets,
                         void* stream) {
  return launch<__nv_bfloat16, float>(data, x, y, n, nr_pad, ndiag, offsets, stream);
}

int sb_dia_spmv_f32_f32(const void* data, const void* x, void* y, long long n,
                        long long nr_pad, int ndiag, const long long* offsets,
                        void* stream) {
  return launch<float, float>(data, x, y, n, nr_pad, ndiag, offsets, stream);
}

int sb_dia_spmv_f64_f64(const void* data, const void* x, void* y, long long n,
                        long long nr_pad, int ndiag, const long long* offsets,
                        void* stream) {
  return launch<double, double>(data, x, y, n, nr_pad, ndiag, offsets, stream);
}

}  // extern "C"
