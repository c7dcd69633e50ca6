// DIA sparse matrix times a block of k vectors for Hopper (sm_90a):
//
//     Y[c * ldy + i] = sum_d  data[d * nr_pad + i] * X[c * ldx + i + offsets[d]]
//
// for 0 <= c < k and 0 <= i < n, summed over the diagonals in the order
// given (ascending offsets for a DiaMatrix), in the X dtype. X and Y are
// slab-major: column c of the block is row c of a (k, n) array, contiguous.
//
// Replaces the TPU kernel in sparsebench_tpu/ops/dia_pallas.py:
// dia_spmm_pallas -> _dia_kernel_mrhs. That kernel runs a grid (row tiles,
// k) with the column innermost so that Mosaic keeps a tile's diagonal block
// in VMEM across the k column steps. What carries over is the traffic: the
// stored diagonals are read from device memory once for a group of columns,
// not once per column.
//
// Design: one thread per output row over a 1-D grid, and kGroup register
// accumulators, one per column of a group. The diagonals are taken in runs
// of consecutive offsets (the 27-point stencil has 9 runs of 3: sx = -1,
// 0, +1), split into chunks of at most kRun. For each chunk the thread
// reads the chunk's data[d, i] once into registers and then, column by
// column, its kRun x values back to back: those share one or two cache
// lines, so the second and third are L1 hits. What bounds the kernel is
// this x traffic through L1/L2, not the matrix: each row reads a column's x
// once per diagonal, 27 times for the stencil, against 2 bytes of bf16
// matrix a diagonal. Taking the 8 columns' loads per diagonal in turn
// instead (the first form measured) let a warp's 16 lines of x, times 64
// warps an SM, overflow L1 between the loads that share them, and served
// every x load from L2. Two shared-memory forms were slower (PERF.md,
// section 6). A warp's loads of data and of each column of X are 32 consecutive
// entries (coalesced). k > kGroup runs the groups one after the other in
// the same thread, so the diagonals are read ceil(k / kGroup) times.
// Several rows a thread, vector loads and TMA are later work.
//
// x is read only where 0 <= i + offsets[d] < n, and 0 is used elsewhere, as
// in K1 (csrc/dia_spmv.cu). Products and sums are rounded one by one
// (mul_rn / add_rn, no FMA contraction) and the diagonals are summed in the
// order given, so column c of the result has the bits of K1 on column c of
// X, and of the plain version (ops/dia_spmm.py dia_spmm_torch).
//
// Instances (data, X): (bf16, f32), (f32, f32) and (f64, f64), as K1. The
// entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::kThreads;
using sb::mul_rn;
using sb::widen;

constexpr int kMaxDiags = 64;
constexpr int kGroup = 8;  // columns a thread accumulates at once
constexpr int kRun = 4;    // diagonals of a run taken at once

// Chunks of runs of consecutive offsets, in the order of the diagonals, by
// value in the kernel's parameter space: chunk r covers diagonals d0[r] ..
// d0[r] + len[r] - 1 (len[r] <= kRun), with offsets start[r] ..
// start[r] + len[r] - 1.
struct Runs {
  long long start[kMaxDiags];
  int d0[kMaxDiags];
  int len[kMaxDiags];
  int count;
};

template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                TX* __restrict__ y, long long n, long long nr_pad, int k,
                long long ldx, long long ldy, Runs runs) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  for (int c0 = 0; c0 < k; c0 += kGroup) {
    const int kc = min(kGroup, k - c0);
    const TX* xg = x + c0 * ldx;
    TX acc[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) acc[c] = TX(0);
    for (int r = 0; r < runs.count; ++r) {
      const int len = runs.len[r];
      const long long j0 = i + runs.start[r];
      TX a[kRun];
#pragma unroll
      for (int s = 0; s < kRun; ++s) {
        a[s] = s < len ? static_cast<TX>(widen(data[(runs.d0[r] + s) * nr_pad + i]))
                       : TX(0);
      }
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c < kc) {
#pragma unroll
          for (int s = 0; s < kRun; ++s) {
            if (s < len) {
              const long long j = j0 + s;
              const TX xv = (j >= 0 && j < n) ? xg[c * ldx + j] : TX(0);
              acc[c] = add_rn(acc[c], mul_rn(a[s], xv));
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (c < kc) y[(c0 + c) * ldy + i] = acc[c];
    }
  }
}

template <typename TD, typename TX>
int launch(const void* data, const void* x, void* y, long long n,
           long long nr_pad, int ndiag, const long long* offsets, int k,
           long long ldx, long long ldy, void* stream) {
  if (n <= 0 || nr_pad < n || ndiag <= 0 || ndiag > kMaxDiags || k <= 0 ||
      ldx < n || ldy < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Runs runs = {};
  for (int d = 0; d < ndiag; ++d) {
    const int r = runs.count - 1;
    if (d > 0 && runs.len[r] < kRun &&
        offsets[d] == runs.start[r] + runs.len[r]) {
      ++runs.len[r];
    } else {
      runs.start[runs.count] = offsets[d];
      runs.d0[runs.count] = d;
      runs.len[runs.count] = 1;
      ++runs.count;
    }
  }
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  dia_spmm_kernel<TD, TX><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TD*>(data), static_cast<const TX*>(x),
      static_cast<TX*>(y), n, nr_pad, k, ldx, ldy, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sb_dia_spmm_bf16_f32(const void* data, const void* x, void* y, long long n,
                         long long nr_pad, int ndiag, const long long* offsets,
                         int k, long long ldx, long long ldy, void* stream) {
  return launch<__nv_bfloat16, float>(data, x, y, n, nr_pad, ndiag, offsets, k,
                                      ldx, ldy, stream);
}

int sb_dia_spmm_f32_f32(const void* data, const void* x, void* y, long long n,
                        long long nr_pad, int ndiag, const long long* offsets,
                        int k, long long ldx, long long ldy, void* stream) {
  return launch<float, float>(data, x, y, n, nr_pad, ndiag, offsets, k, ldx,
                              ldy, stream);
}

int sb_dia_spmm_f64_f64(const void* data, const void* x, void* y, long long n,
                        long long nr_pad, int ndiag, const long long* offsets,
                        int k, long long ldx, long long ldy, void* stream) {
  return launch<double, double>(data, x, y, n, nr_pad, ndiag, offsets, k, ldx,
                                ldy, stream);
}

}  // extern "C"
