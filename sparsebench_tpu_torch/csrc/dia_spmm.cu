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
// The diagonals are taken in chunks: runs of consecutive offsets (the
// 27-point stencil has 9 runs of 3: sx = -1, 0, +1) of at most kRun. The
// wrapper makes the chunks (ops/dia_spmm.py spmm_plan) and passes them by
// value. For each chunk a thread reads its diagonals' data once and then,
// for each of its columns, the x values they multiply; its columns' sums
// stay in registers. The data are read from device memory once for kGroup
// columns: k > kGroup runs the groups one after the other.
//
// The first K8 ran one thread a row over kGroup columns and issued one
// scalar x load a diagonal and column, 216 load instructions a row for 8
// columns; it reached 21 % of its bound (PERF.md §6). Where it can (the
// "four-row form") each thread owns four consecutive rows i0 .. i0 + 3 (i0
// = 0 mod 4):
// * a diagonal's four data values come in one vector load (8 B of bf16, 16 B
//   of f32, 32 B of f64), issued a chunk ahead, and each column's four sums
//   go out in one vector store;
// * an aligned chunk (offsets s .. s + len - 1 inside [o - 1, o + 4] for an
//   o = 0 mod 4; a stencil run centred on o) reads, for each column, the
//   six x values i0 + o - 1 .. i0 + o + 4 that its 4 rows x len diagonals
//   use: X[i0 + o .. i0 + o + 3] in one aligned 16 B load (f64: two), the
//   value before it from the previous lane's load and the value after it
//   from the next lane's, by shuffle; only lanes 0 and 31 load their halo
//   value themselves. One vector load a column replaces 4 len scalar ones;
// * any other chunk reads its len + 3 x values a column as scalars and uses
//   each for every row that needs it;
// * a group's kGroup columns are split over kSlices warps that share the
//   rows, kCols columns a thread: the slices read the same data, all but
//   the first from L1, and the thread's registers (64 in f32) leave room
//   for 32 warps an SM. A chunk's vector loads all go out before its sums.
// The four-row form needs n, nr_pad, ldx and ldy multiples of 4 and the
// three base pointers 16 B aligned; otherwise the general form runs, one
// thread a row and one scalar load a diagonal and column (the first K8's
// body). With the stencil's offsets sz nx ny + sy nx + sx, every run is
// aligned when nx = 0 mod 4 (100^3, 200^3).
//
// What bounds it (200^3, k = 8; PERF.md §6, profile_cg --k8-variants): not
// the bytes (a third of the bound) and not the x traffic through L2: with
// every x read served from L1 it takes 0.88x as long, with no x loads at
// all 0.59x. The loads' latency at the occupancy that the registers allow
// does: over all 8 columns a thread (116 registers, 16 warps an SM) it
// takes 1.33x as long, and issuing the next chunk's x loads a chunk ahead
// cost so many registers that it ran slower than the first K8. Staging x
// in shared memory is the next step.
//
// x is read only where 0 <= i + offsets[d] < n, and 0 is used elsewhere, as
// in K1 (csrc/dia_spmv.cu): an aligned vector lies wholly inside [0, n) or
// wholly outside it, and a shuffled halo value is the neighbour's read of
// the same entry. Products and sums are rounded one by one (mul_rn /
// add_rn, no FMA contraction) and each row sums the diagonals in the order
// given, so column c of the result has the bits of K1 on column c of X, and
// of the plain version (ops/dia_spmm.py dia_spmm_torch), in both forms.
//
// Instances (data, X): (bf16, f32), (f32, f32) and (f64, f64), as K1. The
// entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include <cstdint>

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::kThreads;
using sb::mul_rn;
using sb::widen;

constexpr int kMaxDiags = 64;
constexpr int kGroup = 8;  // columns that share one read of the data
constexpr int kRun = 4;    // diagonals a chunk, at most
constexpr int kQuad = 4;   // rows a thread in the four-row form
constexpr int kQuadThreads = 128;  // a block of the four-row form
constexpr int kSlices = 4;         // column slices of a group, a warp each
constexpr int kCols = kGroup / kSlices;  // columns a thread of the four-row form
static_assert(kGroup % kSlices == 0 && kQuadThreads % (32 * kSlices) == 0,
              "a block of the four-row form holds whole warps of every slice");

// The chunks, by value in the kernel's parameter space: chunk r covers
// diagonals d0[r] .. d0[r] + len[r] - 1 with offsets start[r] .. start[r] +
// len[r] - 1. In the four-row form ``shift[r]`` >= 0 marks an aligned chunk,
// whose vector starts at offset o = start[r] + 1 - shift[r] (o = 0 mod 4).
struct Runs {
  long long start[kMaxDiags];
  int d0[kMaxDiags];
  int len[kMaxDiags];
  int shift[kMaxDiags];
  int count;
};

// -- the general form: one thread a row --------------------------------------------

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

// -- the four-row form ------------------------------------------------------------

// four consecutive x or y entries as one vector, through the read-only path
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<double> {
  static __device__ __forceinline__ void load(const double* p, double v[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* p, const double v[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

// a diagonal's four data values as loaded (8 B of bf16, 16 B of f32, 32 B
// of f64), widened on use: kept raw while the next chunk's are in flight
template <typename TD> struct Raw4;
template <> struct Raw4<__nv_bfloat16> {
  uint2 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint2(0u, 0u); }
  // bf16 -> f32 is the upper half of the word: exact, as widen is
  __device__ __forceinline__ float get(int q) const {
    const unsigned w = q < 2 ? r.x : r.y;
    return __uint_as_float(q & 1 ? (w & 0xffff0000u) : (w << 16));
  }
};
template <> struct Raw4<float> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float get(int q) const {
    return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
  }
};
template <> struct Raw4<double> {
  double2 a, b;
  __device__ __forceinline__ void load(const double* p) {
    a = __ldg(reinterpret_cast<const double2*>(p));
    b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  }
  __device__ __forceinline__ void zero() { a = b = make_double2(0.0, 0.0); }
  __device__ __forceinline__ double get(int q) const {
    return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? b.x : b.y;
  }
};

template <typename TX>
__device__ __forceinline__ TX x_at(const TX* xc, long long j, long long n) {
  return (j >= 0 && j < n) ? __ldg(xc + j) : TX(0);
}

// acc[q] += a[u][q] * w[q + u + S] for the chunk's diagonals u < len, in
// order, each op rounded: w[m] is X at row i0 + start - S + m
template <int S, int W, typename TD, typename TX>
__device__ __forceinline__ void add_chunk(TX (&acc)[kQuad], const Raw4<TD> (&a)[kRun],
                                          const TX (&w)[W], int len) {
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (u < len && q + u + S < W) {
        acc[q] = add_rn(acc[q], mul_rn(static_cast<TX>(a[u].get(q)), w[q + u + S]));
      }
    }
  }
}

// An aligned chunk (S = its shift) for the thread's kCols columns: all
// their vector and halo loads go out before any shuffle or sum.
template <int S, typename TD, typename TX>
__device__ __forceinline__ void vector_chunk(TX (&acc)[kCols][kQuad], const Raw4<TD> (&a)[kRun],
                                             const TX* xg, long long ldx, int kc, long long j0,
                                             long long n, int len, int lane) {
  TX w[kCols][6];  // X[i0 + o - 1 .. i0 + o + 4]
  TX edge[kCols];  // lane 0: the value before the vector, lane 31: after
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int m = 0; m < 6; ++m) w[c][m] = TX(0);
    edge[c] = TX(0);
    if (c < kc) {
      const TX* xc = xg + c * ldx;
      if (j0 >= 0 && j0 < n) Vec4<TX>::load(xc + j0, w[c] + 1);
      if (lane == 0) edge[c] = x_at(xc, j0 - 1, n);
      if (lane == 31) edge[c] = x_at(xc, j0 + 4, n);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < kc) {
      const TX before = __shfl_up_sync(0xffffffffu, w[c][4], 1);
      const TX after = __shfl_down_sync(0xffffffffu, w[c][1], 1);
      w[c][0] = lane == 0 ? edge[c] : before;
      w[c][5] = lane == 31 ? edge[c] : after;
      add_chunk<S>(acc[c], a, w[c], len);
    }
  }
}

// The four-row form: warp w of a block takes rows (w % kRowWarps) of the
// block's row blocks and the column slice w / kRowWarps of each group of
// kGroup columns, kCols columns a thread; the slices' warps read the same
// data, all but the first from L1. Each thread loads the next chunk's data
// while it works on this one.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kQuadThreads)
dia_spmm_quad_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                     TX* __restrict__ y, long long n, long long nr_pad, int k,
                     long long ldx, long long ldy, Runs runs) {
  constexpr int kRowWarps = kQuadThreads / 32 / kSlices;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i0 =
      ((static_cast<long long>(blockIdx.x) * kRowWarps + warp % kRowWarps) * 32 + lane) * kQuad;
  // n = 0 mod 4: a thread has all four rows or none; one without rows still
  // reads x for its neighbours' shuffles
  const bool mine = i0 < n;
  auto load_data = [&](Raw4<TD> (&a)[kRun], int r) {
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      if (u < runs.len[r] && mine) {
        a[u].load(data + (runs.d0[r] + u) * nr_pad + i0);
      } else {
        a[u].zero();
      }
    }
  };
  for (int c0 = warp / kRowWarps * kCols; c0 < k; c0 += kGroup) {
    const int kc = min(kCols, k - c0);
    const TX* xg = x + c0 * ldx;
    TX acc[kCols][kQuad];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int q = 0; q < kQuad; ++q) acc[c][q] = TX(0);
    }
    Raw4<TD> nxt[kRun];
    load_data(nxt, 0);
    for (int r = 0; r < runs.count; ++r) {
      Raw4<TD> a[kRun];
#pragma unroll
      for (int u = 0; u < kRun; ++u) a[u] = nxt[u];
      if (r + 1 < runs.count) load_data(nxt, r + 1);
      const int len = runs.len[r];
      const long long s0 = runs.start[r];
      const int shift = runs.shift[r];
      // the vector's first row: i0 + o, o = start + 1 - shift
      const long long j0 = i0 + s0 + 1 - shift;
      if (shift == 0) {
        vector_chunk<0>(acc, a, xg, ldx, kc, j0, n, len, lane);
      } else if (shift == 1) {
        vector_chunk<1>(acc, a, xg, ldx, kc, j0, n, len, lane);
      } else if (shift == 2) {
        vector_chunk<2>(acc, a, xg, ldx, kc, j0, n, len, lane);
      } else {
        // w[m] = X[i0 + start + m], m < len + 3, column by column
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if (c < kc) {
            const TX* xc = xg + c * ldx;
            TX w[kRun + 3];
#pragma unroll
            for (int m = 0; m < kRun + 3; ++m) {
              w[m] = m < len + 3 ? x_at(xc, i0 + s0 + m, n) : TX(0);
            }
            add_chunk<0>(acc[c], a, w, len);
          }
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (c < kc) Vec4<TX>::store(y + (c0 + c) * ldy + i0, acc[c]);
      }
    }
  }
}

// -- launch ------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename TD, typename TX>
int launch(const void* data, const void* x, void* y, long long n, long long nr_pad,
           int k, long long ldx, long long ldy, int quad, int nchunks,
           const long long* start, const int* d0, const int* len, const int* shift,
           void* stream) {
  if (n <= 0 || nr_pad < n || k <= 0 || ldx < n || ldy < n || nchunks <= 0 ||
      nchunks > kMaxDiags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (quad && (n % kQuad || nr_pad % kQuad || ldx % kQuad || ldy % kQuad ||
               !aligned16(data) || !aligned16(x) || !aligned16(y))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Runs runs = {};
  int next = 0;  // the chunks cover the diagonals in order
  for (int r = 0; r < nchunks; ++r) {
    const bool ok_shift = quad ? (shift[r] >= -1 && shift[r] + len[r] <= 3 &&
                                  (shift[r] < 0 || (start[r] + 1 - shift[r]) % kQuad == 0))
                               : shift[r] == -1;
    if (d0[r] != next || len[r] < 1 || len[r] > kRun || !ok_shift) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    runs.start[r] = start[r];
    runs.d0[r] = d0[r];
    runs.len[r] = len[r];
    runs.shift[r] = shift[r];
    next += len[r];
  }
  runs.count = nchunks;
  if (next > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = quad ? kQuadThreads / kSlices : kThreads;
  const long long threads = quad ? n / kQuad : n;
  const unsigned blocks = static_cast<unsigned>((threads + per_block - 1) / per_block);
  const TD* d = static_cast<const TD*>(data);
  const TX* xx = static_cast<const TX*>(x);
  TX* yy = static_cast<TX*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quad) {
    dia_spmm_quad_kernel<TD, TX><<<blocks, kQuadThreads, 0, st>>>(d, xx, yy, n, nr_pad, k,
                                                                 ldx, ldy, runs);
  } else {
    dia_spmm_kernel<TD, TX><<<blocks, kThreads, 0, st>>>(d, xx, yy, n, nr_pad, k, ldx, ldy,
                                                        runs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SB_DIA_SPMM_ENTRY(SUFFIX, TD, TX)                                          \
  int sb_dia_spmm_##SUFFIX(const void* data, const void* x, void* y, long long n,  \
                           long long nr_pad, int k, long long ldx, long long ldy,  \
                           int quad, int nchunks, const long long* start,          \
                           const int* d0, const int* len, const int* shift,        \
                           void* stream) {                                         \
    return launch<TD, TX>(data, x, y, n, nr_pad, k, ldx, ldy, quad, nchunks,      \
                          start, d0, len, shift, stream);                          \
  }

extern "C" {
SB_DIA_SPMM_ENTRY(bf16_f32, __nv_bfloat16, float)
SB_DIA_SPMM_ENTRY(f32_f32, float, float)
SB_DIA_SPMM_ENTRY(f64_f64, double, double)
}  // extern "C"
