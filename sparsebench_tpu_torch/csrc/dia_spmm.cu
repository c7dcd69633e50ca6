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
// What bounds the four-row form (200^3, k = 8; PERF.md §6, profile_cg
// --k8-variants as it was then): not the bytes (a third of the bound) and not
// the x traffic through L2: with every x read served from L1 it takes 0.88x as
// long, with no x loads at all 0.59x. The loads' latency at the occupancy that
// the registers allow does: a block's four slice warps load the same data, and
// 8 blocks an SM keep about 6 KB of it in flight where 3.35 TB/s at about 0.7
// us needs about 18 KB.
//
// The staged form (dia_spmm_kernel_staged) takes the loads off the
// threads. ops/dia_spmm.py spmm_plan groups the chunks into windows:
// consecutive chunks whose offsets lie within kTileRows of each other (the
// 27-point stencil at nx = 100 or 200: 3 windows of 9 diagonals, each 2 (nx
// + 1) wide around sz nx ny; the 7-point: 1, 5 and 1). It stages where
// the windows are planes P rows apart (P = nx ny; the Staged note below
// has the layout and the walk), and blocks are persistent, a producer
// warp and consumer warps each:
// * the blocks march: a unit is a strip of T rows of a plane (T a
//   multiple of 128 up to kTileRows) and up to kStageCols columns, and a
//   run is a strip's units through up to kRunPlanes planes in a row, so a
//   unit's windows are the segments of planes z - 1, z, z + 1 and all but
//   one were copied for the unit before it. Runs are strided over the
//   blocks plane segment by plane segment, so the blocks' units at any
//   time lie in a few planes;
// * the producer copies a unit with bulk copies (cp.async.bulk, ring.cuh)
//   spread over its lanes: the T values of each diagonal into a data
//   stage, and for each column the new window's segment X[c, i0 + lo ..
//   i0 + T + hi), rounded out to 16 B, into a slot of an X ring; a
//   segment's part outside [0, n) is written as zeros. The warp arrives
//   once on the unit's full mbarrier with the bytes of its copies; the
//   ring holds kMarchStages units, so the next units' copies are in flight
//   while the consumers sum this one;
// * consumer warps, a thread for four rows and kThreadCols columns, sum
//   the unit from shared memory window by window and chunk by chunk as the
//   four-row form does (an aligned chunk: one 16 B load a column, the
//   values before and after it by shuffle, lanes 0 and 31 reading theirs),
//   store each column's four sums with one vector store and arrive on the
//   unit's empty mbarrier. Nothing around the shuffles depends on the
//   thread (columns past the group's are summed and not stored), so they
//   run in converged code, and where every chunk is an aligned run of
//   three (the 27-point stencil) the nine chunks are unrolled.
// The plan gives the layout (rows, columns, P, each window's segment);
// staged_layout checks it against what the kernel reads and the shared
// memory. 200^3, k = 8, bf16 diagonals, f32 X: T = 512, one block an SM with 3
// data stages of 27 KB and 5 X slots of 29 KB; K8 0.383 against the four-row
// form's 0.895 ms, 0.735 of the byte bound (PERF.md §6). The copies bound it:
// alone they take 0.379 ms (profile_cg --k8-variants "no sums"), the sums with
// the data copies 0.338 ("X copied once"; 24 rounded products and sums a
// column and chunk beside about 11 loads, shuffles and selects).
//
// The shared-memory forms dropped before this one (PERF.md at 81b715d, "Three
// dropped designs") staged each of the 9 runs with its own barrier pair, so
// the load latency stood exposed on every run (1.604 ms), or copied with
// 4-byte cp.async from every thread at 3 blocks an SM, as many instructions as
// the loads they replaced (2.495 ms). Neither issued bulk copies from one
// warp, kept a ring across units that hides the latency, or moved the data
// stream through shared memory; and a first draft of this form, whose shuffles
// sat under a branch on the thread's columns, ran at 1.02 ms, nvcc making them
// divergent collectives.
//
// Where the four-row form stays (spmm_plan): windows that are not planes
// (one window: planes closer than kTileRows; scattered offsets), more than
// kMaxWindows, stages over the shared memory (f64 at 200^3 with 8
// columns), diagonals' rows not 16 B multiples, and a row's diagonals
// taking 7 or more times the bytes of its X values in a stage's columns
// (f64 at 1 to 3 columns, f32 diagonals under 1 column): there the
// four-row form, its data in vector loads and X through L1, was as fast
// or faster (profile_cg --k8-forms, PERF.md §6). At 100^3 the staged form
// takes 0.063 against 0.115 ms.
//
// x is read only where 0 <= i + offsets[d] < n, and 0 is used elsewhere, as
// in K1 (csrc/dia_spmv.cu): an aligned vector lies wholly inside [0, n) or
// wholly outside it, and a shuffled halo value is the neighbour's read of
// the same entry; the staged form reads the zeros its producer wrote.
// Products and sums are rounded one by one (mul_rn / add_rn, no FMA
// contraction) and each row sums the diagonals in the order given (the
// windows are runs of consecutive chunks), so column c of the result has
// the bits of K1 on column c of X, and of the plain version
// (ops/dia_spmm.py dia_spmm_torch), in every form.
//
// Instances (data, X): (bf16, f32), (f32, f32) and (f64, f64), as K1. The
// entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "ring.cuh"

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

// the staged form (ops/dia_spmm.py keeps the same numbers: STAGED)
constexpr int kTileRows = 512;       // rows a unit, at most
constexpr int kTileStep = 128;       // unit rows are a multiple: a warp of quads
constexpr int kMarchStages = 3;      // the ring: units a block has in flight
constexpr int kStageCols = 8;        // columns a stage, at most
constexpr int kThreadCols = 4;       // columns a consumer thread sums
constexpr int kSmemBudget = 232448;  // dynamic shared memory a block may have
constexpr int kMaxWindows = 16;
constexpr int kRunPlanes = 32;       // planes a run, at most
constexpr int kBarBytes = (2 * kMarchStages * 8 + 15) / 16 * 16;  // full, empty
constexpr int kGuardBytes = 16;  // after the ring: edge lanes read past a segment
static_assert(kTileRows % kTileStep == 0 && kTileStep % (32 * kQuad) == 0,
              "a tile holds whole warps of quads");

// the entry points' form
constexpr int kFormRow = 0;
constexpr int kFormQuad = 1;
constexpr int kFormStaged = 2;

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
  static __device__ __forceinline__ void lds(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
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
  static __device__ __forceinline__ void lds(const double* p, double v[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* p, const double v[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

// a diagonal's four data values as loaded (8 B of bf16, 16 B of f32, 32 B
// of f64; ``lds`` from shared memory), widened on use: kept raw while the
// next chunk's are in flight
template <typename TD> struct Raw4;
template <> struct Raw4<__nv_bfloat16> {
  uint2 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void lds(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint2*>(p);
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
  __device__ __forceinline__ void lds(const float* p) {
    r = *reinterpret_cast<const float4*>(p);
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
  __device__ __forceinline__ void lds(const double* p) {
    a = reinterpret_cast<const double2*>(p)[0];
    b = reinterpret_cast<const double2*>(p)[1];
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

// -- the staged form -----------------------------------------------------------------

// The staged form's layout and walk. ops/dia_spmm.py spmm_plan gives the
// layout: ``rows`` rows a unit, up to ``cols`` columns a group, the
// march's plane P and the windows, each with its first chunk and its
// segment (lo, len), P apart and as wide; staged_layout checks it and
// adds what follows from it. A unit is a strip of a plane (``rows`` rows
// from z P + s rows) and a group of columns; a run is the strip's units
// of run_planes planes in a row, so window w of unit (s, z) reads the
// segment that window w + 1 of unit (s, z - 1) read, and a unit of a run
// but its first copies one new segment a column. Shared memory holds
// kMarchStages data stages (a unit's diagonals, ndiag x rows values) and
// a ring of R = windows + kMarchStages - 1 X slots of slot_vals values: a
// slot holds one window's segment for the group's columns, column c at c
// len[w]. Blocks take runs rho = b, b + gridDim.x, ..., plane segment by
// plane segment and strip by strip, so the blocks' units at any time lie
// in a few planes; unit j of a block reads its window w from slot (f_j +
// w) mod R, where f_0 = 0 and f_{j+1} = f_j + 1 where unit j + 1
// continues a run, f_j + windows where it starts one. The producer copies
// unit j once the consumers have released unit j - kMarchStages (its data
// stage and the slots it overwrites) or, where unit j starts a run and
// overwrites ``windows`` slots, unit j - 1.
struct Staged {
  long long lo[kMaxWindows];   // window w's segment starts at X row i0 + lo[w]
  int len[kMaxWindows];        // and holds len[w] values (a unit from row i0)
  int first[kMaxWindows + 1];  // window w sums chunks first[w] .. first[w + 1] - 1
  int window[kMaxDiags];       // chunk r's window
  int windows;
  int rows;
  int cols;
  int groups;                  // ceil(k / cols)
  int ndiag;
  int slots;
  int data_bytes;              // a data stage: ndiag x rows values
  int slot_vals;               // X values a slot: cols x len
  long long plane;             // P
  int strips;                  // ceil(P / rows) strips a plane
  long long planes;            // n / P
  int run_planes;              // planes a run (set for the grid)
  long long segs;              // ceil(planes / run_planes)
  long long runs;
};

// Run rho: its first unit's first row, its units (one a plane), the rows
// a unit copies and stores, and its first column.
struct Run {
  long long i0;
  int count;
  int rows;
  int c0;
};

__device__ __forceinline__ Run run_at(const Staged& g, long long rho) {
  const long long per_group = g.segs * g.strips;
  const long long rem = rho % per_group;
  const int s = static_cast<int>(rem % g.strips);
  const long long z0 = rem / g.strips * g.run_planes;
  Run t;
  t.i0 = z0 * g.plane + static_cast<long long>(s) * g.rows;
  t.count = static_cast<int>(min(static_cast<long long>(g.run_planes), g.planes - z0));
  t.rows = static_cast<int>(min(static_cast<long long>(g.rows), g.plane - s * g.rows));
  t.c0 = static_cast<int>(rho / per_group) * g.cols;
  return t;
}

// The ring's walk: fm = f_j mod R for the block's unit j; slot_of(w) the
// slot that window w of unit j reads.
struct Walk {
  int slots;
  int fm = 0;
  // to unit j, which continues a run or starts one
  __device__ __forceinline__ void next(int j, bool cont, int windows) {
    if (j > 0) fm = (fm + (cont ? 1 : windows)) % slots;
  }
  __device__ __forceinline__ int slot_of(int w) const {
    const int t = fm + w;
    return t >= slots ? t - slots : t;
  }
};

template <typename TX>
__device__ __forceinline__ void zero16(TX* p, int count) {
  for (int m = 0; m < count; m += 16 / static_cast<int>(sizeof(TX))) {
    *reinterpret_cast<uint4*>(p + m) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The producer warp: for each of the block's units, once the consumers
// have released the unit kMarchStages before it (its data stage and, by
// then, every slot it overwrites; at the start of a run, which overwrites
// ``windows`` slots, the unit before it), the unit's diagonals
// and, for each new window and column, the X segment, by bulk copies
// spread over the lanes; a segment's part outside [0, n) is written as
// zeros. Lane 0 then arrives on the data stage's full barrier expecting
// the warp's bytes.
template <typename TD, typename TX>
__device__ __forceinline__ void staged_produce(const TD* data, const TX* x, long long n,
                                               long long nr_pad, int k, long long ldx,
                                               const Staged& g, unsigned char* ring,
                                               unsigned long long* full,
                                               unsigned long long* empty) {
  const int lane = threadIdx.x & 31;
  TX* xring = reinterpret_cast<TX*>(ring + static_cast<size_t>(kMarchStages) * g.data_bytes);
  Walk walk{g.slots};
  int j = 0;
  for (long long rho = blockIdx.x; rho < g.runs; rho += gridDim.x) {
    const Run run = run_at(g, rho);
    for (int z = 0; z < run.count; ++z, ++j) {
      const long long i0 = run.i0 + z * g.plane;
      const bool cont = z > 0;
      walk.next(j, cont, g.windows);
      const int s = j % kMarchStages;
      // the unit the consumers must have released first
      const int done = cont ? j - kMarchStages : j - 1;
      if (done >= 0) sb::mbar_wait(empty + done % kMarchStages, (done / kMarchStages) & 1);
      unsigned char* ds = ring + static_cast<size_t>(s) * g.data_bytes;
      const int kc = min(g.cols, k - run.c0);
      const int w0 = cont ? g.windows - 1 : 0;  // the unit's new windows: w0 ..
      const unsigned data_bytes = static_cast<unsigned>(run.rows * sizeof(TD));
      unsigned bytes = 0;
      for (int job = lane; job < g.ndiag + (g.windows - w0) * kc; job += 32) {
        if (job < g.ndiag) {
          sb::bulk_load(ds + static_cast<size_t>(job) * g.rows * sizeof(TD),
                        data + job * nr_pad + i0, data_bytes, full + s);
          bytes += data_bytes;
          continue;
        }
        const int w = w0 + (job - g.ndiag) / kc;
        const int c = (job - g.ndiag) % kc;
        TX* seg = xring + walk.slot_of(w) * g.slot_vals + c * g.len[w];
        const long long a = i0 + g.lo[w];  // the X row of seg[0]
        const long long lo = max(a, 0LL);
        const long long hi = min(a + g.len[w], n);
        int z0 = g.len[w], z1 = g.len[w];  // zeros: seg[0 .. z0) and seg[z1 .. len)
        if (hi > lo) {
          z0 = static_cast<int>(lo - a);
          z1 = static_cast<int>(hi - a);
          const unsigned b = static_cast<unsigned>((hi - lo) * sizeof(TX));
          sb::bulk_load(seg + z0, x + (run.c0 + c) * ldx + lo, b, full + s);
          bytes += b;
        }
        zero16(seg, z0);
        zero16(seg + z1, g.len[w] - z1);
      }
      sb::fence_proxy_async();  // the zeros, before a later copy into them
      // one arrival for the warp, after its lanes' zeros, expecting its bytes
      bytes = __reduce_add_sync(0xffffffffu, bytes);
      __syncwarp();
      if (lane == 0) sb::mbar_arrive_expect(full + s, bytes);
    }
  }
}

// acc[q] += a[u][q] * w[q + u + S] for the LEN diagonals u of a chunk, in
// order, each op rounded: add_chunk with its length known at compile time
template <int S, int LEN, int W, typename TD, typename TX>
__device__ __forceinline__ void add_run(TX (&acc)[kQuad], const Raw4<TD> (&a)[LEN],
                                        const TX (&w)[W]) {
#pragma unroll
  for (int u = 0; u < LEN; ++u) {
#pragma unroll
    for (int q = 0; q < kQuad; ++q) {
      if (q + u + S < W) {
        acc[q] = add_rn(acc[q], mul_rn(static_cast<TX>(a[u].get(q)), w[q + u + S]));
      }
    }
  }
}

// A chunk of LEN diagonals from a stage, for the thread's kThreadCols
// columns (xw + col[c] is column c's segment, less the thread's r0); S =
// its shift, -1 for a chunk read as scalars. An aligned chunk reads a
// column's vector at xw + col[c] + p and the value before and after it by
// shuffle; every lane loads lane 0's value before and lane 31's value after
// (two addresses a warp), used by those two lanes. Nothing here depends on
// the thread but the addresses, so the shuffles run in converged code.
template <int S, int LEN, typename TD, typename TX>
__device__ __forceinline__ void staged_chunk(TX (&acc)[kThreadCols][kQuad], const TD* ds,
                                             int rows, int d0, const TX* xw,
                                             const int (&col)[kThreadCols], int p,
                                             int lane) {
  Raw4<TD> a[LEN];
#pragma unroll
  for (int u = 0; u < LEN; ++u) a[u].lds(ds + (d0 + u) * rows);
  if constexpr (S < 0) {
#pragma unroll
    for (int c = 0; c < kThreadCols; ++c) {
      TX v[LEN + 3];
#pragma unroll
      for (int m = 0; m < LEN + 3; ++m) v[m] = xw[col[c] + p + m];
      add_run<0, LEN>(acc[c], a, v);
    }
  } else {
    TX w[kThreadCols][6];
    TX edge[kThreadCols];
    const int e = lane < 16 ? -4 * lane - 1 : 4 * (31 - lane) + 4;
#pragma unroll
    for (int c = 0; c < kThreadCols; ++c) {
      const TX* xc = xw + col[c] + p;
      Vec4<TX>::lds(xc, w[c] + 1);
      edge[c] = xc[e];
    }
#pragma unroll
    for (int c = 0; c < kThreadCols; ++c) {
      const TX before = __shfl_up_sync(0xffffffffu, w[c][4], 1);
      const TX after = __shfl_down_sync(0xffffffffu, w[c][1], 1);
      w[c][0] = lane == 0 ? edge[c] : before;
      w[c][5] = lane == 31 ? edge[c] : after;
      add_run<S, LEN>(acc[c], a, w[c]);
    }
  }
}

// A consumer thread: rows r0 .. r0 + 3 of each unit (the threads of a warp
// hold 32 consecutive quads) and kThreadCols columns of the unit's group
// (its slice); it sums the unit window by window and chunk by chunk, in
// the diagonals' order, stores its columns' sums and releases the unit's
// data stage. A slice's columns past the group's are summed from the
// group's last column and not stored.
template <int kRun3, typename TD, typename TX>
__device__ __forceinline__ void staged_consume(TX* y, int k, long long ldy, const Runs& runs,
                                               const Staged& g, const unsigned char* ring,
                                               unsigned long long* full,
                                               unsigned long long* empty) {
  const int quads = g.rows / kQuad;
  const int cs = threadIdx.x / quads * kThreadCols;  // the slice's first column
  const int r0 = threadIdx.x % quads * kQuad;
  const int lane = threadIdx.x & 31;
  const TX* xring =
      reinterpret_cast<const TX*>(ring + static_cast<size_t>(kMarchStages) * g.data_bytes) + r0;
  Walk walk{g.slots};
  int j = 0;
  for (long long rho = blockIdx.x; rho < g.runs; rho += gridDim.x) {
    const Run run = run_at(g, rho);
    const int kc = min(g.cols, k - run.c0);
    for (int z = 0; z < run.count; ++z, ++j) {
      const long long i0 = run.i0 + z * g.plane;
      walk.next(j, z > 0, g.windows);
      const int s = j % kMarchStages;
      sb::mbar_wait(full + s, (j / kMarchStages) & 1);
      const TD* ds = reinterpret_cast<const TD*>(ring + static_cast<size_t>(s) * g.data_bytes) + r0;
      TX acc[kThreadCols][kQuad];
#pragma unroll
      for (int c = 0; c < kThreadCols; ++c) {
#pragma unroll
        for (int q = 0; q < kQuad; ++q) acc[c][q] = TX(0);
      }
      if constexpr (kRun3 > 0) {
        // every chunk an aligned run of three, chunk r on diagonals 3 r ..
        // 3 r + 2: the chunks unrolled, so that one chunk's loads and
        // shuffles overlap the sums before it
#pragma unroll
        for (int r = 0; r < kRun3; ++r) {
          const int w = g.window[r];
          int col[kThreadCols];
#pragma unroll
          for (int c = 0; c < kThreadCols; ++c) col[c] = min(cs + c, kc - 1) * g.len[w];
          const int p = static_cast<int>(runs.start[r] + 1 - g.lo[w]);
          staged_chunk<0, 3>(acc, ds, g.rows, 3 * r, xring + walk.slot_of(w) * g.slot_vals, col,
                             p, lane);
        }
      } else {
        for (int w = 0; w < g.windows; ++w) {
          const TX* xw = xring + walk.slot_of(w) * g.slot_vals;
          int col[kThreadCols];
#pragma unroll
          for (int c = 0; c < kThreadCols; ++c) col[c] = min(cs + c, kc - 1) * g.len[w];
          for (int r = g.first[w]; r < g.first[w + 1]; ++r) {
            const int len = runs.len[r];
            const int d0 = runs.d0[r];
            const int shift = runs.shift[r];
            // xw[col[c] + p0 + m] is X at row i0 + r0 + start + m
            const int p0 = static_cast<int>(runs.start[r] - g.lo[w]);
            const int p = p0 + 1 - shift;  // an aligned chunk's vector
            if (shift == 0) {
              if (len == 3) {
                staged_chunk<0, 3>(acc, ds, g.rows, d0, xw, col, p, lane);
              } else if (len == 2) {
                staged_chunk<0, 2>(acc, ds, g.rows, d0, xw, col, p, lane);
              } else {
                staged_chunk<0, 1>(acc, ds, g.rows, d0, xw, col, p, lane);
              }
            } else if (shift == 1) {
              if (len == 2) {
                staged_chunk<1, 2>(acc, ds, g.rows, d0, xw, col, p, lane);
              } else {
                staged_chunk<1, 1>(acc, ds, g.rows, d0, xw, col, p, lane);
              }
            } else if (shift == 2) {
              staged_chunk<2, 1>(acc, ds, g.rows, d0, xw, col, p, lane);
            } else if (len == 4) {
              staged_chunk<-1, 4>(acc, ds, g.rows, d0, xw, col, p0, lane);
            } else if (len == 3) {
              staged_chunk<-1, 3>(acc, ds, g.rows, d0, xw, col, p0, lane);
            } else if (len == 2) {
              staged_chunk<-1, 2>(acc, ds, g.rows, d0, xw, col, p0, lane);
            } else {
              staged_chunk<-1, 1>(acc, ds, g.rows, d0, xw, col, p0, lane);
            }
          }
        }
      }
      if (r0 < run.rows) {
#pragma unroll
        for (int c = 0; c < kThreadCols; ++c) {
          if (cs + c < kc) Vec4<TX>::store(y + (run.c0 + cs + c) * ldy + i0 + r0, acc[c]);
        }
      }
      // one arrival a warp, once all its lanes have read the stage
      __syncwarp();
      if (lane == 0) sb::mbar_arrive(empty + s);
    }
  }
}

// The staged form: persistent blocks of consumer warps and one producer
// warp (the last), kMarchStages units in flight a block (see the note at
// the top).
// kRun3 > 0: the kRun3 chunks are all aligned runs of three (the 27-point
// stencil with nx = 0 mod 4: 9), summed unrolled. Registers a thread, at
// most: where ptxas chooses under the block's 288 threads it takes 72 and
// spills; at 200^3 the unrolled sums of bf16 diagonals under f32 X took
// 0.398 / 0.255 ms at k = 8 / 3 then, 0.384 / 0.252 at 104; f32
// diagonals 0.806 ms at k = 8 with 96 and 0.816 at 104 (PERF.md §6).
template <typename TD>
constexpr int kStagedRegs = sizeof(TD) == 2 ? 104 : sizeof(TD) == 4 ? 96 : 224;

template <typename TD, typename TX, int kRun3>
__global__ void __maxnreg__(kStagedRegs<TD>)
dia_spmm_kernel_staged(const TD* __restrict__ data, const TX* __restrict__ x,
                       TX* __restrict__ y, long long n, long long nr_pad, int k,
                       long long ldx, long long ldy, Runs runs, Staged g) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + kMarchStages;
  unsigned char* ring = smem + kBarBytes;
  const int consumers = static_cast<int>(blockDim.x) - 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMarchStages; ++s) {
      sb::mbar_init(full + s, 1);
      sb::mbar_init(empty + s, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= consumers) {
    staged_produce<TD, TX>(data, x, n, nr_pad, k, ldx, g, ring, full, empty);
  } else {
    staged_consume<kRun3, TD, TX>(y, k, ldy, runs, g, ring, full, empty);
  }
}

// The march's runs for a grid of at most ``resident`` blocks: the most
// planes a run, up to kRunPlanes, whose busiest block has the fewest
// units (ops/dia_spmm.py march_runs).
void march_runs(Staged& g, int resident) {
  long long best = -1;
  for (int zs = kRunPlanes; zs >= 1; --zs) {
    const long long segs = (g.planes + zs - 1) / zs;
    const long long runs = g.groups * segs * g.strips;
    const long long blocks = std::min(runs, static_cast<long long>(resident));
    const long long busiest = (runs + blocks - 1) / blocks * zs;
    if (best < 0 || busiest < best) {
      best = busiest;
      g.run_planes = zs;
      g.segs = segs;
      g.runs = runs;
    }
  }
}

// The staged form's layout as spmm_plan gives it (``layout``: rows, cols,
// P, the window count, then each window's first chunk, lo and len), with
// what follows from it; false where this kernel cannot run it: rows and
// cols out of range, windows that are not runs of consecutive chunks P
// apart and as wide, a segment not 16 B aligned or short of the rows its
// chunks read, or stages over kSmemBudget.
template <typename TD, typename TX>
bool staged_layout(const Runs& runs, const long long* layout, int ndiag, int k, long long n,
                   long long nr_pad, Staged& g) {
  constexpr long long kE = 16 / sizeof(TX);  // values of 16 B
  const long long rows = layout[0], cols = layout[1], plane = layout[2], count = layout[3];
  if (rows < kTileStep || rows > kTileRows || rows % kTileStep || cols < 1 ||
      cols > kStageCols || plane <= 0 || plane % 8 || n % plane || count < 2 ||
      count > kMaxWindows || nr_pad * static_cast<long long>(sizeof(TD)) % 16) {
    return false;
  }
  const long long* win = layout + 4;  // first, lo, len a window
  for (int w = 0; w < count; ++w, win += 3) {
    if ((w == 0 && win[0] != 0) || win[0] < 0 || win[0] >= runs.count || win[1] % kE ||
        win[2] % kE || win[1] != layout[5] + w * plane || win[2] != layout[6]) {
      return false;
    }
    g.first[w] = static_cast<int>(win[0]);
    g.lo[w] = win[1];
    g.len[w] = static_cast<int>(win[2]);
  }
  g.first[count] = runs.count;
  for (int w = 0; w < count; ++w) {
    if (g.first[w] >= g.first[w + 1]) return false;
    for (int r = g.first[w]; r < g.first[w + 1]; ++r) {
      if (runs.start[r] < g.lo[w] || runs.start[r] + runs.len[r] - 1 + rows > g.lo[w] + g.len[w]) {
        return false;
      }
      g.window[r] = w;
    }
  }
  g.windows = static_cast<int>(count);
  g.rows = static_cast<int>(rows);
  g.cols = static_cast<int>(cols);
  g.groups = (k + g.cols - 1) / g.cols;
  g.ndiag = ndiag;
  g.plane = plane;
  g.slots = g.windows + kMarchStages - 1;
  const long long data_bytes = static_cast<long long>(ndiag) * rows * sizeof(TD);
  const long long slot = cols * layout[6] * static_cast<long long>(sizeof(TX));
  if (kBarBytes + kMarchStages * data_bytes + g.slots * slot + kGuardBytes > kSmemBudget) {
    return false;
  }
  g.data_bytes = static_cast<int>(data_bytes);
  g.slot_vals = static_cast<int>(cols * layout[6]);
  g.strips = static_cast<int>((plane + rows - 1) / rows);
  g.planes = n / plane;
  return true;
}

template <typename TD, typename TX, int kRun3>
int launch_staged_as(const TD* data, const TX* x, TX* y, long long n, long long nr_pad, int k,
                     long long ldx, long long ldy, const Runs& runs, const Staged& g,
                     cudaStream_t stream) {
  const int threads =
      g.rows / kQuad * ((g.cols + kThreadCols - 1) / kThreadCols) + 32;
  const size_t smem = kBarBytes + kGuardBytes + static_cast<size_t>(kMarchStages) * g.data_bytes +
                      static_cast<size_t>(g.slots) * g.slot_vals * sizeof(TX);
  auto kernel = dia_spmm_kernel_staged<TD, TX, kRun3>;
  static size_t configured = 0;
  cudaError_t err = sb::allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks that fit the card at once, for the last block shape
  static size_t cached_smem = 0;
  static int cached_threads = 0, cached_blocks = 0;
  if (smem != cached_smem || threads != cached_threads) {
    err = sb::resident_blocks(kernel, threads, smem, cached_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_smem = smem;
    cached_threads = threads;
  }
  if (cached_blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Staged walk = g;
  march_runs(walk, cached_blocks);
  const long long blocks = std::min(walk.runs, static_cast<long long>(cached_blocks));
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(data, x, y, n, nr_pad, k,
                                                                  ldx, ldy, runs, walk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX>
int launch_staged(const TD* data, const TX* x, TX* y, long long n, long long nr_pad, int k,
                  long long ldx, long long ldy, const Runs& runs, const long long* layout,
                  int ndiag, cudaStream_t stream) {
  Staged g = {};
  if (!staged_layout<TD, TX>(runs, layout, ndiag, k, n, nr_pad, g)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bool run3 = runs.count == 9;
  for (int r = 0; r < runs.count; ++r) {
    run3 = run3 && runs.len[r] == 3 && runs.shift[r] == 0 && runs.d0[r] == 3 * r;
  }
  return run3 ? launch_staged_as<TD, TX, 9>(data, x, y, n, nr_pad, k, ldx, ldy, runs, g, stream)
              : launch_staged_as<TD, TX, 0>(data, x, y, n, nr_pad, k, ldx, ldy, runs, g, stream);
}

// -- launch ------------------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <typename TD, typename TX>
int launch(const void* data, const void* x, void* y, long long n, long long nr_pad,
           int k, long long ldx, long long ldy, int form, int nchunks,
           const long long* start, const int* d0, const int* len, const int* shift,
           const long long* layout, void* stream) {
  if (n <= 0 || nr_pad < n || k <= 0 || ldx < n || ldy < n || nchunks <= 0 ||
      nchunks > kMaxDiags || form < kFormRow || form > kFormStaged) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the staged form reads as the four-row form
  const bool quad = form == kFormQuad || form == kFormStaged;
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
  const TD* d = static_cast<const TD*>(data);
  const TX* xx = static_cast<const TX*>(x);
  TX* yy = static_cast<TX*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kFormStaged) {
    return launch_staged<TD, TX>(d, xx, yy, n, nr_pad, k, ldx, ldy, runs, layout, next, st);
  }
  const int per_block = quad ? kQuadThreads / kSlices : kThreads;
  const long long threads = quad ? n / kQuad : n;
  const unsigned blocks = static_cast<unsigned>((threads + per_block - 1) / per_block);
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

// form: 0 one row a thread, 1 four rows a thread, 2 staged (``layout``,
// read only by the staged form: staged_layout)
#define SB_DIA_SPMM_ENTRY(SUFFIX, TD, TX)                                          \
  int sb_dia_spmm_##SUFFIX(const void* data, const void* x, void* y, long long n,  \
                           long long nr_pad, int k, long long ldx, long long ldy,  \
                           int form, int nchunks, const long long* start,          \
                           const int* d0, const int* len, const int* shift,        \
                           const long long* layout, void* stream) {                \
    return launch<TD, TX>(data, x, y, n, nr_pad, k, ldx, ldy, form, nchunks,      \
                          start, d0, len, shift, layout, stream);                  \
  }

extern "C" {
SB_DIA_SPMM_ENTRY(bf16_f32, __nv_bfloat16, float)
SB_DIA_SPMM_ENTRY(f32_f32, float, float)
SB_DIA_SPMM_ENTRY(f64_f64, double, double)
}  // extern "C"
