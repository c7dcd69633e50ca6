// Slice loops of the slab SpMV for Hopper (sm_90a): P3 and P4 of the port.
//
// Replaces benchmarks/slab_micro.py run_variant (P3; the x-table assembly
// strategies of an (8, 128) slice, make_kernel) and benchmarks/slab_micro2.py
// run_variant (P4; the same loop over (SUB, 128) slices, SUB 8 to 64). Both
// compute, for tile t, sublane s < SUB and lane l,
//
//   y[t, s, l] = sum over the slices p = 0 .. S - 1, in order, of
//                f32(vals[t, p, s, l]) * X[row(t, p, s), lane(t, p, s, l)]
//
// from 0, with X the x table (x_rows, 128) f32, each product and sum rounded
// on its own (__fmul_rn / __fadd_rn), so that the kernel gives the bits of the
// plain version (ops/slab_slices.py slab_slices_torch). vals are bf16 or f32.
// The table mode gives the row:
//   scatter8  meta[t, p, s]           (8 scattered rows, P3 scatter8)
//   slab      meta[t, p, 0] + s       (one slab: slab_u, slab_a, aff_u,
//                                      aff_roll, floor; P4 floor, roll, gather)
//   fixed     s                       (rows 0 .. SUB - 1: fixed, noload)
//   none      no x at all: the term is f32(vals) (P4 sum)
// and the lane mode the lane:
//   lidx      lidx[t, p, s, l]        (int8, the general gather)
//   affine    (l + meta[t, p, 1]) & 127  (aff_u; aff_roll and roll, whose
//                                      pltpu.roll(tbl, -r) is the same lane)
//   identity  l                       (floor)
// A row or lane outside the table reads NaN, so a broken layout shows.
//
// What it computes and none of how: the TPU variants differ in how Mosaic
// builds an (8, 128) lookup table in vregs (8 row loads and a concat, one
// slab load, a lane roll or a lane gather); the per-iteration cost they probe
// is the TPU's. Here one thread computes one output and walks its tile's
// slices at run time; the row and lane are a few integer ops and x is
// gathered through L1/L2 (the table is 0.5 MB at the JAX scripts' sizes). A
// slice's meta row is one broadcast load for the 128 threads of a sublane;
// the value (2 or 4 B) and index (1 B) planes are read coalesced. Table and
// lane modes are template parameters; SUB is the run-time height of a tile.
//
// What bounds it: memory. The value plane, the index plane where the lane
// mode reads it, and meta are read once, y written once; 2 flops a slice
// element (1 for sum).
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns the launch's error code.

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::mul_rn;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kRows = 2;                  // sublane rows a block covers
constexpr int kThreads = kRows * kLanes;

enum Table { kScatter8 = 0, kSlab = 1, kFixed = 2, kNone = 3 };
enum Lane { kLidx = 0, kAffine = 1, kIdentity = 2 };

template <typename TV, int kTable, int kLane>
__global__ void __launch_bounds__(kThreads)
slab_slices_kernel(const int* __restrict__ meta, int meta_w,
                   const float* __restrict__ x, int x_rows,
                   const TV* __restrict__ vals,
                   const signed char* __restrict__ lidx, float* __restrict__ y,
                   int s_max, int sub) {
  const int parts = sub / kRows;
  const int t = blockIdx.x / parts;
  const int s = (blockIdx.x % parts) * kRows + threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  const long long plane = static_cast<long long>(sub) * kLanes;
  const long long e = static_cast<long long>(t) * s_max * plane + s * kLanes + l;
  const int* m = meta + static_cast<long long>(t) * s_max * meta_w;
  const float nan = __int_as_float(0x7fc00000);
  float acc = 0.0f;
#pragma unroll 4
  for (int p = 0; p < s_max; ++p) {
    const long long off = e + p * plane;
    const float v = widen(vals[off]);
    float term;
    if constexpr (kTable == kNone) {
      term = v;
    } else {
      const int* mp = m + p * meta_w;
      const int row = kTable == kScatter8 ? __ldg(mp + s)
                    : kTable == kSlab     ? __ldg(mp) + s
                                          : s;
      const int lane = kLane == kLidx     ? static_cast<int>(lidx[off])
                     : kLane == kAffine   ? ((l + __ldg(mp + 1)) & (kLanes - 1))
                                          : l;
      const float g = (row >= 0 && row < x_rows && lane >= 0 && lane < kLanes)
                          ? __ldg(x + static_cast<long long>(row) * kLanes + lane)
                          : nan;
      term = mul_rn(v, g);
    }
    acc = add_rn(acc, term);
  }
  y[(static_cast<long long>(t) * sub + s) * kLanes + l] = acc;
}

template <typename TV, int kTable, int kLane>
void run(const int* meta, int meta_w, const float* x, int x_rows, const void* vals,
         const void* lidx, float* y, int n_tiles, int s_max, int sub,
         cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>(n_tiles) * (sub / kRows);
  slab_slices_kernel<TV, kTable, kLane><<<grid, kThreads, 0, st>>>(
      meta, meta_w, x, x_rows, static_cast<const TV*>(vals),
      static_cast<const signed char*>(lidx), y, s_max, sub);
}

template <typename TV>
int launch(const void* meta, int meta_w, const void* x, int x_rows,
           const void* vals, const void* lidx, void* y, int n_tiles, int s_max,
           int sub, int table, int lane, void* stream) {
  if (n_tiles <= 0 || s_max <= 0 || sub <= 0 || sub % kRows || x_rows < 0 ||
      meta_w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((table == kScatter8 && meta_w < sub) || (lane == kAffine && meta_w < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* mi = static_cast<const int*>(meta);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
#define SB_SLAB_RUN(T, L) \
  run<TV, T, L>(mi, meta_w, xf, x_rows, vals, lidx, yf, n_tiles, s_max, sub, st)
  if (table == kNone) {
    SB_SLAB_RUN(kNone, kIdentity);
  } else if (table == kScatter8 && lane == kLidx) {
    SB_SLAB_RUN(kScatter8, kLidx);
  } else if (table == kSlab && lane == kLidx) {
    SB_SLAB_RUN(kSlab, kLidx);
  } else if (table == kSlab && lane == kAffine) {
    SB_SLAB_RUN(kSlab, kAffine);
  } else if (table == kSlab && lane == kIdentity) {
    SB_SLAB_RUN(kSlab, kIdentity);
  } else if (table == kFixed && lane == kLidx) {
    SB_SLAB_RUN(kFixed, kLidx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SB_SLAB_RUN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SB_SLAB_ENTRY(SUFFIX, TV)                                             \
  int sb_slab_slices_##SUFFIX(const void* meta, int meta_w, const void* x,    \
                              int x_rows, const void* vals, const void* lidx, \
                              void* y, int n_tiles, int s_max, int sub,       \
                              int table, int lane, void* stream) {            \
    return launch<TV>(meta, meta_w, x, x_rows, vals, lidx, y, n_tiles, s_max, \
                      sub, table, lane, stream);                              \
  }

extern "C" {
SB_SLAB_ENTRY(bf16, __nv_bfloat16)
SB_SLAB_ENTRY(f32, float)
}  // extern "C"
