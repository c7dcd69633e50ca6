// BSLAB sparse matrix-vector product for Hopper (sm_90a): K6 and K7 of the
// port.
//
// Replaces sparsebench_tpu/ops/bslab_pallas.py: bslab_spmv (K6, body
// _kernel_whole, whole x resident in VMEM) and bslab_spmv_win (K7, body
// _kernel_win, x read through a per-tile window of 2W rows), both summing
// slices as _accumulate does. The layout (formats/bslab.py): rows go 128 to a
// lane group, ``sub`` lane groups to a tile; a slice is a (sub, 128) plane of
// values for one tile, and output (t, s, lane), row (t*sub + s)*128 + lane,
// sums over the tile's slices, in stored order, affine then general then
// wide:
//
//   affine  p: vals_aff[t,p,s,lane] * X[dbase + s,        (lane + r) & 127]
//   general p: vals_gen[t,p,s,lane] * X[dbase + s,        lidx_gen[t,p,s,lane]]
//   wide    p: vals_wide[t,p,s,lane] * X[dbase + s + dblk, lidx_wide[t,p,s,lane]]
//
// with (dbase, r) from meta_aff[t,p], dbase from meta_gen/meta_wide[t,p], and
// X[row, c] = x[(row - lead)*128 + c], zero outside x. The TPU kernels read a
// zero-padded x of ``lead`` leading rows; here x is read unpadded and an index
// outside it gives 0, the same value, which saves the pad copy of every SpMV.
//
// The slice loop (both kernels). A warp computes one lane group: thread i
// owns the four consecutive lanes 4i..4i+3, so a slice's values arrive in
// one vector load a thread (8 B of bf16, 16 B of f32, 32 B of f64) with its
// four index and block bytes in one 4 B load each. Slices go in batches
// (K6: four, K7: two; f64 half that): a batch issues its plane loads, then
// checks that every row it reads is a full row of x (and of K7's window);
// if so all its x loads go out at once and the sums follow with no branch,
// else every value comes through an exact, guarded read (x's first and last
// rows, a class's last partial batch). An affine slice reads lanes
// (4i + r + v) & 127 of one x row: the aligned 16 B (f64: 32 B) piece that
// holds the first and the piece after it, whose lanes are shifted into
// place by r & 3 (K6 loads both pieces; K7 loads one and takes the next
// thread's by a warp shuffle, which halves its requests to a cluster peer).
// General and wide slices gather lane by lane. Planes load with the
// last-use hint (ld.global.lu: they are read once; on the H100 it and the
// streaming hint ld.global.cs beat default caching in every case); x loads
// (K6) with an L2 evict-last policy, so x (8 MB on RGL 2M, 32 MB f32 at
// 200^3) stays in the 50 MB L2 while hundreds of MB of planes stream past.
// No device- or stream-wide cache setting is changed. The loop's
// instructions, not its bytes, bound it first: every branch and address
// that a batch does not need was taken out of its fast path (PERF.md §6
// says what each step bought).
//
// Schedule (both kernels): persistent. The grid is as many blocks (K7:
// clusters) as fit the card at once; unit u of U walks the lane groups
// [u N / U, (u+1) N / U) of the N = n_tiles * sub in order, a step of one
// lane group a warp, never crossing a tile. The block stages a tile's slice
// metadata in shared memory when it reaches the tile, once. The tests walk
// K7's schedule in Python (tests/test_torch_bslab_plan.py k7_schedule).
//
// K7's window. Tile t reads x rows [wchunk[t] W, wchunk[t] W + 2W) (the chunk
// plan of formats/bslab.py). The unit keeps a ring of ``ring`` (2 or 3)
// W-row chunks in shared memory, chunk k in slot k % ring, and fetches a
// chunk only when wchunk advances past what is resident: the TPU kernel's
// "copy when c != prev" rule, and when c advances by one only the one new
// chunk is copied, the old window's upper half being the new one's lower
// half. Thread 0 copies with one 1-D bulk copy (cp.async.bulk, the TMA's
// non-tensor form) a chunk, completed on the slot's mbarrier; the block
// waits for it only after it has staged the tile's metadata. With a third
// slot the chunk after the window (c + 2) is fetched at the same time and
// lands while the block computes on c and c + 1. Only full x rows are
// copied; rows outside x read 0 and the partial last row of x reads x
// itself, so a copy never reads past x. A read outside the tile's window
// gives NaN, so a layout whose slices leave their window shows in the output.
// Where the ring is larger than a block's 227 KB the unit is a thread-block
// cluster of C (<= 8) blocks: each block holds rows [q S, (q+1) S) of every
// chunk (S = ceil(W / C)), copies that stripe itself, and reads the others'
// through distributed shared memory (map_shared_rank); the cluster's blocks
// share the unit's lane groups and pass its barriers together. At 200^3 f32
// (2W = 1520 rows, 778 KB) the smallest cluster that holds two chunks is 4
// (ops/bslab_spmv.py win_plan picks it; a third chunk would take 6). The
// ring, its bulk copies and the launch helpers are csrc/ring.cuh's, shared
// with the bsell kernels K10/K11.
//
// What bounds them: memory, and the instructions of the gathers. Per SpMV
// every slice plane is read once (values, plus an int8 index plane per
// general slice and index and block planes per wide slice), x once and y
// written once; 2 flops per stored element. The loop's instructions keep
// K6 below that bound (PERF.md §6). K7 adds the chunk copies, W rows of x a
// chunk a unit; in a cluster three of four x reads at 200^3 go to a peer's
// shared memory, and those requests bound K7 there.
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in the slice order above, so the kernels give the bits of the
// plain PyTorch version (ops/bslab_spmv.py bslab_spmv_torch). Values widen to
// the x type before the multiply. Instances (values, x): (bf16, f32) the
// default f32 path with losslessly compressed values, (f32, f32), (f64, f64).
// Entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return the launch's error code. x and the planes
// must be 16 B aligned (the wrapper copies an x that is not).

#include <cooperative_groups.h>

#include <algorithm>

#include "ring.cuh"

namespace {

namespace cg = cooperative_groups;

using sb::add_rn;
using sb::bulk_copy;
using sb::byte_at;
using sb::mul_rn;
using sb::quiet_nan;
using sb::Raw;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kThreadsK6 = 512;        // 16 warps, a lane group each; 2 an SM
constexpr int kThreadsK7 = 1024;       // 32 warps: one block an SM (its ring)
constexpr int kWarpsK6 = kThreadsK6 / 32;
constexpr int kWarpsK7 = kThreadsK7 / 32;
constexpr int kMaxRing = 3;
constexpr int kMaxCluster = 8;
constexpr int kBarBytes = 128;         // K7's mbarriers, ahead of the ring
constexpr int kMetaSmemK6 = 48 * 1024;
constexpr long long kMaxX = (1LL << 31) - 1;  // x is indexed in int

// slices a batch of the slice loop: K6 four (f64 two); K7, whose gathers
// keep more state, half that
template <typename TD>
constexpr int kBatchK6 = sizeof(TD) == 8 ? 2 : 4;
template <typename TD>
constexpr int kBatchK7 = kBatchK6<TD> / 2;

struct Slices {
  const int* meta_aff;  // (n_tiles, s_aff, 2) [dbase, r]
  const void* vals_aff;
  const int* meta_gen;  // (n_tiles, s_gen) dbase
  const void* vals_gen;
  const signed char* lidx_gen;
  const int* meta_wide;  // (n_tiles, s_wide) dbase at dblk == 0
  const void* vals_wide;
  const signed char* lidx_wide;
  const signed char* dblk_wide;
  int s_aff, s_gen, s_wide;
};

// -- loads ------------------------------------------------------------------------

using Policy = unsigned long long;

__device__ __forceinline__ Policy evict_last() {
  Policy p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// x loads (K6): kept in L2 ahead of the planes
__device__ __forceinline__ float ld_x(const float* p, Policy pol) {
  float r;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(r) : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ double ld_x(const double* p, Policy pol) {
  double r;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
      : "=d"(r) : "l"(p), "l"(pol));
  return r;
}

// four consecutive x values from a 16 B (f32) or 32 B (f64) aligned
// address, kept in L2 ahead of the planes (K6)
__device__ __forceinline__ void ld_x4(const float* p, Policy pol, float out[4]) {
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(out[0]), "=f"(out[1]), "=f"(out[2]), "=f"(out[3])
      : "l"(p), "l"(pol));
}

__device__ __forceinline__ void ld_x4(const double* p, Policy pol,
                                      double out[4]) {
  asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(out[0]), "=d"(out[1]) : "l"(p), "l"(pol));
  asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(out[2]), "=d"(out[3]) : "l"(p + 2), "l"(pol));
}

// the same from shared memory (K7; a generic address, local or a peer's)
__device__ __forceinline__ void ld_win4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void ld_win4(const double* p, double out[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// out[v] = (a ++ b)[o + v] for a warp-uniform o in 0..3
template <typename TX>
__device__ __forceinline__ void shift4(const TX a[4], const TX b[4], int o,
                                       TX out[4]) {
  TX f[8] = {a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3]};
  TX t[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) t[j] = (o & 1) ? f[j + 1] : f[j];
#pragma unroll
  for (int v = 0; v < 4; ++v) out[v] = (o & 2) ? t[v + 2] : t[v];
}

// -- gathers ---------------------------------------------------------------------
//
// ok(row) says that X's row is a full row at ptr(row) (K6: in x; K7: in x
// and in the tile's window, in the ring); exact(row, c) gives X[row, c] for
// any row, and runs only where ok(row) is false (x's first and last rows,
// K7's window edges).

// X[row, c] from x in device memory (K6)
template <typename TX>
struct GlobalX {
  const TX* x;
  int n;
  int lead;
  unsigned rows;   // full x rows: padded rows [lead, lead + rows)
  Policy pol;

  __device__ __forceinline__ bool ok(int row) const {
    return static_cast<unsigned>(row - lead) < rows;
  }
  __device__ __forceinline__ const TX* ptr(int row) const {
    return x + static_cast<long long>(row - lead) * kLanes;
  }
  __device__ __forceinline__ TX load(const TX* p) const { return ld_x(p, pol); }
  // lanes 4i + v of an affine slice at shift r: columns (4i + r + v) & 127,
  // the aligned piece that holds the first and the next one
  __device__ __forceinline__ void affine4(int row, int r, TX out[4]) const {
    const TX* p = ptr(row);
    const int q = ((threadIdx.x & 31) + (r >> 2)) & 31;
    TX a[4], b[4];
    ld_x4(p + 4 * q, pol, a);
    ld_x4(p + 4 * ((q + 1) & 31), pol, b);
    shift4(a, b, r & 3, out);
  }
  __device__ __forceinline__ TX exact(int row, int c) const {
    const long long j = static_cast<long long>(row - lead) * kLanes + c;
    return (j >= 0 && j < n) ? ld_x(x + j, pol) : TX(0);
  }
};

// X[row, c] through the tile's window [win0, win0 + 2W) held in the unit's
// chunk ring (K7): the window's lower W rows are chunk wchunk[t], in the
// slot at ``lower``, the upper ones the next chunk, at ``upper``; in a
// cluster a block holds rows [q S, (q+1) S) of each, S = ``stripe``.
template <typename TX, bool kCluster>
struct RingX {
  const TX* lower;
  const TX* upper;
  const TX* x;
  int n;
  int lead;
  int full_end;    // padded rows [lead, full_end) are full x rows
  int win0;        // wchunk[t] * W
  int w;           // W
  int stripe;
  float inv_stripe;
  int lo;          // ok rows: [lo, lo + len)
  unsigned len;

  __device__ __forceinline__ bool ok(int row) const {
    return static_cast<unsigned>(row - lo) < len;
  }
  // a row of the window, here or in the cluster peer that holds it
  __device__ __forceinline__ const TX* ptr(int row) const {
    const bool up = row >= win0 + w;
    const int within = row - win0 - (up ? w : 0);
    const TX* base = up ? upper : lower;
    if constexpr (kCluster) {
      // within / stripe, exact: both are below 2^12
      const int rank = __float2int_rz((within + 0.5f) * inv_stripe);
      return cg::this_cluster().map_shared_rank(
          const_cast<TX*>(base) + (within - rank * stripe) * kLanes, rank);
    } else {
      return base + within * kLanes;
    }
  }
  __device__ __forceinline__ TX load(const TX* p) const { return *p; }
  __device__ __forceinline__ void affine4(int row, int r, TX out[4]) const {
    const TX* p = ptr(row);
    const int i = threadIdx.x & 31;
    const int q = (i + (r >> 2)) & 31;
    TX a[4], b[4];
    ld_win4(p + 4 * q, a);
#pragma unroll
    for (int k = 0; k < 4; ++k) b[k] = __shfl_sync(0xffffffffu, a[k], (i + 1) & 31);
    shift4(a, b, r & 3, out);
  }
  __device__ __forceinline__ TX exact(int row, int c) const {
    if (row < win0 || row >= win0 + 2 * w) return quiet_nan<TX>();
    if (row >= lead && row < full_end) return ptr(row)[c];
    const long long j = static_cast<long long>(row - lead) * kLanes + c;
    return (j >= 0 && j < n) ? __ldg(x + j) : TX(0);
  }
};

// The tile's metadata into shared memory: [aff dbase, r]*, gen*, wide*.
__device__ __forceinline__ void load_meta(int* meta, const Slices& sl, int t) {
  const int na = 2 * sl.s_aff;
  const int* ga = sl.meta_aff + static_cast<long long>(t) * na;
  const int* gg = sl.meta_gen + static_cast<long long>(t) * sl.s_gen;
  const int* gw = sl.meta_wide + static_cast<long long>(t) * sl.s_wide;
  const int total = na + sl.s_gen + sl.s_wide;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    meta[k] = k < na ? ga[k]
            : k < na + sl.s_gen ? gg[k - na]
            : gw[k - na - sl.s_gen];
  }
}

// -- the slice loop ---------------------------------------------------------------

enum Kind { kAffine, kGeneral, kWide };

// One class of a tile's slices for one lane group: each plane's slice 0 at
// the thread's first lane, and the elements from one slice to the next.
template <typename TD>
struct ClassPlanes {
  const TD* vals;
  const signed char* lidx;
  const signed char* dblk;
  int plane;
  int count;  // slices
};

// N consecutive slices of one class for one thread: values, lane indices
// and block deltas of its four lanes
template <int N, typename TD>
struct Batch {
  Raw<TD> val[N];
  unsigned li[N];
  unsigned db[N];
};

// N slices from the planes at v (value), li and db (index and block), each
// ``plane`` elements after the last, one vector load a plane a slice, with
// the last-use hint (the planes are read once). ``count`` < N loads the
// first count slices and repeats the last.
template <int N, Kind kKind, typename TD>
__device__ __forceinline__ void fetch(const TD* v, const signed char* li,
                                      const signed char* db, int plane,
                                      int count, Batch<N, TD>& bt) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int off = min(u, count - 1) * plane;
    bt.val[u].load(v + off);
    bt.li[u] = kKind != kAffine ? __ldlu(reinterpret_cast<const unsigned*>(li + off)) : 0u;
    bt.db[u] = kKind == kWide ? __ldlu(reinterpret_cast<const unsigned*>(db + off)) : 0u;
  }
}

// the x row slice q reads (before dblk)
template <Kind kKind>
__device__ __forceinline__ int slice_row(const int* meta, int q, int s) {
  return meta[kKind == kAffine ? 2 * q : q] + s;
}

// the x column lane 4i + k reads in slice q (u of the batch)
template <Kind kKind, int N, typename TD>
__device__ __forceinline__ int slice_col(const int* meta, int q,
                                         const Batch<N, TD>& bt, int u, int k) {
  return kKind == kAffine ? (4 * (threadIdx.x & 31) + k + meta[2 * q + 1]) & (kLanes - 1)
                          : byte_at(bt.li[u], k);
}

// acc[k] += widen(val) * g, each op rounded
template <typename TD, typename TX>
__device__ __forceinline__ void fma4(TX acc[4], const Raw<TD>& val, const TX g[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k] = add_rn(acc[k], mul_rn(static_cast<TX>(val.get(k)), g[k]));
  }
}

// Sum the N slices q0.. of a full batch whose every row is ok: all x loads
// first, then the sums in slice order. No branch.
template <int N, Kind kKind, typename TD, typename TX, typename Gather>
__device__ __forceinline__ void consume_fast(const Batch<N, TD>& bt, int q0,
                                             const int* meta, int s,
                                             const Gather& gx, TX acc[4]) {
  TX g[N][4];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int row = slice_row<kKind>(meta, q0 + u, s);
    if constexpr (kKind == kAffine) {
      gx.affine4(row, meta[2 * (q0 + u) + 1], g[u]);
    } else if constexpr (kKind == kGeneral) {
      const TX* p = gx.ptr(row);
#pragma unroll
      for (int k = 0; k < 4; ++k) g[u][k] = gx.load(p + byte_at(bt.li[u], k));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        g[u][k] = gx.load(gx.ptr(row + byte_at(bt.db[u], k)) + byte_at(bt.li[u], k));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < N; ++u) fma4<TD, TX>(acc, bt.val[u], g[u]);
}

// The same for the first ``count`` slices of any batch, every x value from
// exact().
template <int N, Kind kKind, typename TD, typename TX, typename Gather>
__device__ __forceinline__ void consume_slow(const Batch<N, TD>& bt, int q0,
                                             int count, const int* meta,
                                             int s, const Gather& gx,
                                             TX acc[4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (u < count) {
      const int row = slice_row<kKind>(meta, q0 + u, s);
      TX g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        g[k] = gx.exact(row + byte_at(bt.db[u], k), slice_col<kKind>(meta, q0 + u, bt, u, k));
      }
      fma4<TD, TX>(acc, bt.val[u], g);
    }
  }
}

// whether every row of the batch's slices is ok (wide: lane by lane)
template <int N, Kind kKind, typename TD, typename Gather>
__device__ __forceinline__ bool batch_ok(const Batch<N, TD>& bt, int q0,
                                         const int* meta, int s,
                                         const Gather& gx) {
  bool ok = true;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int row = slice_row<kKind>(meta, q0 + u, s);
    if constexpr (kKind == kWide) {
#pragma unroll
      for (int k = 0; k < 4; ++k) ok = ok && gx.ok(row + byte_at(bt.db[u], k));
    } else {
      ok = ok && gx.ok(row);
    }
  }
  return ok;
}

// One class of slices of a lane group into acc: full batches of N through
// the branch-free path where their rows are ok, then the rest.
template <int N, Kind kKind, typename TD, typename TX, typename Gather>
__device__ __forceinline__ void slice_class(const ClassPlanes<TD>& c,
                                            const int* meta, int s,
                                            const Gather& gx, TX acc[4]) {
  const TD* v = c.vals;
  const signed char* li = c.lidx;
  const signed char* db = c.dblk;
  const long long step = static_cast<long long>(N) * c.plane;
  int q0 = 0;
  for (; q0 + N <= c.count; q0 += N, v += step, li += step, db += step) {
    Batch<N, TD> bt;
    fetch<N, kKind, TD>(v, li, db, c.plane, N, bt);
    if (batch_ok<N, kKind, TD>(bt, q0, meta, s, gx)) {
      consume_fast<N, kKind, TD, TX>(bt, q0, meta, s, gx, acc);
    } else {
      consume_slow<N, kKind, TD, TX>(bt, q0, N, meta, s, gx, acc);
    }
  }
  if (q0 < c.count) {
    Batch<N, TD> bt;
    fetch<N, kKind, TD>(v, li, db, c.plane, c.count - q0, bt);
    consume_slow<N, kKind, TD, TX>(bt, q0, c.count - q0, meta, s, gx, acc);
  }
}

// One lane group (t, s), computed by the calling warp: thread i sums lanes
// 4i..4i+3 over the tile's slices in stored order, one rounding per op, and
// stores them.
template <int N, typename TD, typename TX, typename Gather>
__device__ __forceinline__ void lane_group(const Slices& sl, const int* meta,
                                           int t, int s, int sub,
                                           const Gather& gx, TX* y) {
  const int plane = sub * kLanes;
  const int lane = s * kLanes + 4 * (threadIdx.x & 31);
  TX acc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = TX(0);
  {
    const long long off = static_cast<long long>(t) * sl.s_aff * plane + lane;
    const ClassPlanes<TD> c{static_cast<const TD*>(sl.vals_aff) + off, nullptr,
                            nullptr, plane, sl.s_aff};
    slice_class<N, kAffine, TD, TX>(c, meta, s, gx, acc);
  }
  const int* mg = meta + 2 * sl.s_aff;
  {
    const long long off = static_cast<long long>(t) * sl.s_gen * plane + lane;
    const ClassPlanes<TD> c{static_cast<const TD*>(sl.vals_gen) + off,
                            sl.lidx_gen + off, nullptr, plane, sl.s_gen};
    slice_class<N, kGeneral, TD, TX>(c, mg, s, gx, acc);
  }
  const int* mw = mg + sl.s_gen;
  {
    const long long off = static_cast<long long>(t) * sl.s_wide * plane + lane;
    const ClassPlanes<TD> c{static_cast<const TD*>(sl.vals_wide) + off,
                            sl.lidx_wide + off, sl.dblk_wide + off, plane,
                            sl.s_wide};
    slice_class<N, kWide, TD, TX>(c, mw, s, gx, acc);
  }
  TX* out = y + (static_cast<long long>(t) * sub + s) * kLanes + 4 * (threadIdx.x & 31);
  if constexpr (sizeof(TX) == 4) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    reinterpret_cast<double2*>(out)[0] = make_double2(acc[0], acc[1]);
    reinterpret_cast<double2*>(out)[1] = make_double2(acc[2], acc[3]);
  }
}

// lane groups [g0, g1) of unit u of ``units``: an even split of ``total``
// K6: a persistent block walks its lane groups, a warp a lane group a step.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreadsK6, 2)
bslab_spmv_kernel(Slices sl, const TX* __restrict__ x, int n,
                  TX* __restrict__ y, int n_tiles, int sub, int lead) {
  extern __shared__ int meta[];
  const GlobalX<TX> gx{x, n, lead, static_cast<unsigned>(n / kLanes),
                       evict_last()};
  const int warp = threadIdx.x >> 5;
  long long g0, g1;
  sb::unit_range(blockIdx.x, gridDim.x, static_cast<long long>(n_tiles) * sub, g0, g1);
  int cur_t = -1;
  for (long long g = g0; g < g1;) {
    const int t = static_cast<int>(g / sub);
    const long long end = min(min(g1, static_cast<long long>(t + 1) * sub),
                              g + kWarpsK6);
    if (t != cur_t) {
      __syncthreads();  // the previous tile's metadata is no longer read
      load_meta(meta, sl, t);
      __syncthreads();
      cur_t = t;
    }
    const long long mine = g + warp;
    if (mine < end) {
      const int s = static_cast<int>(mine - static_cast<long long>(t) * sub);
      lane_group<kBatchK6<TD>, TD, TX>(sl, meta, t, s, sub, gx, y);
    }
    g = end;
  }
}

// -- K7 ---------------------------------------------------------------------------

// K7: a persistent unit (a block, or a cluster of them) walks its lane groups
// in order, a warp a lane group a step, with the tiles' windows in its ring.
template <typename TD, typename TX, bool kCluster>
__global__ void __launch_bounds__(kThreadsK7, 1)
bslab_spmv_win_kernel(Slices sl, const int* __restrict__ wchunk,
                      const TX* __restrict__ x, int n,
                      TX* __restrict__ y, int n_tiles, int sub, int lead,
                      int w, int stripe, int ring_n) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);
  TX* ring = reinterpret_cast<TX*>(smem + kBarBytes);
  int* meta = reinterpret_cast<int*>(ring + static_cast<long long>(ring_n) * stripe * kLanes);
  int csize = 1, rank = 0;
  if constexpr (kCluster) {
    csize = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  sb::ChunkRing<kMaxRing> rg(bars, ring_n);
  sb::sync_unit<kCluster>();

  const int warp = threadIdx.x >> 5;
  const int full_end = lead + static_cast<int>(n / kLanes);
  // the stripe of chunk k this block holds: padded rows [lo, hi) of x's
  // full rows, copied to its slot
  auto fetch = [&](int k, int slot) {
    const int s0 = k * w + rank * stripe;
    const int lo = max(s0, lead);
    const int hi = min(min(s0 + stripe, k * w + w), full_end);
    const int rows = max(hi - lo, 0);
    bulk_copy(ring + (static_cast<long long>(slot) * stripe + (lo - s0)) * kLanes,
              x + static_cast<long long>(lo - lead) * kLanes,
              static_cast<unsigned>(rows) * kLanes * sizeof(TX), bars + slot);
  };

  long long g0, g1;
  const long long units = gridDim.x / csize;
  sb::unit_range(blockIdx.x / csize, units, static_cast<long long>(n_tiles) * sub, g0, g1);
  int cur_t = -1, cur_c = -1;
  for (long long g = g0; g < g1;) {
    const int t = static_cast<int>(g / sub);
    const long long end = min(min(g1, static_cast<long long>(t + 1) * sub),
                              g + static_cast<long long>(kWarpsK7) * csize);
    if (t != cur_t) {
      const int c = wchunk[t];
      if (c != cur_c) {
        sb::sync_unit<kCluster>();  // no block still reads the old chunks
        rg.claim(c, fetch);
        load_meta(meta, sl, t);
        rg.wait_window(c);
        sb::sync_unit<kCluster>();  // every block's stripes have landed
        cur_c = c;
      } else {
        __syncthreads();
        load_meta(meta, sl, t);
        __syncthreads();
      }
      cur_t = t;
    }
    const long long mine = g + static_cast<long long>(rank) * kWarpsK7 + warp;
    if (mine < end) {
      const int win0 = cur_c * w;
      const int lo = max(win0, lead);
      const RingX<TX, kCluster> gx{
          ring + rg.slot(cur_c) * stripe * kLanes,
          ring + rg.slot(cur_c + 1) * stripe * kLanes, x, n, lead,
          full_end, win0, w, stripe, 1.0f / stripe, lo,
          static_cast<unsigned>(max(min(win0 + 2 * w, full_end) - lo, 0))};
      const int s = static_cast<int>(mine - static_cast<long long>(t) * sub);
      lane_group<kBatchK7<TD>, TD, TX>(sl, meta, t, s, sub, gx, y);
    }
    g = end;
  }
  rg.drain();
  if constexpr (kCluster) {
    cg::this_cluster().sync();  // peers may still read this block's ring
  }
}

// -- launch ------------------------------------------------------------------------

Slices make_slices(const int* meta_aff, const void* vals_aff,
                   const int* meta_gen, const void* vals_gen,
                   const void* lidx_gen, const int* meta_wide,
                   const void* vals_wide, const void* lidx_wide,
                   const void* dblk_wide, int s_aff, int s_gen, int s_wide) {
  return Slices{meta_aff, vals_aff, meta_gen, vals_gen,
                static_cast<const signed char*>(lidx_gen), meta_wide, vals_wide,
                static_cast<const signed char*>(lidx_wide),
                static_cast<const signed char*>(dblk_wide), s_aff, s_gen,
                s_wide};
}

bool bad_shape(int n_tiles, int sub, const Slices& sl) {
  return n_tiles <= 0 || sub <= 0 || sub % 8 != 0 || sl.s_aff < 0 ||
         sl.s_gen < 0 || sl.s_wide < 0;
}

size_t meta_bytes(const Slices& sl) {
  return sizeof(int) * static_cast<size_t>(2 * sl.s_aff + sl.s_gen + sl.s_wide);
}

template <typename TD, typename TX>
int launch(const Slices& sl, const void* x, long long n, void* y, int n_tiles,
           int sub, int lead, void* stream) {
  const size_t smem = meta_bytes(sl);
  if (bad_shape(n_tiles, sub, sl) || n <= 0 || n > kMaxX || smem > kMetaSmemK6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = bslab_spmv_kernel<TD, TX>;
  // the occupancy of the last metadata size asked for
  static size_t cached_smem = ~size_t(0);
  static int cached_blocks = 0;
  if (smem != cached_smem) {
    const cudaError_t err = sb::resident_blocks(kernel, kThreadsK6, smem, cached_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_smem = smem;
  }
  if (cached_blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long groups = static_cast<long long>(n_tiles) * sub;
  const unsigned blocks = static_cast<unsigned>(
      std::min(static_cast<long long>(cached_blocks), (groups + kWarpsK6 - 1) / kWarpsK6));
  kernel<<<blocks, kThreadsK6, smem, static_cast<cudaStream_t>(stream)>>>(
      sl, static_cast<const TX*>(x), static_cast<int>(n), static_cast<TX*>(y),
      n_tiles, sub, lead);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a K7 block: mbarriers, the ring's stripes, the metadata.
template <typename TX>
size_t win_smem_bytes(int stripe, int ring_n, const Slices& sl) {
  return kBarBytes + sizeof(TX) * static_cast<size_t>(ring_n) * stripe * kLanes +
         meta_bytes(sl);
}

template <typename TD, typename TX, bool kCluster>
int launch_win_as(const Slices& sl, const int* wchunk, int w_blocks,
                  const void* x, long long n, void* y, int n_tiles, int sub,
                  int lead, int cluster, int ring_n, void* stream) {
  const int stripe = (w_blocks + cluster - 1) / cluster;
  const size_t smem = win_smem_bytes<TX>(stripe, ring_n, sl);
  auto kernel = bslab_spmv_win_kernel<TD, TX, kCluster>;
  static size_t configured = 0;
  cudaError_t err = sb::allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(kThreadsK7);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  // units that fit the card at once (a unit: one block, or one cluster)
  int units = 0;
  if constexpr (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(static_cast<unsigned>(cluster));
    err = cudaOccupancyMaxActiveClusters(&units, kernel, &cfg);
  } else {
    err = sb::resident_blocks(kernel, kThreadsK7, smem, units);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (units <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(static_cast<unsigned>(units * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, sl, wchunk, static_cast<const TX*>(x),
                           static_cast<int>(n), static_cast<TX*>(y), n_tiles, sub, lead, w_blocks,
                           stripe, ring_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX>
int launch_win(const Slices& sl, const int* wchunk, int w_blocks,
               const void* x, long long n, void* y, int n_tiles, int sub,
               int lead, int cluster, int ring_n, void* stream) {
  if (bad_shape(n_tiles, sub, sl) || n <= 0 || n > kMaxX || w_blocks <= 0 || cluster < 1 ||
      cluster > kMaxCluster || ring_n < 2 || ring_n > kMaxRing) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster == 1) {
    return launch_win_as<TD, TX, false>(sl, wchunk, w_blocks, x, n, y, n_tiles,
                                        sub, lead, 1, ring_n, stream);
  }
  return launch_win_as<TD, TX, true>(sl, wchunk, w_blocks, x, n, y, n_tiles,
                                     sub, lead, cluster, ring_n, stream);
}

}  // namespace

#define SB_BSLAB_ARGS                                                        \
  const int *meta_aff, const void *vals_aff, const int *meta_gen,           \
      const void *vals_gen, const void *lidx_gen, const int *meta_wide,     \
      const void *vals_wide, const void *lidx_wide, const void *dblk_wide,  \
      int s_aff, int s_gen, int s_wide, const void *x, long long n, void *y, \
      int n_tiles, int sub, int lead
#define SB_BSLAB_SLICES                                                     \
  make_slices(meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, meta_wide, \
              vals_wide, lidx_wide, dblk_wide, s_aff, s_gen, s_wide)

#define SB_BSLAB_ENTRIES(SUFFIX, TD, TX)                                      \
  int sb_bslab_spmv_##SUFFIX(SB_BSLAB_ARGS, void* stream) {                   \
    return launch<TD, TX>(SB_BSLAB_SLICES, x, n, y, n_tiles, sub, lead,       \
                          stream);                                            \
  }                                                                           \
  int sb_bslab_spmv_win_##SUFFIX(SB_BSLAB_ARGS, const int* wchunk,            \
                                 int w_blocks, int cluster, int ring,         \
                                 void* stream) {                              \
    return launch_win<TD, TX>(SB_BSLAB_SLICES, wchunk, w_blocks, x, n, y,     \
                              n_tiles, sub, lead, cluster, ring, stream);     \
  }

extern "C" {
SB_BSLAB_ENTRIES(bf16_f32, __nv_bfloat16, float)
SB_BSLAB_ENTRIES(f32_f32, float, float)
SB_BSLAB_ENTRIES(f64_f64, double, double)
}  // extern "C"
