// BSELL sparse matrix-vector product for Hopper (sm_90a): K9, K10 and K11 of
// the port.
//
// Replaces sparsebench_tpu/ops/bsell_pallas.py: bsell_spmv_pallas (K9, body
// _bsell_kernel, whole x resident in VMEM), bsell_spmv_win2 (K10, body
// _bsell_kernel_win2, a (2W, 128) window of x re-fetched when the tile's
// chunk changes) and bsell_spmv_windowed (K11, body _bsell_kernel_windowed,
// the window as two pipelined W-row chunks), all three summing slices as
// _accumulate_slices does. The layout (formats/bsell.py): rows go 128 to a
// lane group and 8 lane groups to a tile; a slice is an (8, 128) plane of one
// tile whose entries in sublane s all lie in one 128-column block of x. Output
// (t, s, lane), row (8 t + s) 128 + lane, sums over the tile's slices
// p = 0 .. s_max - 1 in stored order
//
//   vals[t,p,s,lane] * X[base_t + blocks[t,p,s], lidx[t,p,s,lane]]
//
// with X the x vector viewed as rows of 128 and base_t the tile's window base
// (K9: base[t,0,0]; K10/K11: wchunk[t] * W, on the windowed layout's x).
//
// K9, K10 and K11 share one slice loop (``LaneGroup`` below) and differ in
// where a gather finds its row of X, which the loop takes as a template
// parameter, its gather policy: K9's ``GlobalRows`` reads x in device memory
// through L1/L2 (all of x is 32 MB at 200^3 in f32, inside the 50 MB L2);
// K10/K11's ``Window`` reads the tile's window from a ring of chunks in
// shared memory.
//
// K9 (what it computes and none of how: the lane-gather lookup table, the
// SMEM block table, the static unroll and the DMA semaphores are ways around
// Mosaic). A grid of persistent blocks of 8 warps, as many as fit the card at
// once; block u of U walks the lane groups [u N / U, (u+1) N / U) of the N =
// 8 n_tiles, a warp a lane group at a time (warp w takes g0 + w, g0 + w + 8,
// ...), so consecutive lane groups, which share their rows of x on a banded
// matrix, stay on one SM (tests/test_torch_bsell_plan.py k9_schedule). No
// shared memory and no barrier: each warp runs the slice loop on its own.
// What bounded the first K9 (one thread an output: a 2 B value, a 1 B index
// and a broadcast block id a slice, three loads for one gather) was its load
// instructions, not its bytes; the shared loop issues two vector loads and
// four gathers for four outputs a slice.
//
// K10 and K11: one body, persistent and chunk-resident, after K7
// (csrc/bslab_spmv.cu; the ring, its copies and the launch helpers are
// csrc/ring.cuh's, which both include).
// * Schedule. The grid is as many units as fit the card at once; a unit is
//   C blocks of 32 warps (the wrappers' ``cluster``: 1 where one block holds
//   the window). Unit u of U walks the lane groups [u N / U, (u+1) N / U) of
//   the N = 8 n_tiles in order, so consecutive tiles, which share their
//   window on a banded matrix, stay in one unit. A step gives each warp of
//   the unit one lane group: up to 32 C consecutive lane groups (4 C tiles),
//   all of tiles with one wchunk; a step ends early where wchunk changes,
//   which on the stencil idles warps for one step every 21 tiles (100^3) or
//   80 (200^3). So a step never spans a chunk change, and the ring holds two
//   chunks. The tests walk this schedule in Python
//   (tests/test_torch_bsell_plan.py k10_schedule).
// * The window. Tile t reads x rows [wchunk[t] W, wchunk[t] W + 2W). Each
//   block keeps a ring of two W-row chunks in shared memory, chunk k in slot
//   k % 2, and copies a chunk only when the step's chunk differs from the
//   last one and the chunk is not resident: the TPU kernel's "copy when c !=
//   prev" rule, and when wchunk advances by one only the one new chunk is
//   copied. A backward or far jump (general layouts) claims and copies what
//   is missing the same way. Thread 0 copies with one 1-D bulk copy
//   (cp.async.bulk) a chunk, completed on the slot's mbarrier; each warp
//   issues its lane group's block ids and first batch of planes before it
//   waits for the copy. Only full rows inside the given x are copied.
// * A unit of several blocks where two chunks exceed a block. Block q of the
//   unit holds rows [q S, (q+1) S) of every chunk (S = ceil(W / C)) and
//   copies that stripe itself. Every (slice, sublane) reads one 128-lane row
//   of x, so a warp brings each slice's row into its own row buffer, one 16 B
//   read a thread (f64: two), and gathers from there: a row of its block's
//   stripe from shared memory, any other from x through L2. No block reads
//   another's shared memory, so the C blocks launch as independent blocks,
//   not as a thread-block cluster: they share only the unit's tile range and
//   step boundaries, which each computes from wchunk alone. Reading a peer's
//   rows through distributed shared memory in a thread-block cluster instead
//   took 1.3x as long at 200^3 a row at a time and 4.8x lane by lane (the
//   bound of K7 there), and the same design launched as a cluster took
//   1.08-1.11x as long at 200^3 as independent blocks (PERF.md §6).
//   ops/bsell_spmv.py win_plan picks the smallest unit whose blocks hold
//   two chunks and the row buffers: 1 block at 100^3 f32 (W 168), 2 at
//   100^3 f64, 4 at 200^3 f32 (W 640; two chunks are 655,360 B), 7 at 200^3
//   f64. Above 8 blocks a unit the wrapper raises, naming the size.
// * The slice loop, K9's too. A warp computes one lane group: thread i owns the four
//   consecutive lanes 4i..4i+3, so a slice's values arrive in one vector load
//   a thread (8 B of bf16, 16 B of f32, 32 B of f64) and its four index bytes
//   in one 4 B load, both with the last-use hint (ld.global.lu: the planes
//   are read once). Its block ids come from registers: lane j of the warp
//   holds slice p0 + j's, loaded 32 slices ahead, and a shuffle hands each
//   slice's to the warp. Slices go in batches (K9 and one block a unit: four
//   with bf16 values, else two; several: the row buffer's two, f64 one), each
//   batch's plane loads issued before the last batch's gathers and sums. A
//   batch checks that every row it reads lies in x (K10/K11: and in the
//   window) and that every lane index is in [0, 128); if so its gathers go out at once
//   and the sums follow with no branch, else every value comes through an
//   exact, guarded read (NaN outside).
// * Bank conflicts. On a shifted (stencil) slice the k-th gather of a warp
//   reads words 4i + k + r of one row, four threads a bank. Gathering in a
//   rotated lane order that puts the 32 threads on 32 banks cost more in
//   byte permutes and selects than the conflicts did (PERF.md §6), so the
//   gathers go in lane order.
// * Edges. K10: a block id outside [0, 2W) reads NaN, so a broken layout
//   shows in the output; K11 clamps the id into the window, as the TPU
//   kernel's clipped reads of its two chunks do. In both, a window row beyond
//   the given x and a negative lane index read NaN.
//
// What bounds them: memory. Per SpMV the value, index and block planes are
// read once, x once and y written once; 2 flops per stored element. K10/K11
// add the chunk copies (two chunks a block, then one a chunk change), each
// block's wait for its first window, and at 200^3 three rows in four from L2
// through the row buffers (PERF.md §7).
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in slice order, so the kernels give the bits of the plain
// PyTorch version (ops/bsell_spmv.py bsell_spmv_torch). Values widen to the x
// type before the multiply. Instances (values, x): (bf16, f32) the default f32
// path with losslessly compressed values, (f32, f32), (f64, f64). Entry points
// launch on the stream they are given, do not synchronise, allocate nothing,
// and return the launch's error code. All three need the planes 16 B
// aligned, K10/K11 x too (the wrapper copies an x that is not).


#include <algorithm>

#include "ring.cuh"

namespace {

using sb::add_rn;
using sb::byte_at;
using sb::mul_rn;
using sb::quiet_nan;
using sb::Raw;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kThreadsK9 = 256;              // 8 warps: a tile's lane groups
constexpr int kWarpsK9 = kThreadsK9 / 32;
constexpr int kThreadsWin = 1024;            // 32 warps: one block an SM (its ring)
constexpr int kWarpsWin = kThreadsWin / 32;
constexpr int kRing = 2;                     // chunks in a block's ring
constexpr int kMaxUnit = 8;                  // blocks a K10/K11 unit
constexpr int kBarBytes = 128;               // the ring's mbarriers, ahead of it

// slices a batch of the slice loop of a unit of one block
template <typename TD>
constexpr int kBatch = sizeof(TD) == 2 ? 4 : 2;
// rows a warp's row buffer holds (the batch of a unit of several blocks):
// 32 KB a block either way
template <typename TX>
constexpr int kBufRows = sizeof(TX) == 8 ? 1 : 2;

// -- the gather policies -----------------------------------------------------------

// K9: window row b is x row base + b, read through L1/L2; NaN outside x
template <typename TX>
struct GlobalRows {
  static constexpr bool kStriped = false;
  const TX* x;
  int base;
  unsigned x_rows;

  __device__ __forceinline__ int id(int b) const { return b; }
  __device__ __forceinline__ bool ok(int b) const {
    return static_cast<unsigned>(base + b) < x_rows;
  }
  __device__ __forceinline__ const TX* row(int b, bool& from_x) const {
    from_x = true;
    return x + static_cast<long long>(base + b) * kLanes;
  }
  __device__ __forceinline__ TX at(const TX* r, int col) const { return __ldg(r + col); }
  // X[base + b, col] for any b and col, NaN outside x or the row
  __device__ __forceinline__ TX exact(int b, int col) const {
    bool from_x;
    return ok(b) && col >= 0 ? __ldg(row(b, from_x) + col) : quiet_nan<TX>();
  }
};

// -- K10 and K11: the window -----------------------------------------------------

// K10/K11: the step's window, x rows [c W, c W + 2W), in the block's ring: window rows
// [0, W) are chunk c, in the slot at ``lower``, rows [W, 2W) chunk c + 1, at
// ``upper``; in a unit of several blocks (kStriped) block ``rank`` holds rows
// [rank S, (rank+1) S) of each chunk, S = ``stripe``. Window rows
// [lo, lo + len) lie in x.
template <typename TX, bool kClamp, bool kStriped_>
struct Window {
  static constexpr bool kStriped = kStriped_;
  const TX* lower;
  const TX* upper;
  const TX* xw;    // x row c W
  int w;
  int stripe;
  float inv_stripe;
  int rank;
  int lo;
  unsigned len;

  // the block id a gather uses: K11 clamps it into the window
  __device__ __forceinline__ int id(int b) const {
    return kClamp ? min(max(b, 0), 2 * w - 1) : b;
  }
  __device__ __forceinline__ bool ok(int b) const {
    return static_cast<unsigned>(b - lo) < len;
  }
  // window row b (b ok): in this block's ring, or in x (``from_x``) where
  // another block of the unit holds it
  __device__ __forceinline__ const TX* row(int b, bool& from_x) const {
    const bool up = b >= w;
    const int within = b - (up ? w : 0);
    const TX* base = up ? upper : lower;
    from_x = false;
    if constexpr (kStriped) {
      // within / stripe, exact: both are below 2^12
      const int owner = __float2int_rz((within + 0.5f) * inv_stripe);
      from_x = owner != rank;
      return from_x ? xw + b * kLanes : base + (within - owner * stripe) * kLanes;
    } else {
      return base + within * kLanes;
    }
  }
  __device__ __forceinline__ TX at(const TX* r, int col) const { return r[col]; }
  // X[c W + b, col] for any b and col, NaN outside the window, x or the row
  __device__ __forceinline__ TX exact(int b, int col) const {
    bool from_x;
    return ok(b) && col >= 0 ? row(b, from_x)[col] : quiet_nan<TX>();
  }
};

// one thread's 16 B pieces of a 128-lane row (f32: one, f64: two), read
// from x through the read-only path (``global``) or from shared memory
template <typename TX> struct Piece;
template <> struct Piece<float> {
  float4 a;
  __device__ __forceinline__ void load(const float* row, int i, bool global) {
    const float4* p = reinterpret_cast<const float4*>(row) + i;
    if (global) {
      a = __ldg(p);
    } else {
      a = *p;
    }
  }
  __device__ __forceinline__ void store(float* row, int i) const {
    reinterpret_cast<float4*>(row)[i] = a;
  }
};
template <> struct Piece<double> {
  double2 a, b;
  __device__ __forceinline__ void load(const double* row, int i, bool global) {
    const double2* p = reinterpret_cast<const double2*>(row) + i;
    if (global) {
      a = __ldg(p);
      b = __ldg(p + 32);
    } else {
      a = p[0];
      b = p[32];
    }
  }
  __device__ __forceinline__ void store(double* row, int i) const {
    reinterpret_cast<double2*>(row)[i] = a;
    reinterpret_cast<double2*>(row)[i + 32] = b;
  }
};

// N consecutive slices' planes for one thread: the values and lane indices
// of its four lanes, as loaded
template <int N, typename TD>
struct Planes {
  Raw<TD> val[N];
  unsigned li[N];
};

// acc[k] += widen(val[k]) * g[k], each op rounded
template <typename TD, typename TX>
__device__ __forceinline__ void fma4(TX acc[4], const Raw<TD>& val, const TX g[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k] = add_rn(acc[k], mul_rn(static_cast<TX>(val.get(k)), g[k]));
  }
}

// One lane group (t, s), computed by the calling warp: thread i sums lanes
// 4i..4i+3 over the tile's slices in stored order, one rounding per op, and
// stores them, gathering through the policy ``Win``. ``start`` issues the
// block ids' and the first batch's loads (K10/K11: before the warp waits for
// its chunks); ``finish`` walks the
// batches, each one's plane loads issued before the last one's gathers and
// sums. Lane j of the warp holds the block id of slice j of the current 32
// (``bid``) and of the next 32 (``bid_next``).
template <int N, typename Win, typename TD, typename TX>
struct LaneGroup {
  static constexpr long long kPlane = kSub * kLanes;
  const TD* v;
  const signed char* li;
  const int* blk;
  int t, s, s_max;
  int bid, bid_next;
  Planes<N, TD> cur;

  __device__ __forceinline__ int block_id(int p) const {
    return p < s_max ? __ldg(blk + p * kSub) : 0;
  }
  // the planes of slices q .. q + N - 1; past s_max the last slice again
  __device__ __forceinline__ void load(Planes<N, TD>& pl, int q) const {
    const int count = min(N, s_max - q);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long off = (q + min(u, count - 1)) * kPlane;
      pl.val[u].load(v + off);
      pl.li[u] = __ldlu(reinterpret_cast<const unsigned*>(li + off));
    }
  }

  __device__ __forceinline__ void start(const int* __restrict__ blocks,
                                        const TD* __restrict__ vals,
                                        const signed char* __restrict__ lidx, int t_,
                                        int s_, int s_max_) {
    t = t_;
    s = s_;
    s_max = s_max_;
    const int i = threadIdx.x & 31;
    const long long e = static_cast<long long>(t) * s_max * kPlane + s * kLanes + 4 * i;
    v = vals + e;
    li = lidx + e;
    blk = blocks + static_cast<long long>(t) * s_max * kSub + s;
    bid = block_id(i);
    bid_next = block_id(32 + i);
    load(cur, 0);
  }

  __device__ __forceinline__ void finish(const Win& win, TX* buf, TX* __restrict__ y) {
    const int i = threadIdx.x & 31;
    TX acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = TX(0);
    for (int q = 0; q < s_max; q += N) {
      if (q > 0 && (q & 31) == 0) {
        bid = bid_next;
        bid_next = block_id(q + 32 + i);
      }
      Planes<N, TD> nxt;
      if (q + N < s_max) load(nxt, q + N);
      const int count = min(N, s_max - q);
      int b[N];
      bool ok = count == N;
      unsigned any = 0;
#pragma unroll
      for (int u = 0; u < N; ++u) {
        b[u] = win.id(__shfl_sync(0xffffffffu, bid, (q & 31) + u));
        ok = ok && win.ok(b[u]);
        any |= cur.li[u];
      }
      if (__all_sync(0xffffffffu, ok && !(any & 0x80808080u))) {
        TX g[N][4];
        if constexpr (Win::kStriped) {
          // each slice's row into the warp's buffer, one 16 B piece a
          // thread, then the gathers from there
          Piece<TX> pc[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            bool from_x;
            const TX* r = win.row(b[u], from_x);
            pc[u].load(r, i, from_x);
          }
          __syncwarp();  // the warp's last gathers from the buffer are done
#pragma unroll
          for (int u = 0; u < N; ++u) pc[u].store(buf + u * kLanes, i);
          __syncwarp();
#pragma unroll
          for (int u = 0; u < N; ++u) {
#pragma unroll
            for (int k = 0; k < 4; ++k) g[u][k] = buf[u * kLanes + byte_at(cur.li[u], k)];
          }
        } else {
#pragma unroll
          for (int u = 0; u < N; ++u) {
            bool from_x;
            const TX* r = win.row(b[u], from_x);
#pragma unroll
            for (int k = 0; k < 4; ++k) g[u][k] = win.at(r, byte_at(cur.li[u], k));
          }
        }
#pragma unroll
        for (int u = 0; u < N; ++u) fma4<TD, TX>(acc, cur.val[u], g[u]);
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) {
          if (u < count) {
            TX g[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) g[k] = win.exact(b[u], byte_at(cur.li[u], k));
            fma4<TD, TX>(acc, cur.val[u], g);
          }
        }
      }
      cur = nxt;
    }
    TX* out = y + (static_cast<long long>(t) * kSub + s) * kLanes + 4 * i;
    if constexpr (sizeof(TX) == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      reinterpret_cast<double2*>(out)[0] = make_double2(acc[0], acc[1]);
      reinterpret_cast<double2*>(out)[1] = make_double2(acc[2], acc[3]);
    }
  }
};

// -- K9: the kernel ------------------------------------------------------------------

// K9: persistent blocks of kWarpsK9 warps; block u walks its lane groups in
// order, a warp a lane group at a time, gathering from x through L1/L2.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreadsK9, 4)
bsell_spmv_kernel(const int* __restrict__ blocks, const int* __restrict__ base,
                  const TX* __restrict__ x, const TD* __restrict__ vals,
                  const signed char* __restrict__ lidx, TX* __restrict__ y,
                  int n_tiles, int s_max, int x_rows) {
  long long g0, g1;
  sb::unit_range(blockIdx.x, gridDim.x, static_cast<long long>(n_tiles) * kSub, g0, g1);
  for (long long g = g0 + (threadIdx.x >> 5); g < g1; g += kWarpsK9) {
    const int t = static_cast<int>(g / kSub);
    LaneGroup<kBatch<TD>, GlobalRows<TX>, TD, TX> lg;
    lg.start(blocks, vals, lidx, t, static_cast<int>(g % kSub), s_max);
    const GlobalRows<TX> rows{x, __ldg(base + static_cast<long long>(t) * kSub),
                              static_cast<unsigned>(x_rows)};
    lg.finish(rows, nullptr, y);
  }
}

// -- K10 and K11: the kernel -------------------------------------------------------

// K10 (kClamp false) and K11 (kClamp true): a persistent unit of
// ``unit_blocks`` blocks walks its lane groups in order, a warp a lane group
// a step, each block with the steps' windows (its stripe of them) in its
// chunk ring.
template <typename TD, typename TX, bool kClamp, bool kStriped>
__global__ void __launch_bounds__(kThreadsWin, 1)
bsell_spmv_win_kernel(const int* __restrict__ blocks,
                      const int* __restrict__ wchunk, const TX* __restrict__ x,
                      const TD* __restrict__ vals,
                      const signed char* __restrict__ lidx, TX* __restrict__ y,
                      int n_tiles, int s_max, int x_rows, int w, int unit_blocks,
                      int stripe) {
  extern __shared__ __align__(128) unsigned char smem[];
  TX* ring = reinterpret_cast<TX*>(smem + kBarBytes);
  // the warps' row buffers, kBufRows rows a warp, after the ring
  TX* bufs = ring + static_cast<long long>(kRing) * stripe * kLanes;
  const int ub = kStriped ? unit_blocks : 1;
  const int rank = blockIdx.x % ub;
  sb::ChunkRing<kRing> rg(reinterpret_cast<unsigned long long*>(smem), kRing);
  __syncthreads();

  // slices a batch: a striped unit's batch fills its warps' row buffers
  constexpr int N = kStriped ? kBufRows<TX> : kBatch<TD>;
  const int warp = threadIdx.x >> 5;
  TX* buf = bufs + static_cast<long long>(warp) * kBufRows<TX> * kLanes;
  // the stripe of chunk k this block holds: x rows [lo, hi) of it, copied
  // to its place in the slot
  auto fetch = [&](int k, int slot) {
    const long long s0 = static_cast<long long>(k) * w + static_cast<long long>(rank) * stripe;
    const long long lo = max(s0, 0LL);
    const long long hi = min(min(s0 + stripe, static_cast<long long>(k) * w + w),
                             static_cast<long long>(x_rows));
    const long long rows = max(hi - lo, 0LL);
    sb::bulk_copy(ring + (static_cast<long long>(slot) * stripe + (rows > 0 ? lo - s0 : 0)) * kLanes,
                  x + (rows > 0 ? lo : 0) * kLanes,
                  static_cast<unsigned>(rows * kLanes * sizeof(TX)), rg.bars + slot);
  };

  long long g0, g1;
  sb::unit_range(blockIdx.x / ub, gridDim.x / ub,
                 static_cast<long long>(n_tiles) * kSub, g0, g1);
  bool have = false;
  int cur_c = 0;
  for (long long g = g0; g < g1;) {
    const int t = static_cast<int>(g / kSub);
    const int c = __ldg(wchunk + t);
    // up to a lane group a warp of the unit, of tiles with chunk c
    long long end = min(g1, g + static_cast<long long>(kWarpsWin) * ub);
    for (long long tt = t + 1; tt * kSub < end; ++tt) {
      if (__ldg(wchunk + tt) != c) {
        end = tt * kSub;
        break;
      }
    }
    const long long mine = g + static_cast<long long>(rank) * kWarpsWin + warp;
    const bool has = mine < end;
    // the lane group's block ids and first planes, in flight while the
    // chunks land
    LaneGroup<N, Window<TX, kClamp, kStriped>, TD, TX> lg;
    if (has) {
      lg.start(blocks, vals, lidx, static_cast<int>(mine / kSub), static_cast<int>(mine % kSub),
               s_max);
    }
    if (!have || c != cur_c) {
      __syncthreads();  // no warp still reads the old chunks
      rg.claim(c, fetch);
      rg.wait_window(c);
      cur_c = c;
      have = true;
    }
    if (has) {
      const long long cw = static_cast<long long>(c) * w;
      const long long lo = max(0LL, -cw);
      const long long hi = min(2LL * w, static_cast<long long>(x_rows) - cw);
      const Window<TX, kClamp, kStriped> win{
          ring + static_cast<long long>(rg.slot(c)) * stripe * kLanes,
          ring + static_cast<long long>(rg.slot(c + 1)) * stripe * kLanes,
          x + cw * kLanes, w, stripe, 1.0f / stripe, rank,
          static_cast<int>(min(lo, 2LL * w)), static_cast<unsigned>(max(hi - lo, 0LL))};
      lg.finish(win, buf, y);
    }
    g = end;
  }
}

// -- launch ------------------------------------------------------------------------

template <typename TD, typename TX>
int launch(const int* blocks, const int* base, const void* x, const void* vals,
           const void* lidx, void* y, int n_tiles, int s_max, int x_rows,
           void* stream) {
  if (n_tiles <= 0 || s_max <= 0 || x_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = bsell_spmv_kernel<TD, TX>;
  static int resident = 0;  // blocks that fit the card at once
  if (resident == 0) {
    const cudaError_t err = sb::resident_blocks(kernel, kThreadsK9, 0, resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // no more blocks than it takes to give every warp a lane group
  const long long groups = static_cast<long long>(n_tiles) * kSub;
  const long long grid = std::min(static_cast<long long>(resident),
                                  (groups + kWarpsK9 - 1) / kWarpsK9);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(grid), kThreadsK9, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, base, static_cast<const TX*>(x), static_cast<const TD*>(vals),
      static_cast<const signed char*>(lidx), static_cast<TX*>(y), n_tiles, s_max, x_rows);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a K10/K11 block: mbarriers, its stripe of the ring's two
// chunks and, in a unit of several blocks, its warps' row buffers
// (ops/bsell_spmv.py win_plan counts the same).
template <typename TX>
size_t win_smem_bytes(int stripe, int unit_blocks) {
  const size_t buffers = unit_blocks > 1 ? sizeof(TX) * kWarpsWin * kBufRows<TX> * kLanes : 0;
  return kBarBytes + sizeof(TX) * static_cast<size_t>(kRing) * stripe * kLanes + buffers;
}

template <typename TD, typename TX, bool kClamp, bool kStriped>
int launch_win_as(const int* blocks, const int* wchunk, const void* x,
                  const void* vals, const void* lidx, void* y, int n_tiles,
                  int s_max, int x_rows, int w_blocks, int unit_blocks, void* stream) {
  const int stripe = (w_blocks + unit_blocks - 1) / unit_blocks;
  const size_t smem = win_smem_bytes<TX>(stripe, unit_blocks);
  auto kernel = bsell_spmv_win_kernel<TD, TX, kClamp, kStriped>;
  static size_t configured = 0;
  cudaError_t err = sb::allow_smem(kernel, smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks that fit the card at once, for the last shared-memory size
  static size_t cached_smem = 0;
  static int cached_blocks = 0;
  if (smem != cached_smem) {
    err = sb::resident_blocks(kernel, kThreadsWin, smem, cached_blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached_smem = smem;
  }
  // whole units, no more than lane groups
  const long long units = std::min(static_cast<long long>(cached_blocks / unit_blocks),
                                   static_cast<long long>(n_tiles) * kSub);
  if (units <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(units * unit_blocks), kThreadsWin, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(blocks), wchunk, static_cast<const TX*>(x),
      static_cast<const TD*>(vals), static_cast<const signed char*>(lidx),
      static_cast<TX*>(y), n_tiles, s_max, x_rows, w_blocks, unit_blocks, stripe);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX, bool kClamp>
int launch_win(const int* blocks, const int* wchunk, const void* x,
               const void* vals, const void* lidx, void* y, int n_tiles,
               int s_max, int x_rows, int w_blocks, int unit_blocks, void* stream) {
  if (n_tiles <= 0 || s_max <= 0 || x_rows < 0 || w_blocks <= 0 || unit_blocks < 1 ||
      unit_blocks > kMaxUnit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (unit_blocks == 1) {
    return launch_win_as<TD, TX, kClamp, false>(blocks, wchunk, x, vals, lidx, y,
                                                n_tiles, s_max, x_rows, w_blocks, 1,
                                                stream);
  }
  return launch_win_as<TD, TX, kClamp, true>(blocks, wchunk, x, vals, lidx, y, n_tiles,
                                             s_max, x_rows, w_blocks, unit_blocks, stream);
}

}  // namespace

#define SB_BSELL_ARGS                                                       \
  const int *blocks, const int *table, const void *x, const void *vals,    \
      const void *lidx, void *y, int n_tiles, int s_max, int x_rows

#define SB_BSELL_ENTRIES(SUFFIX, TD, TX)                                      \
  int sb_bsell_spmv_##SUFFIX(SB_BSELL_ARGS, void* stream) {                   \
    return launch<TD, TX>(blocks, table, x, vals, lidx, y, n_tiles, s_max,    \
                          x_rows, stream);                                    \
  }                                                                           \
  int sb_bsell_spmv_win2_##SUFFIX(SB_BSELL_ARGS, int w_blocks,                \
                                  int unit_blocks, void* stream) {            \
    return launch_win<TD, TX, false>(blocks, table, x, vals, lidx, y,         \
                                     n_tiles, s_max, x_rows, w_blocks,        \
                                     unit_blocks, stream);                    \
  }                                                                           \
  int sb_bsell_spmv_windowed_##SUFFIX(SB_BSELL_ARGS, int w_blocks,            \
                                      int unit_blocks, void* stream) {        \
    return launch_win<TD, TX, true>(blocks, table, x, vals, lidx, y,          \
                                    n_tiles, s_max, x_rows, w_blocks,         \
                                    unit_blocks, stream);                     \
  }

extern "C" {
SB_BSELL_ENTRIES(bf16_f32, __nv_bfloat16, float)
SB_BSELL_ENTRIES(f32_f32, float, float)
SB_BSELL_ENTRIES(f64_f64, double, double)
}  // extern "C"
