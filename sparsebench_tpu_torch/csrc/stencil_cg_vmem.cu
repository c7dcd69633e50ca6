// The whole CG solve on the matrix-free stencil in one launch, for Hopper
// (sm_90a): K5 of the port.
//
// Replaces sparsebench_tpu/ops/stencil_cg_vmem.py stencil_cg_vmem_pallas
// (_cg_kernel :121, pallas_call :299). It takes r0 = b - A x0 and x0 and
// returns x and the residual history hist[itermax] (NaN past the exit),
// with the recurrence of that kernel, itself standard CG's
// (src/CGSolver.c:94-129):
//
//   hist[0] = sqrt(r.r); for k = 1 .. itermax-1:
//     active = !done && sqrt(rtrans_prev) > eps     (the lagged exit test)
//     hist[k] = active ? sqrt(rtrans) : NaN; stop once inactive
//     beta = 0 if k == 1 or rtrans_prev == 0, else rtrans / rtrans_prev
//     p = r + beta p
//     pap = p . A p;  breakdown = pap <= rtrans * 1e-30;  alpha = 0 on it
//     r -= alpha A p;  x += alpha p;  rtrans_prev, rtrans = rtrans, r.r
//     done = breakdown
//
// Design. The TPU kernel keeps r and p in VMEM for the whole solve. Here
// one cooperative launch (cudaLaunchCooperativeKernel) of a persistent
// kernel walks all iterations; its grid is the number of blocks that fit
// on the card at once at the plan's shared memory (ops/stencil_cg_vmem.py
// cg_plan; a larger grid would deadlock grid.sync()). The vectors stay in
// device memory, and the 50 MB L2 holds them where they fit (100^3 f32).
// An iteration is two phases and two grid barriers, the least standard CG
// needs for its two global dots:
//
//   phase A: block b takes tiles b, b + G, b + 2G, ... of the plan; every
//     staged point, halo included, is p' = r + beta p_old, formed as K3
//     does, so a neighbour's p' is recomputed and never read back; at its
//     own points a thread writes p' into the other p buffer and w = A p',
//     and adds p'.w to its partial. Two forms (the plan's ``ring``):
//     - the ring, where a tile spans all nx columns and R rows over tz
//       planes, so a plane of it, with its halo rows, is one contiguous
//       range of (R + 2) nx values of r and of p_old. Warp 7 is the
//       producer: its lane 0 bulk-copies (cp.async.bulk, ring.cuh) the two
//       ranges of each plane of the block's tiles, in order, into a ring of
//       kRingStages slabs in shared memory, each completed on the slab's
//       full mbarrier, and runs ahead over the block's whole tile list,
//       waiting on a slab's empty mbarrier before it copies into it again.
//       Warps 0-6, the consumers, wait on a slab, form p' and the 3-point
//       sums from it, release it (one arrival a warp) and carry the z sums
//       in registers as the march does: consumer c owns columns c, c + 224,
//       ... of the tile, up to kRingPoints / R of them, each with its R
//       rows (at nx = 200 one column each, and 24 consumers idle).
//       The x and y edges and the rows outside the domain are masked by
//       coordinate, an explicit C(0) where the plain version pads, never
//       what the slab holds there; a plane outside the domain is not
//       copied and its sums are C(0). cg_plan takes it where nx *
//       sizeof(C) is a multiple of 16 (a bulk copy's unit), a plane-tile
//       fits the consumers (which keeps the slabs within 172064 bytes, R
//       1 at nx = 1792 in f64) and an iteration's vectors exceed the L2;
//       it removes what left the march latency-bound at 200^3:
//       two planes of 4-byte loads in flight a thread, a cold start at
//       every tile and the x halo read again by the neighbouring tile;
//     - the march, on the tiled plane march of
//       csrc/stencil_apply.cuh (K2's and K3's), every other shape;
//   grid.sync(); every block sums the partials in one fixed order, so all
//     hold the same pap, breakdown flag and alpha;
//   phase B, a streaming pass: r -= alpha w, x += alpha p', r.r into the
//     partials, 16 bytes a load where every vector is 16-byte aligned;
//   grid.sync(); every block sums the partials, then beta. Block 0 writes
//     hist.
//
// Two choices were measured as builds one edit away (150 iterations in
// f32 on an H100 80GB HBM3 at 700 W, profile_cg --vmem-variants) and the
// slower deleted: forming A p' again in phase B by a second march, where
// w is kept, ran 1.41x (100^3) and 1.71x (200^3) slower; deferring
// x += alpha p' into the next phase A, with a closing pass after the exit,
// 1.07x and 1.31x slower.
//
// Each elementwise operation is the plain version's, rounded on its own
// (r + beta p, r - alpha w, x + alpha p, and each 3-point sum ((left +
// centre) + right), Sz(Sy(Sx)) for the 27-point form), so at equal alpha
// and beta p', w, r and x are its bits in either form; only the dots'
// summation order differs. A partial is one a block: a thread adds its
// own terms in order (phase A: tile by tile, plane by plane, then the
// ring's columns and their rows, or the march's rows; phase B: chunk by
// chunk), the block its threads by a fixed tree (block_sum; the ring's
// producer adds nothing), and every block the partials by grid_total. No
// float atomics, so a run repeats bit for bit.
//
// Memory ordering. Which thread touches what, and when:
//   - phase A reads r and p_old at its tiles and their halos, points that
//     other blocks own; it writes p' (and w) only at its own points, into
//     the p buffer that no block reads in phase A. The buffers swap by the
//     parity of k (p_old = p[(k + 1) & 1], p' = p[k & 1]), the same in
//     every block, so the buffer phase A of iteration k reads was last
//     written in phase A of iteration k - 1.
//   - phase B reads and writes only points that the same thread owns in
//     phase B (r, w, x and p' at its chunks); w and p' come from other
//     blocks' phase A, across the barrier between the phases.
//   - r written in phase B is read by other blocks in the next phase A,
//     across the barrier that ends phase B. Each block's partials are
//     written before a barrier and read by every block after it, and
//     written again only after the next barrier.
// So every value that one block writes and another reads is read only
// after a grid.sync(), which orders memory at device scope. The L1 is not
// coherent across SMs, so no load of a value the launch writes may take
// the non-coherent path (ld.global.nc): every load of r, p, w, x and the
// partials is __ldcg (cached in L2 only) or a bulk copy, and no pointer is
// declared const __restrict__ (which would let nvcc emit ld.global.nc, as
// it may in K3, whose inputs are read-only for its launch). The SASS of
// this library holds no LDG.E.CONSTANT (cuobjdump -sass; chip_smoke.py
// phase 3b checks it on every run).
//   The ring's bulk copies read r and p_old through the async proxy, from
// L2 and never through L1. The producer issues them only between the
// barrier that ends phase B and the one that ends phase A (it never
// copies across a grid barrier, since phase B writes r), after a proxy
// fence (fence.proxy.async.global) that orders what the grid barrier made
// visible to it before its copies; every copy has landed (its full
// mbarrier completed) before the consumers of the slab finish phase A, so
// none is in flight when phase B writes r. In shared memory a slab is
// read by the consumers and written again by a copy only after all seven
// consumer warps have arrived on its empty mbarrier; the producer and the
// consumers count the block's planes alike, so both keep the ring's
// phases without a block barrier.
//
// What bounds it: per iteration phase A moves r and p_old in and p' and w
// out, phase B r, w, x and p' in and r and x out: ten vector passes, from
// the L2 where the vectors fit it (100^3 f32: five 4 MB vectors) and from
// device memory beyond (200^3); and two grid barriers. On an H100 80GB
// HBM3 at 700 W (profile_cg --vmem-variants, 150-iteration f32 solves):
// at 200^3 the march took 21.0-21.2 ms (140.8 us an iteration: phase A
// 65.8, phase B 65.8, the barriers and their sums 9.2, by the builds of
// one phase alone), the ring 18.1 ms (121.4 us an iteration: phase A
// 50.2, phase B 62.3, the barriers and their sums 8.9; R 4 over 40
// planes, 250 tiles on 264 blocks, two an SM at the f32 kernel's 128
// registers), 17.7 ms of it without its sums, so the copies and stores
// bound it. Measured and set aside (forced plans and builds one edit
// away): three blocks an SM 17.98 against 18.08 ms, within the runs'
// spread, four 20.7 (spills); and, while the tile rows and slabs were
// runtime values, at three blocks an SM, R 4 18.5-18.7 ms, R 8 over 14
// planes (whose tiles read 2 of every 16 planes twice) 19.1-19.4, R 2
// 22.8-22.9, 3, 4 or 6 slabs 19.2-19.9. At 100^3, where the vectors fit
// the L2, the march 2.53-2.62 ms and the ring 2.71-3.00, so cg_plan keeps
// the march there. The compute type is the vector type
// (f32 on the main path, f64 in the tests). Entry points return the
// launch's error code and do not synchronise.

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "ring.cuh"
#include "stencil_apply.cuh"

namespace cgs = cooperative_groups;

namespace {

using sb::add_rn;
using sb::block_sum;
using sb::div_rn;
using sb::Grid3;
using sb::kThreads;
using sb::mul_rn;
using sb::sqrt_rn;
using sb::sub_rn;

// The ring form of phase A (ops/stencil_cg_vmem.py keeps the same numbers:
// RING_CONSUMERS, RING_POINTS, RING_STAGES)
constexpr int kRingWarp = sb::kMarchWarps - 1;      // the producer warp
constexpr int kRingConsumers = kRingWarp * 32;      // 224 consumer threads
constexpr int kRingPoints = 8;                      // a consumer's points of a plane-tile
constexpr int kRingStages = 2;                      // slabs

// V consecutive values through L2, as one 16-byte load where V > 1
template <int V, typename C>
__device__ __forceinline__ void load_v(const C* p, C (&a)[V]) {
  if constexpr (V == 1) {
    a[0] = __ldcg(p);
  } else if constexpr (std::is_same<C, float>::value) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
  } else {
    const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
    a[0] = v.x;
    a[1] = v.y;
  }
}

template <int V, typename C>
__device__ __forceinline__ void store_v(C* p, const C (&a)[V]) {
  if constexpr (V == 1) {
    *p = a[0];
  } else if constexpr (std::is_same<C, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// The streaming pass: f(integral_constant<int, V>, i0) for each of this
// thread's chunks of V = 16 / sizeof(C) values (chunk c = gid, gid + S, ...
// for S the grid's threads), then for its point of the tail past the last
// whole chunk; with vec false, one value at a time (V = 1) over all n.
template <typename C, typename F>
__device__ __forceinline__ void stream(long long n, bool vec, F&& f) {
  constexpr int V = 16 / sizeof(C);
  const long long gid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long head = 0;
  if (vec) {
    const long long chunks = n / V;
    for (long long c = gid; c < chunks; c += stride) f(std::integral_constant<int, V>{}, c * V);
    head = chunks * V;
  }
  for (long long i = head + gid; i < n; i += stride) f(std::integral_constant<int, 1>{}, i);
}

// sum of parts[0..G) in one fixed order: the same bits in every block
template <typename C>
__device__ __forceinline__ C grid_total(const C* parts, int G, C* red) {
  C acc = C(0);
  for (int j = threadIdx.x; j < G; j += kThreads) acc = add_rn(acc, __ldcg(parts + j));
  return block_sum(acc, red);
}

// phase A's staged value: p' = r + beta p_old, both read through L2
template <typename C>
struct StageNext {
  struct Raw {
    C r, p;
  };
  const C* r;
  const C* p;
  C beta;
  __device__ __forceinline__ Raw load(long long j) const {
    return Raw{__ldcg(r + j), __ldcg(p + j)};
  }
  __device__ __forceinline__ C make(Raw a) const { return add_rn(a.r, mul_rn(beta, a.p)); }
};

// phase A at a thread's own point: p' into the other buffer, w = A p',
// p'.w into its partial
template <typename C>
struct OutA {
  C* pn;
  C* w;
  C pap;
  __device__ __forceinline__ void operator()(long long i, C wi, C c) {
    pn[i] = c;
    w[i] = wi;
    pap = add_rn(pap, mul_rn(wi, c));
  }
};

// The ring's geometry: tiles of all nx columns and R rows over tz planes,
// y tiles fastest; kRingStages slabs, each (R + 2) nx values of r then as
// many of p_old; ``full`` and ``empty`` an mbarrier a slab.
template <typename C>
struct Ring {
  int tiles_y;
  long long slab;  // values of one vector in a slab: (R + 2) nx
  C* data;
  unsigned long long* full;
  unsigned long long* empty;
};

// The producer (lane 0 of warp kRingWarp): every plane inside the domain of
// the block's tiles, in order, into slab j mod S (S = kRingStages), j
// counting the block's planes over the whole solve; slab use u = j / S
// waits for the consumers' release of use u - 1.
template <typename C, int R>
__device__ __forceinline__ void ring_produce(const C* r, const C* p_old, const Grid3& g, int tz,
                                             int tiles, const Ring<C>& ring, int& j) {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int y0 = (t % ring.tiles_y) * R;
    const int z0 = (t / ring.tiles_y) * tz;
    const int z1 = min(z0 + tz, g.nz);
    const int lo = max(y0 - 1, 0);                   // the slab's rows in the domain
    const int hi = min(y0 + R + 1, g.ny);
    const unsigned bytes = static_cast<unsigned>(static_cast<long long>(hi - lo) * g.nx * sizeof(C));
    const long long dst = static_cast<long long>(lo - (y0 - 1)) * g.nx;
    for (int k = max(z0 - 1, 0); k <= min(z1, g.nz - 1); ++k, ++j) {
      const int s = j % kRingStages;
      if (j >= kRingStages) sb::mbar_wait(ring.empty + s, (j / kRingStages - 1) & 1);
      C* slab = ring.data + 2 * ring.slab * s + dst;
      const long long src = (static_cast<long long>(k) * g.ny + lo) * g.nx;
      sb::mbar_arrive_expect(ring.full + s, 2 * bytes);
      sb::bulk_load(slab, r + src, bytes, ring.full + s);
      sb::bulk_load(slab + ring.slab, p_old + src, bytes, ring.full + s);
    }
  }
}

// A consumer thread (c < kRingConsumers): its K = kRingPoints / R columns of
// each plane-tile, column m being c + 224 m, for each of the block's tiles;
// the march's z pipeline in registers, per column and row. out(i, y, p') at
// each own point of plane k - 1 once plane k is summed.
template <typename C, int R, bool kSeven>
__device__ __forceinline__ void ring_consume(C beta, const Grid3& g, int tz, int tiles,
                                             const Ring<C>& ring, int& j, OutA<C>& out) {
  constexpr int K = kRingPoints / R;
  const int lane = threadIdx.x & 31;
  int ix[K];  // the columns; ix < 0: none
#pragma unroll
  for (int m = 0; m < K; ++m) {
    const int i = static_cast<int>(threadIdx.x) + kRingConsumers * m;
    ix[m] = i < g.nx ? i : -1;
  }
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int y0 = (t % ring.tiles_y) * R;
    const int z0 = (t / ring.tiles_y) * tz;
    const int z1 = min(z0 + tz, g.nz);
    C back2[K][R], back1[K][R], cen1[K][R];
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int q = 0; q < R; ++q) back2[m][q] = back1[m][q] = cen1[m][q] = C(0);
    }
    for (int k = z0 - 1; k <= z1; ++k) {
      C sum[K][R], cen[K][R];
#pragma unroll
      for (int m = 0; m < K; ++m) {
#pragma unroll
        for (int q = 0; q < R; ++q) sum[m][q] = cen[m][q] = C(0);
      }
      if (k >= 0 && k < g.nz) {
        const int s = j % kRingStages;
        sb::mbar_wait(ring.full + s, (j / kRingStages) & 1);
        const C* rs = ring.data + 2 * ring.slab * s;
        const C* ps = rs + ring.slab;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const int x = ix[m];
          if (x < 0) continue;
          const bool has_l = x > 0, has_r = x + 1 < g.nx;
          // p' at slab row a (tile row a - 1), column x + dx: 0 outside
          auto at = [&](int a, int dx) -> C {
            const int y = y0 - 1 + a;
            const bool in = y >= 0 && y < g.ny && (dx == 0 || (dx < 0 ? has_l : has_r));
            const int e = a * g.nx + x + dx;
            return in ? add_rn(rs[e], mul_rn(beta, ps[e])) : C(0);
          };
          if constexpr (!kSeven) {
            C sx[R + 2];
#pragma unroll
            for (int a = 0; a < R + 2; ++a) {
              const C v = at(a, 0);
              sx[a] = add_rn(add_rn(at(a, -1), v), at(a, 1));
              if (a >= 1 && a <= R) cen[m][a - 1] = v;
            }
#pragma unroll
            for (int q = 0; q < R; ++q) sum[m][q] = add_rn(add_rn(sx[q], sx[q + 1]), sx[q + 2]);
          } else {
#pragma unroll
            for (int q = 0; q < R; ++q) {
              const C v = at(q + 1, 0);
              cen[m][q] = v;
              const C sx = add_rn(add_rn(at(q + 1, -1), v), at(q + 1, 1));
              const C sy = add_rn(add_rn(at(q, 0), v), at(q + 2, 0));
              sum[m][q] = add_rn(sx, sy);
            }
          }
        }
        // one release a warp, once its lanes have read the slab
        __syncwarp();
        if (lane == 0) sb::mbar_arrive(ring.empty + s);
        ++j;
      }
      if (k > z0) {  // plane k - 1 has all its z-neighbours
        const long long plane0 = static_cast<long long>(k - 1) * g.ny;
#pragma unroll
        for (int m = 0; m < K; ++m) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int y = y0 + q;
            if (ix[m] < 0 || y >= g.ny) continue;
            C v;
            if constexpr (!kSeven) {
              v = sub_rn(mul_rn(C(28), cen1[m][q]),
                         add_rn(add_rn(back2[m][q], back1[m][q]), sum[m][q]));
            } else {
              const C sz = add_rn(add_rn(back2[m][q], cen1[m][q]), cen[m][q]);
              v = sub_rn(mul_rn(C(30), cen1[m][q]), add_rn(back1[m][q], sz));
            }
            out((plane0 + y) * g.nx + ix[m], v, cen1[m][q]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          back2[m][q] = kSeven ? cen1[m][q] : back1[m][q];
          back1[m][q] = sum[m][q];
          cen1[m][q] = cen[m][q];
        }
      }
    }
  }
}

template <typename C, int R, bool kSeven, bool kRing>
__global__ void __launch_bounds__(kThreads)
stencil_cg_vmem_kernel(C* r, C* p0, C* p1, C* w, C* x, C* hist, C* parts,
                       const C* eps_ptr, Grid3 g, int tz, int tiles_x,
                       int tiles_y, int tiles, int itermax) {
  cgs::grid_group grid = cgs::this_grid();
  // the march: its two staged planes; the ring: 2 S mbarriers, then S slabs
  // (S = kRingStages)
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  C* smem = reinterpret_cast<C*>(dyn_smem);
  __shared__ C red[kThreads];
  const int G = gridDim.x;
  C* rr_parts = parts;
  C* pap_parts = parts + G;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const C eps = __ldcg(eps_ptr);
  const bool vec = aligned16(r) && aligned16(w) && aligned16(x) && aligned16(p0) &&
                   aligned16(p1);
  const int first_tile = static_cast<int>(blockIdx.x);
  Ring<C> ring{};
  int ring_j = 0;  // the block's planes through the ring so far
  if constexpr (kRing) {
    ring.tiles_y = tiles_y;
    ring.slab = (R + 2LL) * g.nx;
    ring.full = reinterpret_cast<unsigned long long*>(dyn_smem);
    ring.empty = ring.full + kRingStages;
    ring.data = reinterpret_cast<C*>(dyn_smem + 16 * kRingStages);
    if (threadIdx.x == 0) {
      for (int s = 0; s < kRingStages; ++s) {
        sb::mbar_init(ring.full + s, 1);
        sb::mbar_init(ring.empty + s, kRingWarp);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  C acc = C(0);
  stream<C>(g.n, vec, [&](auto v, long long i0) {
    constexpr int V = decltype(v)::value;
    C rv[V];
    load_v<V>(r + i0, rv);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = add_rn(acc, mul_rn(rv[j], rv[j]));
  });
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) rr_parts[blockIdx.x] = acc;
  grid.sync();
  C rtrans = grid_total(rr_parts, G, red);
  C rtrans_prev = rtrans;
  bool done = false;
  if (lead) hist[0] = sqrt_rn(rtrans);

  int k = 1;
  for (; k < itermax; ++k) {
    if (done || !(sqrt_rn(rtrans_prev) > eps)) break;  // the same in every block
    if (lead) hist[k] = sqrt_rn(rtrans);
    const C beta = (k == 1 || rtrans_prev == C(0)) ? C(0) : div_rn(rtrans, rtrans_prev);
    C* const p_old = (k & 1) ? p0 : p1;  // p0 holds zeros at k == 1
    C* const p_new = (k & 1) ? p1 : p0;

    // phase A: p' = r + beta p_old, w = A p', p'.w
    OutA<C> out_a{p_new, w, C(0)};
    if constexpr (kRing) {
      if (threadIdx.x >= kRingConsumers) {
        if (threadIdx.x == kRingConsumers) ring_produce<C, R>(r, p_old, g, tz, tiles, ring, ring_j);
        __syncwarp();
      } else {
        ring_consume<C, R, kSeven>(beta, g, tz, tiles, ring, ring_j, out_a);
      }
    } else {
      const StageNext<C> stage_a{r, p_old, beta};
      for (int t = first_tile; t < tiles; t += G) {
        sb::march<C, R, kSeven>(stage_a, g, tz, tiles_x, tiles_y, t, smem, out_a);
        __syncthreads();  // the next tile's planes reuse the buffers
      }
    }
    acc = block_sum(out_a.pap, red);
    if (threadIdx.x == 0) pap_parts[blockIdx.x] = acc;
    grid.sync();
    const C pap = grid_total(pap_parts, G, red);
    const bool breakdown = pap <= mul_rn(rtrans, C(1e-30));
    const C alpha = breakdown ? C(0) : div_rn(rtrans, pap == C(0) ? C(1) : pap);

    // phase B: r -= alpha w, x += alpha p', r.r
    acc = C(0);
    stream<C>(g.n, vec, [&](auto v, long long i0) {
      constexpr int V = decltype(v)::value;
      C rv[V], wv[V], xv[V], pv[V];
      load_v<V>(r + i0, rv);
      load_v<V>(w + i0, wv);
      load_v<V>(x + i0, xv);
      load_v<V>(p_new + i0, pv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        rv[j] = sub_rn(rv[j], mul_rn(alpha, wv[j]));
        acc = add_rn(acc, mul_rn(rv[j], rv[j]));
        xv[j] = add_rn(xv[j], mul_rn(alpha, pv[j]));
      }
      store_v<V>(r + i0, rv);
      store_v<V>(x + i0, xv);
    });
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) rr_parts[blockIdx.x] = acc;
    grid.sync();
    rtrans_prev = rtrans;
    rtrans = grid_total(rr_parts, G, red);
    done = breakdown;
  }
  if (lead) {
    for (int j = k; j < itermax; ++j) hist[j] = sb::quiet_nan<C>();
  }
}

// the dynamic shared bytes a launch gets unless its kernel is raised to more
constexpr long long kDefaultSmem = 48 * 1024;

// The blocks of kernel that fit on the current device at once with smem
// bytes of dynamic shared memory (the kernel raised to that limit first
// where it is above kDefaultSmem, as the ring's slabs may be at wide rows)
int resident(const void* kernel, long long smem, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess && smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(smem));
  }
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks <= 0) e = cudaErrorInvalidConfiguration;
  return static_cast<int>(e);
}

template <typename C>
const void* kernel_for(int rows, bool use_7pt, bool ring) {
  const void* kernel = nullptr;
  sb::dispatch(rows, use_7pt, [&](auto kr, auto k7) {
    constexpr int R = decltype(kr)::value;
    constexpr bool kSeven = decltype(k7)::value;
    kernel = ring ? reinterpret_cast<const void*>(stencil_cg_vmem_kernel<C, R, kSeven, true>)
                  : reinterpret_cast<const void*>(stencil_cg_vmem_kernel<C, R, kSeven, false>);
  });
  return kernel;
}

template <typename C>
int blocks_at(int rows, int use_7pt, int ring, long long smem, int* blocks) {
  *blocks = 0;
  const void* kernel = kernel_for<C>(rows, use_7pt != 0, ring != 0);
  if (kernel == nullptr || smem < 0 || smem > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return resident(kernel, smem, blocks);
}

// The ring's shape on the grid, as ops/stencil_cg_vmem.py ring_rows and
// cg_plan give it: R one of 1, 2, 4, 8; a plane-tile of at most
// kRingConsumers * kRingPoints points, so K = kRingPoints / R columns a
// consumer hold it; rows of 16-byte multiples; smem the mbarriers and the
// kRingStages slabs; tz >= 1. Fills the tile counts.
template <typename C>
bool ring_shape_ok(const Grid3& g, int r, int tz, long long smem, int* tiles_y,
                   long long* tiles) {
  if (r != 1 && r != 2 && r != 4 && r != 8) return false;
  if (tz < 1) return false;
  if (static_cast<long long>(g.nx) * r > kRingConsumers * kRingPoints) return false;
  if (g.nx * sizeof(C) % 16 != 0) return false;
  const long long slab = (r + 2LL) * g.nx * static_cast<long long>(sizeof(C));
  if (smem != 16LL * kRingStages + 2 * slab * kRingStages) return false;
  const long long ty = (g.ny + r - 1) / r;
  const long long runs = (g.nz + tz - 1) / tz;
  if (ty * runs > 0x7fffffffLL) return false;
  *tiles_y = static_cast<int>(ty);
  *tiles = ty * runs;
  return true;
}

template <typename C>
int launch(void* r, void* p0, void* p1, void* w, void* x, void* hist,
           void* parts, const void* eps, int nx, int ny, int nz, int use_7pt,
           int itermax, int rows, int tz, long long blocks, long long smem,
           int ring, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || itermax <= 0 || (ring != 0 && ring != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid3 g = sb::make_grid(nx, ny, nz);
  int tiles_x = 1, tiles_y = 0;
  long long tiles = 0;
  if (ring) {
    if (!ring_shape_ok<C>(g, rows, tz, smem, &tiles_y, &tiles) ||
        !(aligned16(r) && aligned16(p0) && aligned16(p1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (!sb::march_shape_ok<C>(g, rows, tz, smem, &tiles_x, &tiles_y, &tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = kernel_for<C>(rows, use_7pt != 0, ring != 0);
  int want = 0;
  const int e = resident(kernel, smem, &want);
  if (e != 0) return e;
  if (blocks != want) return static_cast<int>(cudaErrorInvalidValue);
  C* rp = static_cast<C*>(r);
  C* p0p = static_cast<C*>(p0);
  C* p1p = static_cast<C*>(p1);
  C* wp = static_cast<C*>(w);
  C* xp = static_cast<C*>(x);
  C* hp = static_cast<C*>(hist);
  C* partsp = static_cast<C*>(parts);
  const C* epsp = static_cast<const C*>(eps);
  int n_tiles = static_cast<int>(tiles);
  void* args[] = {&rp, &p0p, &p1p, &wp, &xp, &hp, &partsp, &epsp, &g, &tz,
                  &tiles_x, &tiles_y, &n_tiles, &itermax};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan (rows, tz, blocks, smem, ring) is ops/stencil_cg_vmem.py
// cg_plan's: R rows a thread (the ring: the rows of a tile), tz planes a
// run, the persistent grid, the dynamic shared bytes and the form (1 the
// ring, 0 the march). The entry points recompute the tile counts, the
// shared bytes and the co-resident block count and refuse a plan that
// differs with cudaErrorInvalidValue before anything launches.

#define SB_CG_PLAN int rows, int tz, long long blocks, long long smem, int ring

// the co-resident block count of the march (ring 0) or the ring form at
// rows R, the stencil and smem bytes of dynamic shared memory on the
// current device: the plan's grid, and the length of each half of `parts`
int sb_stencil_cg_vmem_blocks_f32(int rows, int use_7pt, int ring, long long smem,
                                  int* blocks) {
  return blocks_at<float>(rows, use_7pt, ring, smem, blocks);
}
int sb_stencil_cg_vmem_blocks_f64(int rows, int use_7pt, int ring, long long smem,
                                  int* blocks) {
  return blocks_at<double>(rows, use_7pt, ring, smem, blocks);
}

// r (= r0 on entry, overwritten), p0 (zeros on entry), p1, w, x (= x0 on
// entry, the solution on exit): length nx*ny*nz; hist: itermax; parts:
// 2 * blocks; eps: one scalar on the device. All of one type; the ring
// takes r, p0 and p1 16-byte aligned.
int sb_stencil_cg_vmem_f32(void* r, void* p0, void* p1, void* w, void* x,
                           void* hist, void* parts, const void* eps, int nx,
                           int ny, int nz, int use_7pt, int itermax,
                           SB_CG_PLAN, void* stream) {
  return launch<float>(r, p0, p1, w, x, hist, parts, eps, nx, ny, nz, use_7pt,
                       itermax, rows, tz, blocks, smem, ring, stream);
}
int sb_stencil_cg_vmem_f64(void* r, void* p0, void* p1, void* w, void* x,
                           void* hist, void* parts, const void* eps, int nx,
                           int ny, int nz, int use_7pt, int itermax,
                           SB_CG_PLAN, void* stream) {
  return launch<double>(r, p0, p1, w, x, hist, parts, eps, nx, ny, nz, use_7pt,
                        itermax, rows, tz, blocks, smem, ring, stream);
}

#undef SB_CG_PLAN

}  // extern "C"
