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
// on the card at once at the march's shared memory (ops/stencil_cg_vmem.py
// cg_plan; a larger grid would deadlock grid.sync()). The vectors stay in
// device memory, and the 50 MB L2 holds them where they fit (100^3 f32).
// An iteration is two phases and two grid barriers, the least standard CG
// needs for its two global dots:
//
//   phase A, on the tiled plane march (csrc/stencil_apply.cuh): block b
//     marches tiles b, b + G, b + 2G, ... of the plan; every staged point,
//     halo included, is p' = r + beta p_old, formed while staging as K3
//     does, so a neighbour's p' is recomputed and never read back; at its
//     own points a thread writes p' into the other p buffer and w = A p',
//     and adds p'.w to its partial;
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
// (r + beta p, r - alpha w, x + alpha p), so at equal alpha and beta p',
// w, r and x are its bits; only the dots' summation order differs. A
// partial is one a block: a thread adds its own terms in order (phase A:
// tile by tile, plane by plane, row by row; phase B: chunk by chunk), the
// block its threads by a fixed tree (block_sum), and every block the
// partials by grid_total. No float atomics, so a run repeats bit for bit.
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
// partials is __ldcg (cached in L2 only), and no pointer is declared
// const __restrict__ (which would let nvcc emit ld.global.nc, as it may in
// K3, whose inputs are read-only for its launch). The SASS of this library
// holds no LDG.E.CONSTANT (cuobjdump -sass; chip_smoke.py phase 3b checks
// it on every run).
//
// What bounds it: per iteration phase A moves r and p_old in and p' and w
// out, phase B r, w, x and p' in and r and x out: ten vector passes, from
// the L2 where the vectors fit it (100^3 f32: five 4 MB vectors) and from
// device memory beyond (200^3); and two grid barriers. On an H100 80GB
// HBM3 at 700 W a 150-iteration f32 solve took 2.57 ms at 100^3 (17 us an
// iteration) and 21.5 ms at 200^3 (0.144 ms: about 2.2 TB/s on its ten
// passes; chip_smoke.py phase 5b). The compute type is the vector type
// (f32 on the main path, f64 in the tests). Entry points return the
// launch's error code and do not synchronise.

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

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

__device__ __forceinline__ float quiet_nan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double quiet_nan(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

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

__device__ __forceinline__ bool aligned16(const void* p) {
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

template <typename C, int R, bool kSeven>
__global__ void __launch_bounds__(kThreads)
stencil_cg_vmem_kernel(C* r, C* p0, C* p1, C* w, C* x, C* hist, C* parts,
                       const C* eps_ptr, Grid3 g, int tz, int tiles_x,
                       int tiles_y, int tiles, int itermax) {
  cgs::grid_group grid = cgs::this_grid();
  extern __shared__ __align__(16) unsigned char march_smem[];  // two planes
  C* smem = reinterpret_cast<C*>(march_smem);
  __shared__ C red[kThreads];
  const int G = gridDim.x;
  C* rr_parts = parts;
  C* pap_parts = parts + G;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const C eps = __ldcg(eps_ptr);
  const bool vec = aligned16(r) && aligned16(w) && aligned16(x) && aligned16(p0) &&
                   aligned16(p1);
  const int first_tile = static_cast<int>(blockIdx.x);

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
    const StageNext<C> stage_a{r, p_old, beta};
    for (int t = first_tile; t < tiles; t += G) {
      sb::march<C, R, kSeven>(stage_a, g, tz, tiles_x, tiles_y, t, smem, out_a);
      __syncthreads();  // the next tile's planes reuse the buffers
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
    for (int j = k; j < itermax; ++j) hist[j] = quiet_nan(C(0));
  }
}

// The blocks of kernel that fit on the current device at once with smem
// bytes of dynamic shared memory
int resident(const void* kernel, long long smem, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(smem));
  }
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks <= 0) e = cudaErrorInvalidConfiguration;
  return static_cast<int>(e);
}

template <typename C>
const void* kernel_for(int rows, bool use_7pt) {
  const void* kernel = nullptr;
  sb::dispatch(rows, use_7pt, [&](auto kr, auto k7) {
    kernel = reinterpret_cast<const void*>(
        stencil_cg_vmem_kernel<C, decltype(kr)::value, decltype(k7)::value>);
  });
  return kernel;
}

template <typename C>
int blocks_at(int rows, int use_7pt, long long smem, int* blocks) {
  *blocks = 0;
  const void* kernel = kernel_for<C>(rows, use_7pt != 0);
  if (kernel == nullptr || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  return resident(kernel, smem, blocks);
}

template <typename C>
int launch(void* r, void* p0, void* p1, void* w, void* x, void* hist,
           void* parts, const void* eps, int nx, int ny, int nz, int use_7pt,
           int itermax, int rows, int tz, long long blocks, long long smem,
           void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || itermax <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Grid3 g = sb::make_grid(nx, ny, nz);
  int tiles_x = 0, tiles_y = 0;
  long long tiles = 0;
  if (!sb::march_shape_ok<C>(g, rows, tz, smem, &tiles_x, &tiles_y, &tiles)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = kernel_for<C>(rows, use_7pt != 0);
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
  void* args[] = {&rp, &p0p, &p1p, &wp, &xp, &hp, &partsp, &epsp, &g,
                  &tz, &tiles_x, &tiles_y, &n_tiles, &itermax};
  const cudaError_t le = cudaLaunchCooperativeKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) return static_cast<int>(le);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan (rows, tz, blocks, smem) is ops/stencil_cg_vmem.py cg_plan's: R
// rows a thread, tz planes a run, the persistent grid and the shared bytes
// of the two staged planes. The entry points recompute the tile counts,
// the shared bytes and the co-resident block count and refuse a plan that
// differs with cudaErrorInvalidValue before anything launches.

#define SB_CG_PLAN int rows, int tz, long long blocks, long long smem

// the co-resident block count at rows R, the stencil and smem bytes of
// dynamic shared memory on the current device: the plan's grid, and the
// length of each half of `parts`
int sb_stencil_cg_vmem_blocks_f32(int rows, int use_7pt, long long smem, int* blocks) {
  return blocks_at<float>(rows, use_7pt, smem, blocks);
}
int sb_stencil_cg_vmem_blocks_f64(int rows, int use_7pt, long long smem, int* blocks) {
  return blocks_at<double>(rows, use_7pt, smem, blocks);
}

// r (= r0 on entry, overwritten), p0 (zeros on entry), p1, w, x (= x0 on
// entry, the solution on exit): length nx*ny*nz; hist: itermax; parts:
// 2 * blocks; eps: one scalar on the device. All of one type.
int sb_stencil_cg_vmem_f32(void* r, void* p0, void* p1, void* w, void* x,
                           void* hist, void* parts, const void* eps, int nx,
                           int ny, int nz, int use_7pt, int itermax,
                           SB_CG_PLAN, void* stream) {
  return launch<float>(r, p0, p1, w, x, hist, parts, eps, nx, ny, nz, use_7pt,
                       itermax, rows, tz, blocks, smem, stream);
}
int sb_stencil_cg_vmem_f64(void* r, void* p0, void* p1, void* w, void* x,
                           void* hist, void* parts, const void* eps, int nx,
                           int ny, int nz, int use_7pt, int itermax,
                           SB_CG_PLAN, void* stream) {
  return launch<double>(r, p0, p1, w, x, hist, parts, eps, nx, ny, nz, use_7pt,
                        itermax, rows, tz, blocks, smem, stream);
}

#undef SB_CG_PLAN

}  // extern "C"
