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
// Design. The TPU kernel keeps r and p in VMEM for the whole solve and
// streams only x. Here one cooperative launch of a persistent kernel
// (cudaLaunchCooperativeKernel; the grid is exactly the number of blocks
// that fit on the card at once, or grid.sync() deadlocks) walks all
// iterations. r and p stay in device memory, and the 50 MB L2 holds them
// when they fit: 8 MB at 100^3 in f32; at 200^3 (64 MB) they stream from
// device memory (the wrapper, ops/stencil_cg_vmem.py, takes every grid whose
// vectors fit the card and notes which of the two). Each iteration is three
// phases separated by grid.sync(): the p-update; p.Ap with the apply
// recomputed from p; then r -= alpha Ap (the apply recomputed again: the
// operator reads no matrix, so a second apply costs flops, not a pass over
// an Ap vector), x += alpha p and r.r. Each block writes its partial of a
// dot; after the barrier every block sums all partials in the same fixed
// order, so every block holds the same scalar without another barrier, and
// all blocks take the same branches. Block 0 writes hist.
//
// p is written by one block and read by its neighbours in another, so its
// reads bypass L1 (__ldcg): L1 is not coherent across SMs. r and x are read
// and written only by the thread that owns the index.
//
// What bounds it: per iteration x is read and written once from device
// memory when r and p live in L2 (2 * 4 MB at 100^3, f32), plus three
// grid-wide barriers and about 60 flops a point. The compute type is the
// vector type (f32 on the main path, f64 in the tests); each product and
// sum is rounded on its own, as in the plain version. Entry points return
// the launch's error code and do not synchronise.

#include <cooperative_groups.h>

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

template <typename C>
struct LoadCoherent {
  const C* v;
  __device__ __forceinline__ C operator()(long long j) const { return __ldcg(v + j); }
};

// sum of parts[0..G) in one fixed order: the same bits in every block
template <typename C>
__device__ __forceinline__ C grid_total(const C* parts, int G, C* red) {
  C acc = C(0);
  for (int j = threadIdx.x; j < G; j += kThreads) acc = add_rn(acc, __ldcg(parts + j));
  return block_sum(acc, red);
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
stencil_cg_vmem_kernel(C* r, C* p, C* x, C* hist, C* parts, const C* eps_ptr,
                       Grid3 g, bool use_7pt, int itermax) {
  cgs::grid_group grid = cgs::this_grid();
  __shared__ C red[kThreads];
  const int G = gridDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(G) * kThreads;
  C* rr_parts = parts;
  C* pap_parts = parts + G;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const C eps = *eps_ptr;
  const LoadCoherent<C> ldp{p};

  C acc = C(0);
  for (long long i = first; i < g.n; i += stride) acc = add_rn(acc, mul_rn(r[i], r[i]));
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) rr_parts[blockIdx.x] = acc;
  grid.sync();
  C rtrans = grid_total(rr_parts, G, red);
  C rtrans_prev = rtrans;
  bool done = false;
  if (lead) hist[0] = sqrt_rn(rtrans);

  for (int k = 1; k < itermax; ++k) {
    if (done || !(sqrt_rn(rtrans_prev) > eps)) {  // the same in every block
      if (lead) {
        for (int j = k; j < itermax; ++j) hist[j] = quiet_nan(C(0));
      }
      break;
    }
    if (lead) hist[k] = sqrt_rn(rtrans);
    const C beta = (k == 1 || rtrans_prev == C(0)) ? C(0) : div_rn(rtrans, rtrans_prev);

    // phase 1: p = r + beta p
    for (long long i = first; i < g.n; i += stride) {
      p[i] = add_rn(r[i], mul_rn(beta, ldp(i)));
    }
    grid.sync();

    // phase 2: pap = p . A p
    acc = C(0);
    for (long long i = first; i < g.n; i += stride) {
      C c;
      const C w = sb::apply_point<C>(ldp, i, g, use_7pt, &c);
      acc = add_rn(acc, mul_rn(w, c));
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) pap_parts[blockIdx.x] = acc;
    grid.sync();
    const C pap = grid_total(pap_parts, G, red);
    const bool breakdown = pap <= mul_rn(rtrans, C(1e-30));
    const C alpha = breakdown ? C(0) : div_rn(rtrans, pap == C(0) ? C(1) : pap);

    // phase 3: r -= alpha A p, x += alpha p, r.r
    acc = C(0);
    for (long long i = first; i < g.n; i += stride) {
      C c;
      const C w = sb::apply_point<C>(ldp, i, g, use_7pt, &c);
      const C rv = sub_rn(r[i], mul_rn(alpha, w));
      r[i] = rv;
      acc = add_rn(acc, mul_rn(rv, rv));
      x[i] = add_rn(x[i], mul_rn(alpha, c));
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) rr_parts[blockIdx.x] = acc;
    grid.sync();
    rtrans_prev = rtrans;
    rtrans = grid_total(rr_parts, G, red);
    done = breakdown;
  }
}

template <typename C>
int grid_blocks(int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stencil_cg_vmem_kernel<C>, kThreads, 0);
  }
  *blocks = per_sm * sms;
  if (e == cudaSuccess && *blocks <= 0) e = cudaErrorInvalidConfiguration;
  return static_cast<int>(e);
}

template <typename C>
int launch(void* r, void* p, void* x, void* hist, void* parts, const void* eps,
           int nx, int ny, int nz, int use_7pt, int itermax, int blocks,
           void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || itermax <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  C* rp = static_cast<C*>(r);
  C* pp = static_cast<C*>(p);
  C* xp = static_cast<C*>(x);
  C* hp = static_cast<C*>(hist);
  C* partsp = static_cast<C*>(parts);
  const C* epsp = static_cast<const C*>(eps);
  Grid3 g = sb::make_grid(nx, ny, nz);
  bool b7 = use_7pt != 0;
  void* args[] = {&rp, &pp, &xp, &hp, &partsp, &epsp, &g, &b7, &itermax};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stencil_cg_vmem_kernel<C>), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the co-resident block count of the kernel on the current device: the
// grid of every launch, and the length of each half of `parts`
int sb_stencil_cg_vmem_blocks_f32(int* blocks) { return grid_blocks<float>(blocks); }
int sb_stencil_cg_vmem_blocks_f64(int* blocks) { return grid_blocks<double>(blocks); }

// r (= r0 on entry, overwritten), p (zeros on entry), x (= x0 on entry, the
// solution on exit): length nx*ny*nz; hist: itermax; parts: 2 * blocks;
// eps: one scalar on the device. All of one type.
int sb_stencil_cg_vmem_f32(void* r, void* p, void* x, void* hist, void* parts,
                           const void* eps, int nx, int ny, int nz, int use_7pt,
                           int itermax, int blocks, void* stream) {
  return launch<float>(r, p, x, hist, parts, eps, nx, ny, nz, use_7pt, itermax,
                       blocks, stream);
}
int sb_stencil_cg_vmem_f64(void* r, void* p, void* x, void* hist, void* parts,
                           const void* eps, int nx, int ny, int nz, int use_7pt,
                           int itermax, int blocks, void* stream) {
  return launch<double>(r, p, x, hist, parts, eps, nx, ny, nz, use_7pt, itermax,
                        blocks, stream);
}

}  // extern "C"
