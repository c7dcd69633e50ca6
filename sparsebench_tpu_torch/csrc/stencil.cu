// Matrix-free stencil kernels for Hopper (sm_90a): K2 and K3 of the port.
//
// K2, stencil_apply_kernel: y = A x for the generated 27/7-point stencil
//   (csrc/stencil_apply.cuh), with an optional dots form that also writes,
//   per block, f32 partials of [x.x, (Ax).x].
//   Replaces sparsebench_tpu/ops/stencil_pallas.py stencil_apply_pallas and
//   stencil_apply_dots_pallas (_stencil_kernel :128, pallas_call :268).
// K3, stencil_axpy_apply_dots_kernel: p' = r + beta p, w = A p' and, per
//   block, a partial of delta = p'.w at the compute width.
//   Replaces stencil_axpy_apply_dots_pallas (_axpy_apply_kernel :347,
//   pallas_call :486), CG's "stage A" in one pass.
//
// What bounds them: memory. The operator stores nothing, so an apply must
// read x once and write y once (K3: read r and p, write p' and w) and does
// about 30 flops a point, 2 to 4 per byte moved in f32, far below the
// card's ~20 flops per byte. The TPU kernels pad the vectors to a
// (nz+2, nyp, nxp) space for 128-lane rolls and 8-row tiles and
// double-buffer z-slab windows through VMEM. None of that is carried over:
// here the vectors keep the natural row order with no padding, one thread
// computes one output point, and its 27 (7) neighbour reads come through
// L1/L2, masked at the domain edges. Neighbouring threads read neighbouring
// addresses, so a warp's loads coalesce; the 3 planes a block touches
// (3 * 40 KB at 100^3 in f32) stay in L1/L2 between neighbouring blocks.
// Staging the planes in shared memory is later work.
//
// K3 recomputes r + beta p at each neighbour instead of reading p' back, as
// the TPU kernel recomputes its halo planes: compute is free, a second pass
// over a vector is not.
//
// The dots are per-block partials in block order, summed by the wrapper
// with torch.sum (the JAX package sums its per-tile parts outside the
// kernel too): no float atomics, so a result repeats from run to run. K2's
// dots are f32 for every vector type, as the TPU kernel's (:199-201); K3's
// delta is at the compute width (f64 for f64 vectors, :415-419).
//
// bf16 vectors are computed in f32 and stored as bf16; the dots and delta
// use the f32 values before that rounding, as the TPU kernels do. The entry
// points launch on the stream they are given, do not synchronise, allocate
// nothing, and return cudaGetLastError().

#include "stencil_apply.cuh"

namespace {

using sb::add_rn;
using sb::block_sum;
using sb::Compute;
using sb::Grid3;
using sb::kThreads;
using sb::mul_rn;
using sb::narrow;
using sb::widen;

template <typename T>
struct LoadVec {
  const T* __restrict__ v;
  __device__ __forceinline__ typename Compute<T>::type operator()(long long j) const {
    return widen(v[j]);
  }
};

template <typename T>
struct LoadAxpy {
  using C = typename Compute<T>::type;
  const T* __restrict__ r;
  const T* __restrict__ p;
  C beta;
  __device__ __forceinline__ C operator()(long long j) const {
    return add_rn(widen(r[j]), mul_rn(beta, widen(p[j])));
  }
};

// K2; parts == nullptr for the plain apply, else (gridDim.x, 2) floats
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ parts, Grid3 g, bool use_7pt) {
  using C = typename Compute<T>::type;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  C yi = C(0), c = C(0);
  if (i < g.n) {
    yi = sb::apply_point<C>(LoadVec<T>{x}, i, g, use_7pt, &c);
    y[i] = narrow<T>(yi);
  }
  if (parts == nullptr) return;  // uniform over the block
  __shared__ float red[kThreads];
  const float cf = static_cast<float>(c);
  const float yf = static_cast<float>(yi);
  const float gamma = block_sum(mul_rn(cf, cf), red);
  const float delta = block_sum(mul_rn(yf, cf), red);
  if (threadIdx.x == 0) {
    parts[2 * blockIdx.x] = gamma;
    parts[2 * blockIdx.x + 1] = delta;
  }
}

// K3: parts is (gridDim.x,) at the compute width
template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_axpy_apply_dots_kernel(const T* __restrict__ r, const T* __restrict__ p,
                               const typename Compute<T>::type* __restrict__ beta,
                               T* __restrict__ pn, T* __restrict__ w,
                               typename Compute<T>::type* __restrict__ parts,
                               Grid3 g, bool use_7pt) {
  using C = typename Compute<T>::type;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  C wi = C(0), c = C(0);
  if (i < g.n) {
    wi = sb::apply_point<C>(LoadAxpy<T>{r, p, *beta}, i, g, use_7pt, &c);
    pn[i] = narrow<T>(c);
    w[i] = narrow<T>(wi);
  }
  __shared__ C red[kThreads];
  const C delta = block_sum(mul_rn(wi, c), red);
  if (threadIdx.x == 0) parts[blockIdx.x] = delta;
}

unsigned blocks_for(const Grid3& g) {
  return static_cast<unsigned>((g.n + kThreads - 1) / kThreads);
}

bool bad_dims(int nx, int ny, int nz) { return nx <= 0 || ny <= 0 || nz <= 0; }

template <typename T>
int apply(const void* x, void* y, void* parts, int nx, int ny, int nz,
          int use_7pt, void* stream) {
  if (bad_dims(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid3 g = sb::make_grid(nx, ny, nz);
  stencil_apply_kernel<T><<<blocks_for(g), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(parts),
      g, use_7pt != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int axpy_apply_dots(const void* r, const void* p, const void* beta, void* pn,
                    void* w, void* parts, int nx, int ny, int nz, int use_7pt,
                    void* stream) {
  using C = typename Compute<T>::type;
  if (bad_dims(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid3 g = sb::make_grid(nx, ny, nz);
  stencil_axpy_apply_dots_kernel<T><<<blocks_for(g), kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(p),
      static_cast<const C*>(beta), static_cast<T*>(pn), static_cast<T*>(w),
      static_cast<C*>(parts), g, use_7pt != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// parts: nullptr (apply only) or ceil(n/256) x 2 floats (the dots form)
int sb_stencil_apply_bf16(const void* x, void* y, void* parts, int nx, int ny,
                          int nz, int use_7pt, void* stream) {
  return apply<__nv_bfloat16>(x, y, parts, nx, ny, nz, use_7pt, stream);
}
int sb_stencil_apply_f32(const void* x, void* y, void* parts, int nx, int ny,
                         int nz, int use_7pt, void* stream) {
  return apply<float>(x, y, parts, nx, ny, nz, use_7pt, stream);
}
int sb_stencil_apply_f64(const void* x, void* y, void* parts, int nx, int ny,
                         int nz, int use_7pt, void* stream) {
  return apply<double>(x, y, parts, nx, ny, nz, use_7pt, stream);
}

// beta: one scalar on the device at the compute width (f32 for bf16/f32
// vectors, f64 for f64); parts: ceil(n/256) scalars at that width
int sb_stencil_axpy_apply_dots_bf16(const void* r, const void* p, const void* beta,
                                    void* pn, void* w, void* parts, int nx, int ny,
                                    int nz, int use_7pt, void* stream) {
  return axpy_apply_dots<__nv_bfloat16>(r, p, beta, pn, w, parts, nx, ny, nz,
                                        use_7pt, stream);
}
int sb_stencil_axpy_apply_dots_f32(const void* r, const void* p, const void* beta,
                                   void* pn, void* w, void* parts, int nx, int ny,
                                   int nz, int use_7pt, void* stream) {
  return axpy_apply_dots<float>(r, p, beta, pn, w, parts, nx, ny, nz, use_7pt,
                                stream);
}
int sb_stencil_axpy_apply_dots_f64(const void* r, const void* p, const void* beta,
                                   void* pn, void* w, void* parts, int nx, int ny,
                                   int nz, int use_7pt, void* stream) {
  return axpy_apply_dots<double>(r, p, beta, pn, w, parts, nx, ny, nz, use_7pt,
                                 stream);
}

}  // extern "C"
