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
// double-buffer z-slab windows through VMEM. Here the vectors keep the
// natural row order with no padding, and both kernels run the tiled plane
// march of csrc/stencil_apply.cuh: a block stages each plane of its tile,
// with a 1-point halo, once in shared memory, forms the separable sums
// there and carries the z-sums in registers, so device memory sees each
// operand value about once and the 27 (7) neighbour reads of a point come
// from shared memory. What is left above the bytes: the halo and the
// run's two extra planes, read again from L2 ((8R + 2) x 34 / (8R x 32)
// times (tz + 2) / tz the tile's values), a barrier a plane, the columns of
// the last x tile past nx (28 of 128 lanes idle at nx = 100). The plan
// (ops/stencil.py tile_plan: R, tz, the grid, the shared bytes) comes from
// the host, which sizes it from the card; the entry points check it
// against the grid and return cudaErrorInvalidValue when it does not fit.
//
// K3 forms r + beta p while staging, at every staged point, halo included:
// a neighbour's p' is recomputed, not read back, as the TPU kernel
// recomputes its halo planes: compute is free, a second pass over a vector
// is not. Shared memory holds p' only; r and p are each read once from
// device memory, p' and w each written once.
//
// The dots are per-block partials in block order, summed by the wrapper
// with torch.sum: a thread adds its own points' terms in order (R * tz of
// them at most, which the plan keeps to 32), then the block sums its threads
// by a fixed tree (the JAX package sums its per-tile parts outside the
// kernel too): no float atomics, so a result repeats from run to run. K2's
// dots are f32 for every vector type, as the TPU kernel's (:199-201); K3's
// delta is at the compute width (f64 for f64 vectors, :415-419).
//
// bf16 vectors are computed in f32 and stored as bf16; the dots and delta
// use the f32 values before that rounding, as the TPU kernels do. The entry
// points launch on the stream they are given, do not synchronise, allocate
// nothing, and return cudaGetLastError().

#include <type_traits>

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
struct StageVec {
  using C = typename Compute<T>::type;
  using Raw = T;
  const T* __restrict__ v;
  __device__ __forceinline__ Raw load(long long j) const { return v[j]; }
  __device__ __forceinline__ C make(Raw a) const { return widen(a); }
};

template <typename T>
struct StageAxpy {
  using C = typename Compute<T>::type;
  struct Raw {
    T r, p;
  };
  const T* __restrict__ r;
  const T* __restrict__ p;
  C beta;
  __device__ __forceinline__ Raw load(long long j) const { return Raw{r[j], p[j]}; }
  __device__ __forceinline__ C make(Raw a) const {
    return add_rn(widen(a.r), mul_rn(beta, widen(a.p)));
  }
};

// K2: y = A x; with kDots, its f32 dots [x.x, (Ax).x] a thread at a time
template <typename T, bool kDots>
struct OutApply {
  using C = typename Compute<T>::type;
  T* __restrict__ y;
  float gamma, delta;
  __device__ __forceinline__ void operator()(long long i, C yi, C c) {
    y[i] = narrow<T>(yi);
    if constexpr (kDots) {
      const float cf = static_cast<float>(c);
      gamma = add_rn(gamma, mul_rn(cf, cf));
      delta = add_rn(delta, mul_rn(static_cast<float>(yi), cf));
    }
  }
};

// K3: p' and w = A p'; delta = p'.w at the compute width
template <typename T>
struct OutAxpy {
  using C = typename Compute<T>::type;
  T* __restrict__ pn;
  T* __restrict__ w;
  C delta;
  __device__ __forceinline__ void operator()(long long i, C wi, C c) {
    pn[i] = narrow<T>(c);
    w[i] = narrow<T>(wi);
    delta = add_rn(delta, mul_rn(wi, c));
  }
};

// The blocks an SM that ptxas must fit K2 into: f32 at R <= 2 fits six
// blocks in 40 registers (a few bytes spilled) and ran faster at 200^3 than
// with the 62 it takes unbounded (profile_cg --stencil-variants); elsewhere
// ptxas chooses.
template <typename T, int R>
constexpr int kApplyMinBlocks = std::is_same<T, float>::value && R <= 2 ? 6 : 1;

// K2; kDots: parts is (gridDim.x, 2) floats, else unused
template <typename T, int R, bool kSeven, bool kDots>
__global__ void __launch_bounds__(kThreads, (kApplyMinBlocks<T, R>))
stencil_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ parts, Grid3 g, int tz, int tiles_x,
                     int tiles_y) {
  using C = typename Compute<T>::type;
  extern __shared__ __align__(16) unsigned char march_smem[];  // two planes
  OutApply<T, kDots> out{y, 0.0f, 0.0f};
  sb::march<C, R, kSeven>(StageVec<T>{x}, g, tz, tiles_x, tiles_y,
                          static_cast<int>(blockIdx.x),
                          reinterpret_cast<C*>(march_smem), out);
  if constexpr (!kDots) return;
  __shared__ float red[kThreads];
  const float gamma = block_sum(out.gamma, red);
  const float delta = block_sum(out.delta, red);
  if (threadIdx.x == 0) {
    parts[2 * blockIdx.x] = gamma;
    parts[2 * blockIdx.x + 1] = delta;
  }
}

// K3: parts is (gridDim.x,) at the compute width
template <typename T, int R, bool kSeven>
__global__ void __launch_bounds__(kThreads)
stencil_axpy_apply_dots_kernel(const T* __restrict__ r, const T* __restrict__ p,
                               const typename Compute<T>::type* __restrict__ beta,
                               T* __restrict__ pn, T* __restrict__ w,
                               typename Compute<T>::type* __restrict__ parts,
                               Grid3 g, int tz, int tiles_x, int tiles_y) {
  using C = typename Compute<T>::type;
  extern __shared__ __align__(16) unsigned char march_smem[];  // two planes
  OutAxpy<T> out{pn, w, C(0)};
  sb::march<C, R, kSeven>(StageAxpy<T>{r, p, *beta}, g, tz, tiles_x, tiles_y,
                          static_cast<int>(blockIdx.x),
                          reinterpret_cast<C*>(march_smem), out);
  __shared__ C red[kThreads];
  const C delta = block_sum(out.delta, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = delta;
}

bool bad_dims(int nx, int ny, int nz) { return nx <= 0 || ny <= 0 || nz <= 0; }

template <typename T>
int apply(const void* x, void* y, void* parts, int nx, int ny, int nz,
          int use_7pt, int r, int tz, long long grid, long long smem,
          void* stream) {
  using C = typename Compute<T>::type;
  if (bad_dims(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid3 g = sb::make_grid(nx, ny, nz);
  int tiles_x = 0, tiles_y = 0;
  if (!sb::march_plan_ok<C>(g, r, tz, grid, smem, &tiles_x, &tiles_y))
    return static_cast<int>(cudaErrorInvalidValue);
  sb::dispatch(r, use_7pt != 0, [&](auto kr, auto k7) {
    constexpr int kR = decltype(kr)::value;
    constexpr bool k7pt = decltype(k7)::value;
    const auto kernel = parts != nullptr ? stencil_apply_kernel<T, kR, k7pt, true>
                                         : stencil_apply_kernel<T, kR, k7pt, false>;
    kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(parts),
        g, tz, tiles_x, tiles_y);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int axpy_apply_dots(const void* r, const void* p, const void* beta, void* pn,
                    void* w, void* parts, int nx, int ny, int nz, int use_7pt,
                    int rows, int tz, long long grid, long long smem,
                    void* stream) {
  using C = typename Compute<T>::type;
  if (bad_dims(nx, ny, nz)) return static_cast<int>(cudaErrorInvalidValue);
  const Grid3 g = sb::make_grid(nx, ny, nz);
  int tiles_x = 0, tiles_y = 0;
  if (!sb::march_plan_ok<C>(g, rows, tz, grid, smem, &tiles_x, &tiles_y))
    return static_cast<int>(cudaErrorInvalidValue);
  sb::dispatch(rows, use_7pt != 0, [&](auto kr, auto k7) {
    stencil_axpy_apply_dots_kernel<T, decltype(kr)::value, decltype(k7)::value>
        <<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(r), static_cast<const T*>(p),
            static_cast<const C*>(beta), static_cast<T*>(pn), static_cast<T*>(w),
            static_cast<C*>(parts), g, tz, tiles_x, tiles_y);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan (r, tz, grid, smem) is ops/stencil.py tile_plan's: R rows a
// thread, tz planes a run, the grid of tiles x runs and the shared bytes of
// the two staged planes. A plan that does not fit the grid is refused with
// cudaErrorInvalidValue before anything launches.

#define SB_STENCIL_PLAN int r, int tz, long long grid, long long smem

// parts: nullptr (apply only) or grid x 2 floats (the dots form)
int sb_stencil_apply_bf16(const void* x, void* y, void* parts, int nx, int ny,
                          int nz, int use_7pt, SB_STENCIL_PLAN, void* stream) {
  return apply<__nv_bfloat16>(x, y, parts, nx, ny, nz, use_7pt, r, tz, grid,
                              smem, stream);
}
int sb_stencil_apply_f32(const void* x, void* y, void* parts, int nx, int ny,
                         int nz, int use_7pt, SB_STENCIL_PLAN, void* stream) {
  return apply<float>(x, y, parts, nx, ny, nz, use_7pt, r, tz, grid, smem,
                      stream);
}
int sb_stencil_apply_f64(const void* x, void* y, void* parts, int nx, int ny,
                         int nz, int use_7pt, SB_STENCIL_PLAN, void* stream) {
  return apply<double>(x, y, parts, nx, ny, nz, use_7pt, r, tz, grid, smem,
                       stream);
}

// beta: one scalar on the device at the compute width (f32 for bf16/f32
// vectors, f64 for f64); parts: grid scalars at that width
int sb_stencil_axpy_apply_dots_bf16(const void* r_, const void* p, const void* beta,
                                    void* pn, void* w, void* parts, int nx, int ny,
                                    int nz, int use_7pt, SB_STENCIL_PLAN,
                                    void* stream) {
  return axpy_apply_dots<__nv_bfloat16>(r_, p, beta, pn, w, parts, nx, ny, nz,
                                        use_7pt, r, tz, grid, smem, stream);
}
int sb_stencil_axpy_apply_dots_f32(const void* r_, const void* p, const void* beta,
                                   void* pn, void* w, void* parts, int nx, int ny,
                                   int nz, int use_7pt, SB_STENCIL_PLAN,
                                   void* stream) {
  return axpy_apply_dots<float>(r_, p, beta, pn, w, parts, nx, ny, nz, use_7pt,
                                r, tz, grid, smem, stream);
}
int sb_stencil_axpy_apply_dots_f64(const void* r_, const void* p, const void* beta,
                                   void* pn, void* w, void* parts, int nx, int ny,
                                   int nz, int use_7pt, SB_STENCIL_PLAN,
                                   void* stream) {
  return axpy_apply_dots<double>(r_, p, beta, pn, w, parts, nx, ny, nz, use_7pt,
                                 r, tz, grid, smem, stream);
}

#undef SB_STENCIL_PLAN

}  // extern "C"
