// Fused vector update of single-reduction (Chronopoulos-Gear) CG for
// Hopper (sm_90a): K4 of the port.
//
//     p' = u + beta p;   s' = w + beta s;   x' = x + alpha p';   r' = r - alpha s'
//
// in one pass: 6 vectors read, 4 written, one launch instead of four.
// Replaces sparsebench_tpu/ops/cg_fused.py cs_update_pallas
// (_cs_update_kernel :46, pallas_call :71).
//
// What bounds it: memory, 10 vector transfers for 8 flops a point. The TPU
// kernel blocks the vectors into (rows, 128) tiles and so needs a length
// that is a multiple of 1024; here a grid-stride loop over the flat vectors
// takes any length, with neighbouring threads on neighbouring addresses.
//
// alpha and beta arrive as f32 scalars on the device, as in the JAX package
// (it stacks them as f32), and are widened to the compute width: f32 for
// bf16 and f32 vectors, f64 for f64. bf16 vectors are computed in f32 and
// stored as bf16. Each product and sum is rounded on its own, so the kernel
// gives the bits of cs_update_torch (ops/cg_fused.py). The entry points
// launch on the stream they are given, do not synchronise, allocate
// nothing, and return cudaGetLastError().

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::Compute;
using sb::kThreads;
using sb::mul_rn;
using sb::narrow;
using sb::sub_rn;
using sb::widen;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cs_update_kernel(const T* __restrict__ u, const T* __restrict__ p,
                 const T* __restrict__ w, const T* __restrict__ s,
                 const T* __restrict__ x, const T* __restrict__ r,
                 T* __restrict__ p2, T* __restrict__ s2, T* __restrict__ x2,
                 T* __restrict__ r2, const float* __restrict__ alpha,
                 const float* __restrict__ beta, long long n) {
  using C = typename Compute<T>::type;
  const C al = static_cast<C>(*alpha);
  const C be = static_cast<C>(*beta);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const C pv = add_rn(widen(u[i]), mul_rn(be, widen(p[i])));
    const C sv = add_rn(widen(w[i]), mul_rn(be, widen(s[i])));
    p2[i] = narrow<T>(pv);
    s2[i] = narrow<T>(sv);
    x2[i] = narrow<T>(add_rn(widen(x[i]), mul_rn(al, pv)));
    r2[i] = narrow<T>(sub_rn(widen(r[i]), mul_rn(al, sv)));
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, const void* alpha,
           const void* beta, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // a few waves of full blocks; the grid-stride loop covers the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  cs_update_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<T*>(out[0]), static_cast<T*>(out[1]), static_cast<T*>(out[2]),
      static_cast<T*>(out[3]), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in: u, p, w, s, x, r; out: p', s', x', r' (all length n, one dtype);
// alpha, beta: one f32 each on the device
int sb_cs_update_bf16(const void* const* in, void* const* out, const void* alpha,
                      const void* beta, long long n, void* stream) {
  return launch<__nv_bfloat16>(in, out, alpha, beta, n, stream);
}
int sb_cs_update_f32(const void* const* in, void* const* out, const void* alpha,
                     const void* beta, long long n, void* stream) {
  return launch<float>(in, out, alpha, beta, n, stream);
}
int sb_cs_update_f64(const void* const* in, void* const* out, const void* alpha,
                     const void* beta, long long n, void* stream) {
  return launch<double>(in, out, alpha, beta, n, stream);
}

}  // extern "C"
