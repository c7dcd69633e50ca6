// Helpers shared by the kernels of sparsebench_tpu_torch (csrc/*.cu).
//
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn and their double forms), so that nvcc contracts
// nothing into an FMA and a kernel gives the same bits as its plain
// PyTorch version, which rounds each elementwise op on its own as well.
// bf16 vectors are widened to f32 for the arithmetic and rounded to
// nearest even on the store, as PyTorch's .to(torch.bfloat16) does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sb {

constexpr int kThreads = 256;

// compute type of a stored type: bf16 -> f32, f32 -> f32, f64 -> f64
template <typename T> struct Compute { using type = T; };
template <> struct Compute<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(__nv_bfloat16 a) { return __bfloat162float(a); }
__device__ __forceinline__ float widen(float a) { return a; }
__device__ __forceinline__ double widen(double a) { return a; }

// compute type -> stored type
template <typename T, typename C>
__device__ __forceinline__ T narrow(C a) { return static_cast<T>(a); }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float a) {
  return __float2bfloat16_rn(a);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// Sum of v over the block's kThreads threads as a fixed tree: the same
// inputs give the same bits on every run. Every thread must call it; the
// result is valid in every thread. red holds kThreads entries.
template <typename C>
__device__ __forceinline__ C block_sum(C v, C* red) {
  const int t = threadIdx.x;
  __syncthreads();  // red may still be read by a previous call
  red[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] = add_rn(red[t], red[t + s]);
    __syncthreads();
  }
  return red[0];
}

}  // namespace sb

extern "C" const char* sb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
