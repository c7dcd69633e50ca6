// Pass 1 of the compact row-block CSR SpMV for Hopper (sm_90a): P5 of the
// port.
//
// Replaces benchmarks/csr_twopass_proto.py pass1_products (body _p1_kernel).
// The layout (sparsebench_tpu_torch/benchmarks/csr_twopass_proto.py
// build_streams): rows go R to a block; block b's stored entries lie in one
// flat stream of block_cap slots, padded with zeros, whose column is kept
// relative to the block's window of x, colrel = col - (b R - band). Output
// slot (b, e):
//
//   out[b, e] = val[b, e] * xpad[b R + colrel[b, e]]
//
// with xpad = [band zeros, x, R + band zeros]. A colrel outside the window
// [0, R + 2 band) gives 0 * val, as the TPU kernel's K-way select chain gives
// 0 there; a padding slot has val 0 and colrel 0.
//
// What it computes and none of how: the K shifted lane-gathers fused by
// select are Mosaic's only way to an arbitrary gather from a VMEM window.
// Here one thread computes one slot: it reads val and colrel coalesced (4 B
// each), gathers x through L1 (the block's window is R + 2 band floats, 8 KB
// at R 1024, band 512, and the slots of a CUDA block all lie in one row block
// whenever block_cap is a multiple of the CUDA block, so the window stays in
// L1), and writes the product coalesced.
//
// What bounds it: memory. val and colrel are read once and out written once,
// 12 B a slot, plus x once; one multiply a slot.
//
// The product is rounded on its own (__fmul_rn), so the kernel gives the bits
// of the plain PyTorch version (ops/csr_twopass.py pass1_products_torch). The
// entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns the launch's error code.

#include "common.cuh"

namespace {

constexpr int kThreads = sb::kThreads;

__global__ void __launch_bounds__(kThreads)
pass1_kernel(const float* __restrict__ val, const int* __restrict__ colrel,
             const float* __restrict__ xpad, float* __restrict__ out,
             long long n_slots, int block_cap, int rows_per_block, int window,
             long long xpad_len) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_slots) return;
  const long long b = i / block_cap;
  const int c = __ldg(colrel + i);
  const long long xi = b * rows_per_block + c;
  const float g = (c >= 0 && c < window && xi < xpad_len) ? __ldg(xpad + xi) : 0.0f;
  out[i] = __fmul_rn(__ldg(val + i), g);
}

}  // namespace

extern "C" int sb_csr_pass1_f32(const void* val, const void* colrel,
                                const void* xpad, void* out, long long nb,
                                int block_cap, int rows_per_block, int window,
                                long long xpad_len, void* stream) {
  if (nb <= 0 || block_cap <= 0 || rows_per_block <= 0 || window <= 0 ||
      xpad_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_slots = nb * block_cap;
  const long long grid = (n_slots + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pass1_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(val), static_cast<const int*>(colrel),
      static_cast<const float*>(xpad), static_cast<float*>(out), n_slots,
      block_cap, rows_per_block, window, xpad_len);
  return static_cast<int>(cudaGetLastError());
}
