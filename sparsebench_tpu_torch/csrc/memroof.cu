// Read ceiling of device memory for Hopper (sm_90a): one launch streams an
// (n_tiles * tile_rows, 128) f32 array end to end `reps` times.
//
// Replaces the TPU kernel in sparsebench_tpu/ops/memroof.py: _read_kernel via
// _read_passes (measure_dma_read_gbps). That kernel walks n_steps =
// reps * n_tiles grid steps, double-buffers tile (i mod n_tiles) of step i
// into VMEM by DMA and adds its first 8 rows to an (8, 128) output:
//
//     out = sum over steps i = 0 .. n_steps-1, in order, of
//           x[(i mod n_tiles) * tile_rows + r, c],   r < 8, c < 128
//
// Design: a tile is tile_rows * 32 float4s, and the grid has exactly that
// many threads (tile_rows / 8 blocks of 256), so thread j reads float4 j of
// every tile: step i's load is tile (i mod n_tiles), and a step of the
// whole grid reads one whole tile, 16 bytes a thread, neighbouring threads
// on neighbouring addresses, through the read-only path (__ldg). The loop
// over steps is unrolled 8 deep so that each thread keeps 8 independent
// loads in flight (8 MB for the grid at the default 2048-row tiles). The
// first 8 rows of a tile are float4s 0..255, the threads of block 0, which
// add their float4 to a register sum in step order: that is the TPU kernel's
// output, summed in its order, and needs no reduction across blocks.
//
// A load whose value is never used is deleted by the compiler (a TPU DMA
// could not be elided), so every value read also feeds a second output: each
// thread sums x, y, z and w of every float4 it loads, in step order, and the
// block's 256 sums go through sb::block_sum into sink[block] (tile_rows / 8
// entries). The plain version (ops/memroof.py read_passes_torch) computes
// both outputs in the same order, so they agree bit for bit.
//
// Bound: the bytes, n_tiles * tile_rows * 128 * 4 per pass; the adds (5 per
// float4) are far below the card's rate. The array must exceed the L2 by far
// for the passes after the first to come from device memory: the Python
// wrapper measure_dma_read_gbps refuses arrays below 4 x the L2. TMA or
// cp.async.bulk tile copies are later work.
//
// The entry point launches on the stream it is given, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::kThreads;

constexpr int kStripF4 = 8 * 128 / 4;  // the first 8 rows of a tile, float4s
constexpr int kUnroll = 8;
static_assert(kStripF4 == kThreads, "block 0 holds the strip, one float4 a thread");

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(add_rn(a.x, b.x), add_rn(a.y, b.y), add_rn(a.z, b.z),
                     add_rn(a.w, b.w));
}

__device__ __forceinline__ float add_all(float s, float4 v) {
  return add_rn(add_rn(add_rn(add_rn(s, v.x), v.y), v.z), v.w);
}

__global__ void __launch_bounds__(kThreads)
read_passes_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                   float* __restrict__ sink, long long tile_f4,
                   long long n_tiles, long long n_steps) {
  __shared__ float red[kThreads];
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* p = x + j;
  const bool strip_thread = blockIdx.x == 0;  // uniform over the block
  float4 strip = make_float4(0.f, 0.f, 0.f, 0.f);
  float total = 0.f;
  long long t = 0;  // tile of the next step: step mod n_tiles
  long long i = 0;
  for (; i + kUnroll <= n_steps; i += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldg(p + t * tile_f4);
      t = (t + 1 == n_tiles) ? 0 : t + 1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      total = add_all(total, v[u]);
      if (strip_thread) strip = add4(strip, v[u]);
    }
  }
  for (; i < n_steps; ++i) {
    const float4 v = __ldg(p + t * tile_f4);
    t = (t + 1 == n_tiles) ? 0 : t + 1;
    total = add_all(total, v);
    if (strip_thread) strip = add4(strip, v);
  }
  const float block_total = sb::block_sum(total, red);
  if (threadIdx.x == 0) sink[blockIdx.x] = block_total;
  if (strip_thread) out[threadIdx.x] = strip;
}

}  // namespace

extern "C" {

// x: (n_tiles * tile_rows, 128) f32; out: (8, 128) f32; sink: tile_rows / 8
// f32. tile_rows must be a positive multiple of 8.
int sb_read_passes_f32(const void* x, void* out, void* sink, long long n_tiles,
                       long long tile_rows, long long reps, void* stream) {
  if (n_tiles <= 0 || reps <= 0 || tile_rows <= 0 || tile_rows % 8 != 0 ||
      tile_rows / 8 > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tile_f4 = tile_rows * 128 / 4;
  const unsigned blocks = static_cast<unsigned>(tile_f4 / kThreads);
  read_passes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out),
      static_cast<float*>(sink), tile_f4, n_tiles, reps * n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
