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
// What it computes and none of how: the lane-gather lookup table, the SMEM
// block table, the static unroll and the DMA semaphores are ways around
// Mosaic. Here one thread computes one output and walks its tile's slices at
// run time. Its sublane's block id is one int a slice, the same for the 128
// threads of the sublane (one broadcast load a warp); the value and int8 lane
// index planes are read coalesced along the lanes (256 B of bf16 values and
// 128 B of indices a slice row).
//
// K9 gathers x through L1/L2, as K6 does (all of x is 32 MB at 200^3 in f32,
// inside the 50 MB L2). K10 and K11 give a block the whole tile (1024
// threads), stage its window, x rows [base_t, base_t + 2W), in shared memory
// and gather from there; the window must fit the block's 227 KB (the wrapper
// refuses otherwise and never falls back to K9). They differ where a block id
// leaves the window, which a valid layout never does: K10 reads NaN there, so
// a broken layout shows in the output; K11 clamps the id into the window, as
// the TPU kernel's clipped reads of its two chunks do. A row of x outside the
// given x reads NaN in all three.
//
// What bounds them: memory. Per SpMV the value, index and block planes are
// read once, x once and y written once; 2 flops per stored element. A faster
// schedule (several outputs a thread with vector loads, TMA staging of the
// planes) is later work.
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in slice order, so the kernels give the bits of the plain
// PyTorch version (ops/bsell_spmv.py bsell_spmv_torch). Values widen to the x
// type before the multiply. Instances (values, x): (bf16, f32) the default f32
// path with losslessly compressed values, (f32, f32), (f64, f64). Entry points
// launch on the stream they are given, do not synchronise, allocate nothing,
// and return the launch's error code.

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::mul_rn;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kSub = 8;
constexpr int kRowsK9 = 2;                   // lane groups a K9 block covers
constexpr int kThreadsK9 = kRowsK9 * kLanes;
constexpr int kThreadsWin = kSub * kLanes;   // a K10/K11 block: the tile

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// X[base + b, c] from x in device memory (K9)
template <typename TX>
struct GlobalX {
  const TX* x;
  int x_rows;
  int base;
  __device__ __forceinline__ TX operator()(int b, int c) const {
    const int row = base + b;
    if (row < 0 || row >= x_rows || c < 0 || c >= kLanes) return quiet_nan<TX>();
    return __ldg(x + static_cast<long long>(row) * kLanes + c);
  }
};

// X[base + b, c] from the window staged in shared memory (K10, K11)
template <typename TX, bool kClamp>
struct WindowX {
  const TX* win;
  int rows;  // 2W
  __device__ __forceinline__ TX operator()(int b, int c) const {
    if constexpr (kClamp) {
      b = min(max(b, 0), rows - 1);
    } else if (b < 0 || b >= rows) {
      return quiet_nan<TX>();
    }
    if (c < 0 || c >= kLanes) return quiet_nan<TX>();
    return win[b * kLanes + c];
  }
};

// Output (t, s, lane): the slices in stored order, one rounding per op.
template <typename TD, typename TX, typename Gather>
__device__ __forceinline__ TX accumulate(const int* __restrict__ blocks,
                                         const TD* __restrict__ vals,
                                         const signed char* __restrict__ lidx,
                                         int t, int s, int lane, int s_max,
                                         const Gather& gx) {
  constexpr long long plane = kSub * kLanes;
  const long long e = static_cast<long long>(t) * s_max * plane + s * kLanes + lane;
  const int* blk = blocks + static_cast<long long>(t) * s_max * kSub + s;
  TX acc = TX(0);
#pragma unroll 4
  for (int p = 0; p < s_max; ++p) {
    const long long off = e + p * plane;
    const TX g = gx(__ldg(blk + p * kSub), static_cast<int>(lidx[off]));
    acc = add_rn(acc, mul_rn(static_cast<TX>(widen(vals[off])), g));
  }
  return acc;
}

// K9: one thread per output; a block covers kRowsK9 lane groups of a tile.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreadsK9)
bsell_spmv_kernel(const int* __restrict__ blocks, const int* __restrict__ base,
                  const TX* __restrict__ x, const TD* __restrict__ vals,
                  const signed char* __restrict__ lidx, TX* __restrict__ y,
                  int s_max, int x_rows) {
  constexpr int parts = kSub / kRowsK9;
  const int t = blockIdx.x / parts;
  const int s = (blockIdx.x % parts) * kRowsK9 + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const GlobalX<TX> gx{x, x_rows, __ldg(base + static_cast<long long>(t) * kSub)};
  const TX acc = accumulate<TD, TX>(blocks, vals, lidx, t, s, lane, s_max, gx);
  y[(static_cast<long long>(t) * kSub + s) * kLanes + lane] = acc;
}

// K10 (kClamp false) and K11 (kClamp true): a block per tile stages the
// tile's window of 2W x rows, then each thread computes one output.
template <typename TD, typename TX, bool kClamp>
__global__ void __launch_bounds__(kThreadsWin)
bsell_spmv_win_kernel(const int* __restrict__ blocks,
                      const int* __restrict__ wchunk, const TX* __restrict__ x,
                      const TD* __restrict__ vals,
                      const signed char* __restrict__ lidx, TX* __restrict__ y,
                      int s_max, int x_rows, int w_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* win = reinterpret_cast<TX*>(smem);
  const int t = blockIdx.x;
  const int win_rows = 2 * w_blocks;
  const long long row0 = static_cast<long long>(__ldg(wchunk + t)) * w_blocks;
  for (int k = threadIdx.x; k < win_rows * kLanes; k += kThreadsWin) {
    const long long row = row0 + k / kLanes;
    win[k] = (row >= 0 && row < x_rows) ? __ldg(x + row0 * kLanes + k)
                                        : quiet_nan<TX>();
  }
  __syncthreads();
  const int s = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const WindowX<TX, kClamp> gx{win, win_rows};
  const TX acc = accumulate<TD, TX>(blocks, vals, lidx, t, s, lane, s_max, gx);
  y[(static_cast<long long>(t) * kSub + s) * kLanes + lane] = acc;
}

template <typename TD, typename TX>
int launch(const int* blocks, const int* base, const void* x, const void* vals,
           const void* lidx, void* y, int n_tiles, int s_max, int x_rows,
           void* stream) {
  if (n_tiles <= 0 || s_max <= 0 || x_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(n_tiles) * (kSub / kRowsK9);
  bsell_spmv_kernel<TD, TX><<<grid, kThreadsK9, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      blocks, base, static_cast<const TX*>(x), static_cast<const TD*>(vals),
      static_cast<const signed char*>(lidx), static_cast<TX*>(y), s_max,
      x_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TX, bool kClamp>
int launch_win(const int* blocks, const int* wchunk, const void* x,
               const void* vals, const void* lidx, void* y, int n_tiles,
               int s_max, int x_rows, int w_blocks, void* stream) {
  if (n_tiles <= 0 || s_max <= 0 || x_rows < 0 || w_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(TX) * 2 * static_cast<size_t>(w_blocks) * kLanes;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's dynamic shared memory limit once per size reached
  static size_t configured = 0;
  if (smem > configured) {
    err = cudaFuncSetAttribute(bsell_spmv_win_kernel<TD, TX, kClamp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  bsell_spmv_win_kernel<TD, TX, kClamp><<<static_cast<unsigned>(n_tiles),
                                          kThreadsWin, smem,
                                          static_cast<cudaStream_t>(stream)>>>(
      blocks, wchunk, static_cast<const TX*>(x), static_cast<const TD*>(vals),
      static_cast<const signed char*>(lidx), static_cast<TX*>(y), s_max,
      x_rows, w_blocks);
  return static_cast<int>(cudaGetLastError());
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
                                  void* stream) {                             \
    return launch_win<TD, TX, false>(blocks, table, x, vals, lidx, y,         \
                                     n_tiles, s_max, x_rows, w_blocks,        \
                                     stream);                                 \
  }                                                                           \
  int sb_bsell_spmv_windowed_##SUFFIX(SB_BSELL_ARGS, int w_blocks,            \
                                      void* stream) {                         \
    return launch_win<TD, TX, true>(blocks, table, x, vals, lidx, y,          \
                                    n_tiles, s_max, x_rows, w_blocks,         \
                                    stream);                                  \
  }

extern "C" {
SB_BSELL_ENTRIES(bf16_f32, __nv_bfloat16, float)
SB_BSELL_ENTRIES(f32_f32, float, float)
SB_BSELL_ENTRIES(f64_f64, double, double)
}  // extern "C"
