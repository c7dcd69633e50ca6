// BSLAB sparse matrix-vector product for Hopper (sm_90a): K6 and K7 of the
// port.
//
// Replaces sparsebench_tpu/ops/bslab_pallas.py: bslab_spmv (K6, body
// _kernel_whole, whole x resident in VMEM) and bslab_spmv_win (K7, body
// _kernel_win, x read through a per-tile window of 2W rows), both summing
// slices as _accumulate does. The layout (formats/bslab.py): rows go 128 to a
// lane group, ``sub`` lane groups to a tile; a slice is a (sub, 128) plane of
// values for one tile, and output (t, s, lane), row (t*sub + s)*128 + lane,
// sums over the tile's slices, in stored order, affine then general then
// wide:
//
//   affine  p: vals_aff[t,p,s,lane] * X[dbase + s,        (lane + r) & 127]
//   general p: vals_gen[t,p,s,lane] * X[dbase + s,        lidx_gen[t,p,s,lane]]
//   wide    p: vals_wide[t,p,s,lane] * X[dbase + s + dblk, lidx_wide[t,p,s,lane]]
//
// with (dbase, r) from meta_aff[t,p], dbase from meta_gen/meta_wide[t,p], and
// X[row, c] = x[(row - lead)*128 + c], zero outside x. The TPU kernels read a
// zero-padded x of ``lead`` leading rows; here x is read unpadded and an index
// outside it gives 0, the same value, which saves the pad copy of every SpMV.
//
// What it computes and none of how: the lane rolls, the SMEM metadata blocks,
// the static unroll limit and the per-group hoisted wide tables are ways
// around Mosaic. Here one thread computes one output element at a time and
// loops over the tile's slices at run time; the block first copies the tile's
// slice metadata into shared memory. Reads of the value, index and block
// planes are coalesced along the lanes.
//
// K6 gathers x through L1/L2 (all of x is 32 MB at 200^3 in f32, inside the
// 50 MB L2). K7 stages the tile's window, x rows [wchunk*W, wchunk*W + 2W),
// in shared memory and gathers from there; the window must fit the block's
// 227 KB (the wrapper refuses otherwise and never falls back to K6). A read
// outside the window gives NaN, so a layout whose slices leave their window
// shows in the output instead of reading another block's memory.
//
// What bounds them: memory. Per SpMV every slice plane is read once (values,
// plus an int8 index plane per general slice and index and block planes per
// wide slice), x once and y written once; 2 flops per stored element. A
// faster schedule (several outputs per thread with vector loads, TMA staging
// of the planes) is later work.
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in the slice order above, so the kernels give the bits of the
// plain PyTorch version (ops/bslab_spmv.py bslab_spmv_torch). Values widen to
// the x type before the multiply. Instances (values, x): (bf16, f32) the
// default f32 path with losslessly compressed values, (f32, f32), (f64, f64).
// Entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return the launch's error code.

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::mul_rn;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kRowsK6 = 2;        // lane groups a K6 block covers
constexpr int kThreadsK6 = kRowsK6 * kLanes;
constexpr int kThreadsK7 = 512;   // 4 lane groups at a time
constexpr int kMetaSmemK6 = 48 * 1024;

struct Slices {
  const int* meta_aff;  // (n_tiles, s_aff, 2) [dbase, r]
  const void* vals_aff;
  const int* meta_gen;  // (n_tiles, s_gen) dbase
  const void* vals_gen;
  const signed char* lidx_gen;
  const int* meta_wide;  // (n_tiles, s_wide) dbase at dblk == 0
  const void* vals_wide;
  const signed char* lidx_wide;
  const signed char* dblk_wide;
  int s_aff, s_gen, s_wide;
};

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// X[row, c] from x in device memory (K6)
template <typename TX>
struct GlobalX {
  const TX* x;
  long long n;
  int lead;
  __device__ __forceinline__ TX operator()(int row, int c) const {
    const long long j = static_cast<long long>(row - lead) * kLanes + c;
    return (j >= 0 && j < n) ? __ldg(x + j) : TX(0);
  }
};

// X[row, c] from the window staged in shared memory (K7)
template <typename TX>
struct WindowX {
  const TX* win;
  int row0;
  int rows;
  __device__ __forceinline__ TX operator()(int row, int c) const {
    const int r = row - row0;
    return (r >= 0 && r < rows) ? win[r * kLanes + c] : quiet_nan<TX>();
  }
};

// The tile's metadata into shared memory: [aff dbase, r]*, gen*, wide*.
__device__ __forceinline__ void load_meta(int* meta, const Slices& sl, int t) {
  const int na = 2 * sl.s_aff;
  const int* ga = sl.meta_aff + static_cast<long long>(t) * na;
  const int* gg = sl.meta_gen + static_cast<long long>(t) * sl.s_gen;
  const int* gw = sl.meta_wide + static_cast<long long>(t) * sl.s_wide;
  const int total = na + sl.s_gen + sl.s_wide;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    meta[k] = k < na ? ga[k]
            : k < na + sl.s_gen ? gg[k - na]
            : gw[k - na - sl.s_gen];
  }
}

// Output (t, s, lane): the slices in stored order, one rounding per op.
template <typename TD, typename TX, typename Gather>
__device__ __forceinline__ TX accumulate(const Slices& sl, const int* meta,
                                         int t, int s, int lane, int sub,
                                         const Gather& gx) {
  const long long plane = static_cast<long long>(sub) * kLanes;
  const long long e = static_cast<long long>(s) * kLanes + lane;
  const long long tile = t;
  TX acc = TX(0);
  {
    const TD* v = static_cast<const TD*>(sl.vals_aff) + tile * sl.s_aff * plane + e;
    for (int p = 0; p < sl.s_aff; ++p, v += plane) {
      const TX g = gx(meta[2 * p] + s, (lane + meta[2 * p + 1]) & (kLanes - 1));
      acc = add_rn(acc, mul_rn(static_cast<TX>(widen(*v)), g));
    }
  }
  const int* mg = meta + 2 * sl.s_aff;
  {
    const long long off = tile * sl.s_gen * plane + e;
    const TD* v = static_cast<const TD*>(sl.vals_gen) + off;
    const signed char* li = sl.lidx_gen + off;
    for (int p = 0; p < sl.s_gen; ++p, v += plane, li += plane) {
      const TX g = gx(mg[p] + s, *li);
      acc = add_rn(acc, mul_rn(static_cast<TX>(widen(*v)), g));
    }
  }
  const int* mw = mg + sl.s_gen;
  {
    const long long off = tile * sl.s_wide * plane + e;
    const TD* v = static_cast<const TD*>(sl.vals_wide) + off;
    const signed char* li = sl.lidx_wide + off;
    const signed char* db = sl.dblk_wide + off;
    for (int p = 0; p < sl.s_wide; ++p, v += plane, li += plane, db += plane) {
      const TX g = gx(mw[p] + s + *db, *li);
      acc = add_rn(acc, mul_rn(static_cast<TX>(widen(*v)), g));
    }
  }
  return acc;
}

// K6: one thread per output; a block covers kRowsK6 lane groups of a tile.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreadsK6)
bslab_spmv_kernel(Slices sl, const TX* __restrict__ x, long long n,
                  TX* __restrict__ y, int sub, int lead) {
  extern __shared__ int meta[];
  const int parts = sub / kRowsK6;
  const int t = blockIdx.x / parts;
  const int s = (blockIdx.x % parts) * kRowsK6 + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  load_meta(meta, sl, t);
  __syncthreads();
  const TX acc = accumulate<TD, TX>(sl, meta, t, s, lane, sub,
                                    GlobalX<TX>{x, n, lead});
  y[(static_cast<long long>(t) * sub + s) * kLanes + lane] = acc;
}

// K7: a block covers ``rows`` lane groups of a tile, stages the tile's
// window of 2W x rows, then loops over its outputs, one per thread at a time.
template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreadsK7)
bslab_spmv_win_kernel(Slices sl, const int* __restrict__ wchunk,
                      const TX* __restrict__ x, long long n,
                      TX* __restrict__ y, int sub, int lead, int w_blocks,
                      int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* win = reinterpret_cast<TX*>(smem);
  const int win_rows = 2 * w_blocks;
  int* meta = reinterpret_cast<int*>(win + static_cast<long long>(win_rows) * kLanes);
  const int parts = sub / rows;
  const int t = blockIdx.x / parts;
  const int s0 = (blockIdx.x % parts) * rows;
  const int row0 = wchunk[t] * w_blocks;
  const long long base = static_cast<long long>(row0 - lead) * kLanes;
  for (int k = threadIdx.x; k < win_rows * kLanes; k += kThreadsK7) {
    const long long j = base + k;
    win[k] = (j >= 0 && j < n) ? __ldg(x + j) : TX(0);
  }
  load_meta(meta, sl, t);
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const WindowX<TX> gx{win, row0, win_rows};
  for (int s = s0 + threadIdx.x / kLanes; s < s0 + rows;
       s += kThreadsK7 / kLanes) {
    const TX acc = accumulate<TD, TX>(sl, meta, t, s, lane, sub, gx);
    y[(static_cast<long long>(t) * sub + s) * kLanes + lane] = acc;
  }
}

Slices make_slices(const int* meta_aff, const void* vals_aff,
                   const int* meta_gen, const void* vals_gen,
                   const void* lidx_gen, const int* meta_wide,
                   const void* vals_wide, const void* lidx_wide,
                   const void* dblk_wide, int s_aff, int s_gen, int s_wide) {
  return Slices{meta_aff, vals_aff, meta_gen, vals_gen,
                static_cast<const signed char*>(lidx_gen), meta_wide, vals_wide,
                static_cast<const signed char*>(lidx_wide),
                static_cast<const signed char*>(dblk_wide), s_aff, s_gen,
                s_wide};
}

bool bad_shape(int n_tiles, int sub, const Slices& sl) {
  return n_tiles <= 0 || sub <= 0 || sub % 8 != 0 || sl.s_aff < 0 ||
         sl.s_gen < 0 || sl.s_wide < 0;
}

size_t meta_bytes(const Slices& sl) {
  return sizeof(int) * static_cast<size_t>(2 * sl.s_aff + sl.s_gen + sl.s_wide);
}

template <typename TD, typename TX>
int launch(const Slices& sl, const void* x, long long n, void* y, int n_tiles,
           int sub, int lead, void* stream) {
  const size_t smem = meta_bytes(sl);
  if (bad_shape(n_tiles, sub, sl) || n < 0 || smem > kMetaSmemK6) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>(n_tiles) * (sub / kRowsK6);
  bslab_spmv_kernel<TD, TX><<<blocks, kThreadsK6, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      sl, static_cast<const TX*>(x), n, static_cast<TX*>(y), sub, lead);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of K7: the window, then the metadata.
template <typename TX>
size_t win_smem_bytes(int w_blocks, const Slices& sl) {
  return sizeof(TX) * 2 * static_cast<size_t>(w_blocks) * kLanes + meta_bytes(sl);
}

template <typename TD, typename TX>
int launch_win(const Slices& sl, const int* wchunk, int w_blocks,
               const void* x, long long n, void* y, int n_tiles, int sub,
               int lead, void* stream) {
  if (bad_shape(n_tiles, sub, sl) || n < 0 || w_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = win_smem_bytes<TX>(w_blocks, sl);
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
    err = cudaFuncSetAttribute(bslab_spmv_win_kernel<TD, TX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int rows = sub % 16 == 0 ? 16 : 8;
  const unsigned blocks = static_cast<unsigned>(n_tiles) * (sub / rows);
  bslab_spmv_win_kernel<TD, TX><<<blocks, kThreadsK7, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      sl, wchunk, static_cast<const TX*>(x), n, static_cast<TX*>(y), sub,
      lead, w_blocks, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define SB_BSLAB_ARGS                                                        \
  const int *meta_aff, const void *vals_aff, const int *meta_gen,           \
      const void *vals_gen, const void *lidx_gen, const int *meta_wide,     \
      const void *vals_wide, const void *lidx_wide, const void *dblk_wide,  \
      int s_aff, int s_gen, int s_wide, const void *x, long long n, void *y, \
      int n_tiles, int sub, int lead
#define SB_BSLAB_SLICES                                                     \
  make_slices(meta_aff, vals_aff, meta_gen, vals_gen, lidx_gen, meta_wide, \
              vals_wide, lidx_wide, dblk_wide, s_aff, s_gen, s_wide)

#define SB_BSLAB_ENTRIES(SUFFIX, TD, TX)                                      \
  int sb_bslab_spmv_##SUFFIX(SB_BSLAB_ARGS, void* stream) {                   \
    return launch<TD, TX>(SB_BSLAB_SLICES, x, n, y, n_tiles, sub, lead,       \
                          stream);                                            \
  }                                                                           \
  int sb_bslab_spmv_win_##SUFFIX(SB_BSLAB_ARGS, const int* wchunk,            \
                                 int w_blocks, void* stream) {                \
    return launch_win<TD, TX>(SB_BSLAB_SLICES, wchunk, w_blocks, x, n, y,     \
                              n_tiles, sub, lead, stream);                    \
  }

extern "C" {
SB_BSLAB_ENTRIES(bf16_f32, __nv_bfloat16, float)
SB_BSLAB_ENTRIES(f32_f32, float, float)
SB_BSLAB_ENTRIES(f64_f64, double, double)
}  // extern "C"
