// The body of CG in three kernels around the SpMV, for Hopper (sm_90a):
// K15 of the port. Each launch covers all k columns of a (k, n) slab,
// slab-major (column c is row c, n contiguous elements); the single-RHS
// loop runs it at k = 1.
//
//     A  cg_multi_p_kernel    per column: active, first, beta from its
//                             committed scalars; P = R + beta P where active;
//                             hist[it, c] = sqrt(rt)
//     (the SpMV: AP = A P; K8 on DIA, else the stacked single-vector
//     product, or the format's own kernel at k = 1)
//     B  cg_multi_pap_kernel  per column p.Ap; the column's last block:
//                             alpha, breakdown, and the commit of its count,
//                             rtrans, normr and done
//     C  cg_multi_xr_kernel   X += alpha P, R -= alpha AP and each column's
//                             r.r; the column's last block commits r.r for
//                             the next body's beta
//
// It replaces no TPU kernel: the JAX package's loops (solvers/cg.py cg_run,
// solvers/cg_multi.py) are fused by XLA. The port's eager bodies (the plain
// versions: ops/cg_body.py, 26 vector passes a body, and
// solvers/cg_multi.py plain_bodies, 25 slab passes) run dozens of small
// torch operations; this makes 11 passes (A 3, B 2, C 6) in 3 launches,
// whatever k is, and keeps every column's scalars on the card.
//
// What bounds it: memory, 11 passes of k n elements a body (352 MB at 200^3
// in f32, k = 1; 2.8 GB at k = 8). The grid is (g, k): blockIdx.y is the
// column, blockIdx.x one of g blocks over n (sb_cg_multi_blocks_*: one wave
// of the card, as many blocks as the kernels' registers let an SM hold at
// once: 6 on the H100 in f32 and in f64, where C's update takes 40
// registers, with 16-byte loads in f32 and lane by lane in f64; at 200^3
// in f64 a body took 0.2398 ms at k = 1 and 1.857 ms at k = 8 on that
// grid, against 0.2410 and 1.851 ms at 8 blocks an SM, H100 at 700 W), so
// each column is walked alike: 16 bytes a thread in a grid-stride loop
// over the column, the last n mod 16/sizeof(T) elements in a scalar loop.
// Where k > 1 and n is not a multiple of 16/sizeof(T) the columns
// after the first do not start 16-byte aligned; the kernels then load the
// same elements one at a time, in the same order (kVec false).
//
// The recurrence is that of each column of cg_run, scalar for scalar
// (ops/cg_body.py says which torch operation each step mirrors): the exit
// test reads the previous body's normr against eps in f64 (cg_run's
// comparison in the wider of the dtypes: f64 holds both exactly), the first
// body (count == 1) keeps the initial rtrans and takes beta = 0, breakdown
// (p.Ap <= rt * 1e-30) sets alpha to 0 and done, and an inactive column
// writes no vector and no state entry (its history slot stays as it was).
// Products, sums, quotients and square roots are rounded one by one
// (common.cuh). A run starts from any CG state: the count, done, P, rtrans
// and normr it is given.
//
// Dots are taken in a fixed order, column by column: each thread sums its
// own elements in order, each block its threads as a fixed tree
// (sb::block_sum) into one partial, and the column's last block to finish
// (its own ticket after a __threadfence) sums the column's g partials in
// index order (sb::last_block, sb::sum_partials). The grid is fixed for
// (n, dtype, card), so column c of a blocked solve gives the bits of the
// single-RHS solve of column c, given the same SpMV product (K8's row c is
// K1 on column c) and the same r.r at the start of the run. The r.r of the
// start of a run is C launched with no update (kUpdate false) on the same
// grid: the same bits as the r.r that C leaves at the end of a body.
//
// A scalar that the blocks of one launch read is never written in that
// launch: A writes only the body's own slots (rt, normr_new, the active
// flag) and hist; B's last blocks commit what A reads; C's last blocks
// write r.r, which only A reads. An inactive column's blocks return in B
// and C before they take its ticket.
//
// Types: T is both the vectors' and the scalars' dtype (f32 or f64). The
// entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include <climits>

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::block_sum;
using sb::kThreads;
using sb::last_block;
using sb::mul_rn;
using sb::Pack;
using sb::safe_div;
using sb::sqrt_rn;
using sb::sub_rn;
using sb::sum_partials;

// rows of the run's (kSlots, k) scalar buffer s (ops/cg_multi_body.py SLOTS)
enum Slot { kRtrans = 0, kNormr, kRr, kRt, kNormrNew, kAlpha };
// rows of the run's (3, k) int buffer flags: the body's active flag, the
// column's ticket, done (breakdown)
enum Flag { kActive = 0, kTicket, kDone };

// pack j of a column: one 16-byte access where the column is aligned
// (kVec), else its lanes one by one
template <typename T, bool kVec>
__device__ __forceinline__ Pack<T> load(const T* col, long long j) {
  if constexpr (kVec) {
    return reinterpret_cast<const Pack<T>*>(col)[j];
  } else {
    Pack<T> a;
#pragma unroll
    for (int l = 0; l < Pack<T>::kLanes; ++l) a.v[l] = col[j * Pack<T>::kLanes + l];
    return a;
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store(T* col, long long j, const Pack<T>& a) {
  if constexpr (kVec) {
    reinterpret_cast<Pack<T>*>(col)[j] = a;
  } else {
#pragma unroll
    for (int l = 0; l < Pack<T>::kLanes; ++l) col[j * Pack<T>::kLanes + l] = a.v[l];
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
cg_multi_p_kernel(const T* __restrict__ r, T* __restrict__ p, T* s,
                  const int* __restrict__ count,
                  const double* __restrict__ eps, T* __restrict__ hist,
                  long long hist_len, int* flags, long long k_end,
                  long long n) {
  const int k = gridDim.y;
  const int c = blockIdx.y;
  const long long kk = count[c];
  const T normr = s[kNormr * k + c];
  const T rtrans = s[kRtrans * k + c];
  const T rr = s[kRr * k + c];
  const bool active = kk < k_end && static_cast<double>(normr) > eps[c] &&
                      flags[kDone * k + c] == 0;
  const bool first = kk == 1;
  const T rt = first ? rtrans : rr;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const T normr_new = sqrt_rn(rt);
    s[kRt * k + c] = rt;
    s[kNormrNew * k + c] = normr_new;
    flags[kActive * k + c] = active;
    if (active && kk >= 0 && kk < hist_len) hist[kk * k + c] = normr_new;
  }
  if (!active) return;
  // the first body: r + 0 p, as cg_run computes it
  const T beta = first ? T(0) : safe_div(rr, rtrans);
  constexpr int L = Pack<T>::kLanes;
  const T* rc = r + c * n;
  T* pc = p + c * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / L;
  for (long long j = tid; j < nvec; j += stride) {
    const Pack<T> a = load<T, kVec>(rc, j);
    Pack<T> b = load<T, kVec>(pc, j);
#pragma unroll
    for (int l = 0; l < L; ++l) b.v[l] = add_rn(a.v[l], mul_rn(beta, b.v[l]));
    store<T, kVec>(pc, j, b);
  }
  for (long long i = nvec * L + tid; i < n; i += stride) {
    pc[i] = add_rn(rc[i], mul_rn(beta, pc[i]));
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
cg_multi_pap_kernel(const T* __restrict__ ap, const T* __restrict__ p, T* s,
                    int* __restrict__ count, int* flags,
                    T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads];
  const int k = gridDim.y;
  const int c = blockIdx.y;
  if (flags[kActive * k + c] == 0) return;  // the whole column, no ticket
  constexpr int L = Pack<T>::kLanes;
  const T* pc = p + c * n;
  const T* ac = ap + c * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / L;
  T acc = T(0);
  for (long long j = tid; j < nvec; j += stride) {
    const Pack<T> a = load<T, kVec>(pc, j);
    const Pack<T> b = load<T, kVec>(ac, j);
#pragma unroll
    for (int l = 0; l < L; ++l) acc = add_rn(acc, mul_rn(a.v[l], b.v[l]));
  }
  for (long long i = nvec * L + tid; i < n; i += stride) {
    acc = add_rn(acc, mul_rn(pc[i], ac[i]));
  }
  const T part = block_sum(acc, red);
  unsigned* ticket = reinterpret_cast<unsigned*>(flags + kTicket * k + c);
  T* parts = partials + static_cast<long long>(c) * gridDim.x;
  if (!last_block(part, parts, ticket)) return;
  const T pap = sum_partials(parts, ticket, red);
  if (threadIdx.x != 0) return;
  const T rt = s[kRt * k + c];
  const bool breakdown = pap <= mul_rn(rt, static_cast<T>(1e-30));
  s[kAlpha * k + c] = breakdown ? T(0) : safe_div(rt, pap);
  s[kRtrans * k + c] = rt;
  s[kNormr * k + c] = s[kNormrNew * k + c];
  count[c] += 1;
  if (breakdown) flags[kDone * k + c] = 1;
}

// kUpdate: X += alpha P, R -= alpha AP, then r.r of the new R (a body);
// otherwise r.r of R alone in every column (the start of a run)
template <typename T, bool kVec, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
cg_multi_xr_kernel(const T* __restrict__ ap, T* __restrict__ x,
                   const T* __restrict__ p, T* __restrict__ r, T* s,
                   int* flags, T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads];
  const int k = gridDim.y;
  const int c = blockIdx.y;
  // an inactive column: its x, r and committed r.r stand
  if (kUpdate && flags[kActive * k + c] == 0) return;
  const T alpha = kUpdate ? s[kAlpha * k + c] : T(0);
  constexpr int L = Pack<T>::kLanes;
  const T* ac = ap + c * n;
  const T* pc = p + c * n;
  T* xc = x + c * n;
  T* rc = r + c * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / L;
  T acc = T(0);
  for (long long j = tid; j < nvec; j += stride) {
    Pack<T> rv = load<T, kVec>(rc, j);
    if (kUpdate) {
      Pack<T> xv = load<T, kVec>(xc, j);
      const Pack<T> pv = load<T, kVec>(pc, j);
      const Pack<T> av = load<T, kVec>(ac, j);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        xv.v[l] = add_rn(xv.v[l], mul_rn(alpha, pv.v[l]));
        rv.v[l] = sub_rn(rv.v[l], mul_rn(alpha, av.v[l]));
      }
      store<T, kVec>(xc, j, xv);
      store<T, kVec>(rc, j, rv);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) acc = add_rn(acc, mul_rn(rv.v[l], rv.v[l]));
  }
  for (long long i = nvec * L + tid; i < n; i += stride) {
    T v = rc[i];
    if (kUpdate) {
      xc[i] = add_rn(xc[i], mul_rn(alpha, pc[i]));
      v = sub_rn(v, mul_rn(alpha, ac[i]));
      rc[i] = v;
    }
    acc = add_rn(acc, mul_rn(v, v));
  }
  const T part = block_sum(acc, red);
  unsigned* ticket = reinterpret_cast<unsigned*>(flags + kTicket * k + c);
  T* parts = partials + static_cast<long long>(c) * gridDim.x;
  if (!last_block(part, parts, ticket)) return;
  const T rr = sum_partials(parts, ticket, red);
  if (threadIdx.x == 0) s[kRr * k + c] = rr;
}

dim3 grid(int g, int k) {
  return dim3(static_cast<unsigned>(g), static_cast<unsigned>(k));
}

template <typename T>
int blocks(long long n, int* out) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // blocks resident on an SM at once, the least over the body's kernels
  int per_sm = INT_MAX;
  const auto least = [&](auto kernel) {
    int b = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0);
    }
    if (b < per_sm) per_sm = b;
  };
  least(cg_multi_p_kernel<T, true>);
  least(cg_multi_p_kernel<T, false>);
  least(cg_multi_pap_kernel<T, true>);
  least(cg_multi_pap_kernel<T, false>);
  least(cg_multi_xr_kernel<T, true, true>);
  least(cg_multi_xr_kernel<T, false, true>);
  least(cg_multi_xr_kernel<T, true, false>);
  least(cg_multi_xr_kernel<T, false, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one full wave at most; fewer blocks where n is small
  const long long per_block = static_cast<long long>(kThreads) * Pack<T>::kLanes;
  const long long want = (n + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *out = static_cast<int>(want < wave ? want : wave);
  return 0;
}

template <typename T, bool kVec>
void launch_p_as(const void* r, void* p, void* s, const void* count,
                 const void* eps, void* hist, long long hist_len, void* flags,
                 long long k_end, long long n, int g, int k, void* stream) {
  cg_multi_p_kernel<T, kVec><<<grid(g, k), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<T*>(p), static_cast<T*>(s),
      static_cast<const int*>(count), static_cast<const double*>(eps),
      static_cast<T*>(hist), hist_len, static_cast<int*>(flags), k_end, n);
}

template <typename T>
int launch_p(const void* r, void* p, void* s, const void* count,
             const void* eps, void* hist, long long hist_len, void* flags,
             long long k_end, long long n, int g, int k, int vec,
             void* stream) {
  if (vec) {
    launch_p_as<T, true>(r, p, s, count, eps, hist, hist_len, flags, k_end,
                         n, g, k, stream);
  } else {
    launch_p_as<T, false>(r, p, s, count, eps, hist, hist_len, flags, k_end,
                          n, g, k, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
void launch_pap_as(const void* ap, const void* p, void* s, void* count,
                   void* flags, void* partials, long long n, int g, int k,
                   void* stream) {
  cg_multi_pap_kernel<T, kVec><<<grid(g, k), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ap), static_cast<const T*>(p), static_cast<T*>(s),
      static_cast<int*>(count), static_cast<int*>(flags),
      static_cast<T*>(partials), n);
}

template <typename T>
int launch_pap(const void* ap, const void* p, void* s, void* count,
               void* flags, void* partials, long long n, int g, int k,
               int vec, void* stream) {
  if (vec) {
    launch_pap_as<T, true>(ap, p, s, count, flags, partials, n, g, k, stream);
  } else {
    launch_pap_as<T, false>(ap, p, s, count, flags, partials, n, g, k, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, bool kUpdate>
void launch_xr_as(const void* ap, void* x, const void* p, void* r, void* s,
                  void* flags, void* partials, long long n, int g, int k,
                  void* stream) {
  cg_multi_xr_kernel<T, kVec, kUpdate><<<grid(g, k), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ap), static_cast<T*>(x), static_cast<const T*>(p),
      static_cast<T*>(r), static_cast<T*>(s), static_cast<int*>(flags),
      static_cast<T*>(partials), n);
}

template <typename T>
int launch_xr(const void* ap, void* x, const void* p, void* r, void* s,
              void* flags, void* partials, long long n, int g, int k, int vec,
              int update, void* stream) {
  if (update && vec) {
    launch_xr_as<T, true, true>(ap, x, p, r, s, flags, partials, n, g, k,
                                stream);
  } else if (update) {
    launch_xr_as<T, false, true>(ap, x, p, r, s, flags, partials, n, g, k,
                                 stream);
  } else if (vec) {
    launch_xr_as<T, true, false>(ap, x, p, r, s, flags, partials, n, g, k,
                                 stream);
  } else {
    launch_xr_as<T, false, false>(ap, x, p, r, s, flags, partials, n, g, k,
                                  stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The run's grid over n elements a column on the current device: out, the
// blocks over n of every launch of the run.
int sb_cg_multi_blocks_f32(long long n, int* out) { return blocks<float>(n, out); }
int sb_cg_multi_blocks_f64(long long n, int* out) { return blocks<double>(n, out); }

// Every entry: g blocks over n a column (sb_cg_multi_blocks_* for n), k
// columns (gridDim.y), vec = 1 where every column starts 16-byte aligned.

// A: R, P (updated in place), s ((6, k) scalar slots), count (int32, k),
// eps (f64, k), hist (hist_len rows of k), flags (int32 (3, k): active,
// ticket, done)
int sb_cg_multi_p_f32(const void* r, void* p, void* s, const void* count,
                      const void* eps, void* hist, long long hist_len,
                      void* flags, long long k_end, long long n, int g, int k,
                      int vec, void* stream) {
  return launch_p<float>(r, p, s, count, eps, hist, hist_len, flags, k_end, n,
                         g, k, vec, stream);
}
int sb_cg_multi_p_f64(const void* r, void* p, void* s, const void* count,
                      const void* eps, void* hist, long long hist_len,
                      void* flags, long long k_end, long long n, int g, int k,
                      int vec, void* stream) {
  return launch_p<double>(r, p, s, count, eps, hist, hist_len, flags, k_end,
                          n, g, k, vec, stream);
}

// B: AP, P; s, count and done committed; partials of (k, g) entries
int sb_cg_multi_pap_f32(const void* ap, const void* p, void* s, void* count,
                        void* flags, void* partials, long long n, int g,
                        int k, int vec, void* stream) {
  return launch_pap<float>(ap, p, s, count, flags, partials, n, g, k, vec,
                           stream);
}
int sb_cg_multi_pap_f64(const void* ap, const void* p, void* s, void* count,
                        void* flags, void* partials, long long n, int g,
                        int k, int vec, void* stream) {
  return launch_pap<double>(ap, p, s, count, flags, partials, n, g, k, vec,
                            stream);
}

// C: AP, X and R updated in place, each column's r.r committed (update =
// 1), or each column's r.r of R alone (update = 0: AP, X and P are not
// read)
int sb_cg_multi_xr_f32(const void* ap, void* x, const void* p, void* r,
                       void* s, void* flags, void* partials, long long n,
                       int g, int k, int vec, int update, void* stream) {
  return launch_xr<float>(ap, x, p, r, s, flags, partials, n, g, k, vec,
                          update, stream);
}
int sb_cg_multi_xr_f64(const void* ap, void* x, const void* p, void* r,
                       void* s, void* flags, void* partials, long long n,
                       int g, int k, int vec, int update, void* stream) {
  return launch_xr<double>(ap, x, p, r, s, flags, partials, n, g, k, vec,
                           update, stream);
}

}  // extern "C"
