// The body of standard CG in three kernels around the SpMV, for Hopper
// (sm_90a): K13 of the port.
//
//     A  cg_body_p_kernel    active, first, beta from the committed scalars;
//                            p = r + beta p where active; hist[k] = sqrt(rt)
//     (the SpMV: Ap = A p, the format's own kernel)
//     B  cg_body_pap_kernel  p.Ap; the last block: alpha, breakdown, and the
//                            commit of k, rtrans, normr and done
//     C  cg_body_xr_kernel   x += alpha p, r -= alpha Ap and r.r; the last
//                            block commits r.r for the next body's beta
//
// It replaces no TPU kernel: the JAX package's body (solvers/cg.py cg_run)
// is fused by XLA. The port's eager body (the plain version, ops/cg_body.py)
// runs about 49 small torch operations a body besides the SpMV, most of
// them on 0-d tensors, and moves about 26 vector passes; this moves 11
// (A 3, B 2, C 6) in 3 launches and keeps the scalar recurrence on the card.
//
// What bounds it: memory, 11 passes of n elements a body (352 MB at 200^3
// in f32). Loads and stores are 16 bytes a thread (4 f32, 2 f64) in a
// grid-stride loop over one wave of the card (as many blocks as the
// kernels' registers let an SM hold at once: 6 in f32, 8 in f64); the last
// n mod 16/sizeof(T) elements take a scalar loop. Capping the registers to
// hold 8 blocks in f32 put C's values on the stack and cost it 29 % at
// 200^3 (60 against 78 us, H100 at 700 W); fewer blocks a wave cost A.
//
// The recurrence is cg_run's, scalar for scalar (ops/cg_body.py says which
// torch operation each step mirrors): the exit test reads the previous
// body's normr, the first body (k == 1) keeps the initial rtrans and takes
// beta = 0, breakdown (p.Ap <= rt * 1e-30) sets alpha to 0 and done, and an
// inactive body writes no vector and no state entry. Products, sums,
// quotients and square roots are rounded one by one (common.cuh).
//
// Dots are taken in a fixed order: each thread sums its own elements in
// order, each block its threads as a fixed tree (sb::block_sum) into one
// partial, and the last block to finish (a ticket counter after a
// __threadfence) sums the partials in index order. The grid is fixed for a
// run (sb_cg_body_blocks_*), so two runs on one input give the same bits.
// The r.r of the start of a run is C launched with update = 0 on the same
// grid: the same bits as the r.r that C leaves at the end of a body.
//
// A scalar that the blocks of one launch read is never written in that
// launch: A writes only the body's own slots (rt, normr_new, the active
// flag) and hist; B's last block commits what A reads; C's last block
// writes r.r, which only A reads.
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

// slots of the run's scalar buffer s (ops/cg_body.py SLOTS)
enum Slot { kRtrans = 0, kNormr, kRr, kRt, kNormrNew, kAlpha };
// words of the run's int buffer flags: the body's active flag, the ticket
enum Flag { kActive = 0, kTicket };

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_body_p_kernel(const T* __restrict__ r, T* __restrict__ p, T* s,
                 const long long* __restrict__ k, const bool* __restrict__ done,
                 const double* __restrict__ eps, T* __restrict__ hist,
                 long long hist_len, int* __restrict__ flags, long long k_end,
                 long long n) {
  const long long kk = *k;
  const T normr = s[kNormr];
  const T rtrans = s[kRtrans];
  const T rr = s[kRr];
  // cg_run compares normr with eps in the wider of their dtypes: f64 holds
  // both exactly
  const bool active =
      kk < k_end && static_cast<double>(normr) > *eps && !*done;
  const bool first = kk == 1;
  const T rt = first ? rtrans : rr;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const T normr_new = sqrt_rn(rt);
    s[kRt] = rt;
    s[kNormrNew] = normr_new;
    flags[kActive] = active;
    if (active && kk >= 0 && kk < hist_len) hist[kk] = normr_new;
  }
  if (!active) return;
  // the first body: r + 0 p, as cg_run computes it
  const T beta = first ? T(0) : safe_div(rr, rtrans);
  constexpr int L = Pack<T>::kLanes;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / L;
  const Pack<T>* rv = reinterpret_cast<const Pack<T>*>(r);
  Pack<T>* pv = reinterpret_cast<Pack<T>*>(p);
  for (long long j = tid; j < nvec; j += stride) {
    const Pack<T> a = rv[j];
    Pack<T> b = pv[j];
#pragma unroll
    for (int l = 0; l < L; ++l) b.v[l] = add_rn(a.v[l], mul_rn(beta, b.v[l]));
    pv[j] = b;
  }
  for (long long i = nvec * L + tid; i < n; i += stride) {
    p[i] = add_rn(r[i], mul_rn(beta, p[i]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cg_body_pap_kernel(const T* __restrict__ ap, const T* __restrict__ p, T* s,
                   long long* __restrict__ k, bool* __restrict__ done,
                   int* flags, T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads];
  const bool active = flags[kActive] != 0;
  T acc = T(0);
  if (active) {
    constexpr int L = Pack<T>::kLanes;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long tid =
        static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long nvec = n / L;
    const Pack<T>* pv = reinterpret_cast<const Pack<T>*>(p);
    const Pack<T>* av = reinterpret_cast<const Pack<T>*>(ap);
    for (long long j = tid; j < nvec; j += stride) {
      const Pack<T> a = pv[j];
      const Pack<T> b = av[j];
#pragma unroll
      for (int l = 0; l < L; ++l) acc = add_rn(acc, mul_rn(a.v[l], b.v[l]));
    }
    for (long long i = nvec * L + tid; i < n; i += stride) {
      acc = add_rn(acc, mul_rn(p[i], ap[i]));
    }
  }
  const T part = block_sum(acc, red);
  unsigned* ticket = reinterpret_cast<unsigned*>(flags + kTicket);
  if (!last_block(part, partials, ticket)) return;
  const T pap = sum_partials(partials, ticket, red);
  if (threadIdx.x != 0) return;
  const T rt = s[kRt];
  const bool breakdown = pap <= mul_rn(rt, static_cast<T>(1e-30));
  s[kAlpha] = (breakdown || !active) ? T(0) : safe_div(rt, pap);
  if (active) {
    s[kRtrans] = rt;
    s[kNormr] = s[kNormrNew];
    *k += 1;
    if (breakdown) *done = true;
  }
}

// kUpdate: x += alpha p, r -= alpha Ap, then r.r of the new r (a body);
// otherwise r.r of r alone (the start of a run)
template <typename T, bool kUpdate>
__global__ void __launch_bounds__(kThreads)
cg_body_xr_kernel(const T* __restrict__ ap, T* __restrict__ x,
                  const T* __restrict__ p, T* __restrict__ r, T* s,
                  int* flags, T* __restrict__ partials, long long n) {
  __shared__ T red[kThreads];
  // an inactive body: x, r and the committed r.r stand
  if (kUpdate && flags[kActive] == 0) return;
  const T alpha = kUpdate ? s[kAlpha] : T(0);
  constexpr int L = Pack<T>::kLanes;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long nvec = n / L;
  Pack<T>* rv = reinterpret_cast<Pack<T>*>(r);
  T acc = T(0);
  for (long long j = tid; j < nvec; j += stride) {
    Pack<T> c = rv[j];
    if (kUpdate) {
      Pack<T> xv = reinterpret_cast<Pack<T>*>(x)[j];
      const Pack<T> pv = reinterpret_cast<const Pack<T>*>(p)[j];
      const Pack<T> av = reinterpret_cast<const Pack<T>*>(ap)[j];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        xv.v[l] = add_rn(xv.v[l], mul_rn(alpha, pv.v[l]));
        c.v[l] = sub_rn(c.v[l], mul_rn(alpha, av.v[l]));
      }
      reinterpret_cast<Pack<T>*>(x)[j] = xv;
      rv[j] = c;
    }
#pragma unroll
    for (int l = 0; l < L; ++l) acc = add_rn(acc, mul_rn(c.v[l], c.v[l]));
  }
  for (long long i = nvec * L + tid; i < n; i += stride) {
    T c = r[i];
    if (kUpdate) {
      x[i] = add_rn(x[i], mul_rn(alpha, p[i]));
      c = sub_rn(c, mul_rn(alpha, ap[i]));
      r[i] = c;
    }
    acc = add_rn(acc, mul_rn(c, c));
  }
  const T part = block_sum(acc, red);
  unsigned* ticket = reinterpret_cast<unsigned*>(flags + kTicket);
  if (!last_block(part, partials, ticket)) return;
  const T rr = sum_partials(partials, ticket, red);
  if (threadIdx.x == 0) s[kRr] = rr;
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
  least(cg_body_p_kernel<T>);
  least(cg_body_pap_kernel<T>);
  least(cg_body_xr_kernel<T, true>);
  least(cg_body_xr_kernel<T, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one full wave at most; fewer blocks where n is small
  const long long per_block = static_cast<long long>(kThreads) * Pack<T>::kLanes;
  const long long want = (n + per_block - 1) / per_block;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *out = static_cast<int>(want < wave ? want : wave);
  return 0;
}

template <typename T>
int launch_p(const void* r, void* p, void* s, const void* k, const void* done,
             const void* eps, void* hist, long long hist_len, void* flags,
             long long k_end, long long n, int g, void* stream) {
  cg_body_p_kernel<T><<<static_cast<unsigned>(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<T*>(p), static_cast<T*>(s),
      static_cast<const long long*>(k), static_cast<const bool*>(done),
      static_cast<const double*>(eps), static_cast<T*>(hist), hist_len,
      static_cast<int*>(flags), k_end, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pap(const void* ap, const void* p, void* s, void* k, void* done,
               void* flags, void* partials, long long n, int g, void* stream) {
  cg_body_pap_kernel<T><<<static_cast<unsigned>(g), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ap), static_cast<const T*>(p), static_cast<T*>(s),
      static_cast<long long*>(k), static_cast<bool*>(done),
      static_cast<int*>(flags), static_cast<T*>(partials), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kUpdate>
void launch_xr_as(const void* ap, void* x, const void* p, void* r, void* s,
                  void* flags, void* partials, long long n, int g,
                  void* stream) {
  cg_body_xr_kernel<T, kUpdate><<<static_cast<unsigned>(g), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ap), static_cast<T*>(x), static_cast<const T*>(p),
      static_cast<T*>(r), static_cast<T*>(s), static_cast<int*>(flags),
      static_cast<T*>(partials), n);
}

template <typename T>
int launch_xr(const void* ap, void* x, const void* p, void* r, void* s,
              void* flags, void* partials, long long n, int g, int update,
              void* stream) {
  if (update) {
    launch_xr_as<T, true>(ap, x, p, r, s, flags, partials, n, g, stream);
  } else {
    launch_xr_as<T, false>(ap, x, p, r, s, flags, partials, n, g, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The run's grid for n elements on the current device: out, the blocks of
// every launch of the run.
int sb_cg_body_blocks_f32(long long n, int* out) { return blocks<float>(n, out); }
int sb_cg_body_blocks_f64(long long n, int* out) { return blocks<double>(n, out); }

// A: r, p (updated in place), s (the scalar slots), k (int64), done (bool),
// eps (f64), hist (hist_len entries), flags (int32: active, ticket)
int sb_cg_body_p_f32(const void* r, void* p, void* s, const void* k,
                     const void* done, const void* eps, void* hist,
                     long long hist_len, void* flags, long long k_end,
                     long long n, int g, void* stream) {
  return launch_p<float>(r, p, s, k, done, eps, hist, hist_len, flags, k_end,
                         n, g, stream);
}
int sb_cg_body_p_f64(const void* r, void* p, void* s, const void* k,
                     const void* done, const void* eps, void* hist,
                     long long hist_len, void* flags, long long k_end,
                     long long n, int g, void* stream) {
  return launch_p<double>(r, p, s, k, done, eps, hist, hist_len, flags, k_end,
                          n, g, stream);
}

// B: Ap, p; s, k and done committed; partials of g entries
int sb_cg_body_pap_f32(const void* ap, const void* p, void* s, void* k,
                       void* done, void* flags, void* partials, long long n,
                       int g, void* stream) {
  return launch_pap<float>(ap, p, s, k, done, flags, partials, n, g, stream);
}
int sb_cg_body_pap_f64(const void* ap, const void* p, void* s, void* k,
                       void* done, void* flags, void* partials, long long n,
                       int g, void* stream) {
  return launch_pap<double>(ap, p, s, k, done, flags, partials, n, g, stream);
}

// C: Ap, x and r updated in place (update = 1) or r.r of r alone
// (update = 0: Ap, x and p are not read)
int sb_cg_body_xr_f32(const void* ap, void* x, const void* p, void* r, void* s,
                      void* flags, void* partials, long long n, int g,
                      int update, void* stream) {
  return launch_xr<float>(ap, x, p, r, s, flags, partials, n, g, update, stream);
}
int sb_cg_body_xr_f64(const void* ap, void* x, const void* p, void* r, void* s,
                      void* flags, void* partials, long long n, int g,
                      int update, void* stream) {
  return launch_xr<double>(ap, x, p, r, s, flags, partials, n, g, update,
                           stream);
}

}  // extern "C"
