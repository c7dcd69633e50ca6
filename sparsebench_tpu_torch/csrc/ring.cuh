// What the persistent, chunk-resident SpMV kernels share: K7
// (csrc/bslab_spmv.cu), K10/K11 (csrc/bsell_spmv.cu) and K8's staged form
// (csrc/dia_spmm.cu). A thread's vector
// loads of four plane values, the mbarrier and 1-D bulk-copy (cp.async.bulk)
// helpers, a unit's ring of W-row chunks of x in shared memory, and the
// launch helpers of a grid of persistent blocks.

#pragma once

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace sb {

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// a thread's four consecutive values of one plane, one vector load with the
// last-use hint (ld.global.lu: a plane is read once), widened on use
template <typename TD> struct Raw;

template <> struct Raw<__nv_bfloat16> {
  uint2 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldlu(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float get(int v) const {
    const unsigned w = v < 2 ? r.x : r.y;
    return __uint_as_float(v & 1 ? (w & 0xffff0000u) : (w << 16));
  }
};

template <> struct Raw<float> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldlu(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float get(int v) const {
    return v == 0 ? r.x : v == 1 ? r.y : v == 2 ? r.z : r.w;
  }
};

template <> struct Raw<double> {
  double2 a, b;
  __device__ __forceinline__ void load(const double* p) {
    a = __ldlu(reinterpret_cast<const double2*>(p));
    b = __ldlu(reinterpret_cast<const double2*>(p) + 1);
  }
  __device__ __forceinline__ double get(int v) const {
    return v == 0 ? a.x : v == 1 ? a.y : v == 2 ? b.x : b.y;
  }
};

// byte v of four int8 plane entries, sign-extended
__device__ __forceinline__ int byte_at(unsigned w, int v) {
  return static_cast<int>(static_cast<signed char>((w >> (8 * v)) & 0xffu));
}

// -- mbarriers and bulk copies ------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// order this thread's writes to shared memory before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// this thread's arrival on ``bar``, which then expects ``bytes`` more
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// copy ``bytes`` (> 0, a multiple of 16, both ends 16 B aligned) from src
// to dst, completed on ``bar``; an arrival on ``bar`` expects them
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// thread 0: expect ``bytes`` on ``bar`` and copy them from src to dst
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  fence_proxy_async();
  mbar_arrive_expect(bar, bytes);
  if (bytes > 0) bulk_load(dst, src, bytes, bar);
}

// a barrier over the unit: its thread-block cluster, or its one block
template <bool kCluster>
__device__ __forceinline__ void sync_unit() {
  if constexpr (kCluster) {
    cooperative_groups::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// -- the chunk ring -------------------------------------------------------------------

// Lane groups [g0, g1) of unit u of ``units``: contiguous, even runs.
__device__ __forceinline__ void unit_range(long long u, long long units,
                                           long long total, long long& g0,
                                           long long& g1) {
  g0 = u * total / units;
  g1 = (u + 1) * total / units;
}

// A unit's ring of ``n`` W-row chunks of x in shared memory, chunk k in slot
// k mod n. Thread 0 copies a chunk (the block's stripe of it) with one bulk
// copy, completed on the slot's mbarrier. Every thread keeps the same record
// of which chunk each slot holds and which copies are in flight, and waits
// on a slot's mbarrier itself before it reads the slot. The caller
// synchronises the block after construction (the mbarriers' init) and
// before a claim (no warp still reads a slot it overwrites).
template <int kMaxSlots>
struct ChunkRing {
  unsigned long long* bars;  // an mbarrier a slot
  int n;
  int resident[kMaxSlots];
  unsigned phase, pending;   // a bit a slot

  __device__ __forceinline__ ChunkRing(unsigned long long* bars_, int n_)
      : bars(bars_), n(n_), phase(0), pending(0) {
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) resident[s] = INT_MIN;
    if (threadIdx.x == 0) {
      for (int s = 0; s < n; ++s) mbar_init(bars + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // k mod n in [0, n) for any k (a broken layout's chunk may be negative)
  __device__ __forceinline__ int slot(int k) const {
    const int m = k % n;
    return m < 0 ? m + n : m;
  }
  // the chunk slot s holds, and a new one: s is known only at run time, so
  // the record goes through selects, which keep it in registers
  __device__ __forceinline__ int held(int s) const {
    int k = resident[0];
#pragma unroll
    for (int j = 1; j < kMaxSlots; ++j) k = s == j ? resident[j] : k;
    return k;
  }
  __device__ __forceinline__ void hold(int s, int k) {
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) resident[j] = s == j ? k : resident[j];
  }
  // until the copy into slot s, if one is in flight, has landed
  __device__ __forceinline__ void wait(int s) {
    if (pending >> s & 1u) {
      mbar_wait(bars + s, phase >> s & 1u);
      phase ^= 1u << s;
      pending &= ~(1u << s);
    }
  }
  // chunks c .. c + n - 1 into their slots: thread 0 calls fetch(k, slot)
  // for each that is not resident
  template <typename Fetch>
  __device__ __forceinline__ void claim(int c, const Fetch& fetch) {
    for (int j = 0; j < n; ++j) {
      const int k = c + j;
      const int s = slot(k);
      if (held(s) != k) {
        wait(s);  // a copy still in flight into the slot
        hold(s, k);
        pending |= 1u << s;
        if (threadIdx.x == 0) fetch(k, s);
      }
    }
  }
  // until chunks c and c + 1, the window of a tile on chunk c, have landed
  __device__ __forceinline__ void wait_window(int c) {
    wait(slot(c));
    wait(slot(c + 1));
  }
  __device__ __forceinline__ void drain() {
    for (int s = 0; s < n; ++s) wait(s);
  }
};

// -- launch -----------------------------------------------------------------------------

// raise a kernel's dynamic shared memory limit to ``smem`` once per size
// reached; ``configured`` is the kernel's own record
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& configured) {
  if (smem <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) configured = smem;
  return err;
}

// blocks of ``kernel`` that fit the card at once with ``smem`` bytes each
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  blocks = sms * per_sm;
  return err;
}

}  // namespace sb
