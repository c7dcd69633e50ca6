// DIA SpMV window schedules for Hopper (sm_90a): P1 and P2 of the port.
//
// Replaces benchmarks/dia_micro.py run_variant (P1; six Mosaic ways to build
// the shifted window, make_kernel) and benchmarks/dia_shear.py run (P2; the
// roll path and the per-diagonal shifted copies of shear_chunk). All compute,
// for the flat output index i = 128 j + l of an (n_rows, 128) tile grid,
//
//   y[i] = sum over the plan (q, r, d) of f32(data[d, i]) * x[s_d + i]
//
// with s_d = 128 q + r the diagonal's non-negative shift, summed in plan order
// (sorted by (q, r, d), dia_micro.py _shift_plan) and each product and sum
// rounded on its own (__fmul_rn / __fadd_rn), so that the kernels give the
// bits of the plain version (ops/dia_window.py dia_window_torch). data is
// bf16, x and y f32.
//
// What the TPU variants did and what the card does instead. Lane rolls,
// sublane carries and misaligned sublane slices are ways around Mosaic's
// (8, 128) vregs; on the card a thread reads any float. So the six P1
// variants are four schedules here:
//   direct  (roll1, carry_roll, P2 roll): each thread reads x[s_d + i]
//           straight from device memory, through L1/L2, for each diagonal;
//   grouped (grp_carry, grp_align): a block takes a piece of 8 rows; for each
//           q-group (the diagonals that share q) it stages the group's
//           aligned window, x rows [row0 + q, row0 + q + 9), in shared memory
//           once, and each of the group's diagonals reads it at lane offset r
//           (the ninth row carries l + r >= 128);
//   qfloor  reads x[128 q + i] (r ignored) and floor reads x[i]: lower
//           bounds, wrong results, as on the TPU.
// P2's shear_chunk is the grouped schedule with the staging done by cp.async
// (16 B a copy, two window slots: the next group's window is in flight while
// the current one is read), so that the inner loop is convert, multiply and
// add out of shared memory. The TPU staged its whole chunk window, tpc rows
// tiles plus the span; at 200^3 the span alone is 632 rows (316 KiB of f32),
// over a block's 227 KB, so the card stages by q-group, a piece of 8 rows at
// a time: 2 x 9 rows x 512 B = 9 KB a block, whatever the tile and tpc.
// Window rows are 512 B aligned (x must be 16 B aligned, which the wrapper
// checks); the shifts r are not, so aligned rows are copied and r is applied
// on the shared-memory read.
//
// What bounds them: memory. The 27 bf16 planes are read once (54 B an
// output), x once in the best case and y written once; 2 flops a diagonal.
// The grouped schedules read each x row (1 + 1/8) times a q-group from L2 or
// device memory.
//
// Entry points launch on the stream they are given, do not synchronise,
// allocate nothing, and return the launch's error code. The wrapper checks
// that every read lies inside x: (n_rows + q_max + 1) 128 floats.

#include "common.cuh"

namespace {

using sb::add_rn;
using sb::mul_rn;
using sb::widen;

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kPieceRows = 8;                    // rows a staged block computes
constexpr int kOut = kPieceRows * kLanes / kThreads;  // outputs a thread
constexpr int kWin = (kPieceRows + 1) * kLanes;  // floats of a staged window
constexpr int kMaxDiags = 64;

enum Schedule { kDirect = 0, kGrouped = 1, kQfloor = 2, kFloor = 3, kShear = 4 };

// The plan (shift, diagonal) in plan order, and its q-groups: group g holds
// plan entries [g_begin[g], g_begin[g + 1]) with q = g_q[g].
struct Plan {
  int shift[kMaxDiags];
  int diag[kMaxDiags];
  int g_begin[kMaxDiags + 1];
  int g_q[kMaxDiags];
  int n_groups;
};

__device__ __forceinline__ void load_plan(const int* __restrict__ plan, int nd,
                                          Plan& p) {
  for (int k = threadIdx.x; k < nd; k += blockDim.x) {
    p.shift[k] = plan[2 * k];
    p.diag[k] = plan[2 * k + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = 0;
    for (int k = 0; k < nd; ++k) {
      const int q = p.shift[k] >> 7;
      if (k == 0 || q != p.g_q[g - 1]) {
        p.g_q[g] = q;
        p.g_begin[g] = k;
        ++g;
      }
    }
    p.g_begin[g] = nd;
    p.n_groups = g;
  }
  __syncthreads();
}

// direct, qfloor and floor: one thread an output, x read from device memory.
template <int kSchedule>
__global__ void __launch_bounds__(kThreads)
window_direct_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ data,
                     float* __restrict__ y, const int* __restrict__ plan, int nd,
                     long long n_out) {
  __shared__ Plan p;
  load_plan(plan, nd, p);
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  float acc = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const int s = p.shift[k];
    const long long off = kSchedule == kDirect ? s
                        : kSchedule == kQfloor ? (s & ~(kLanes - 1)) : 0;
    const float term = mul_rn(widen(data[p.diag[k] * n_out + i]), __ldg(x + off + i));
    acc = k == 0 ? term : add_rn(acc, term);
  }
  y[i] = acc;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start the copies of the window of rows [row0 + q, row0 + q + 9).
__device__ __forceinline__ void stage_async(float* win, const float* x,
                                            long long row0, int q) {
  const float* src = x + (row0 + q) * kLanes;
  for (int c = threadIdx.x; c < kWin / 4; c += kThreads) {
    cp_async16(win + 4 * c, src + 4 * c);
  }
  cp_async_commit();
}

// Add the plan entries [k0, k1) of one q-group, read from its staged window.
__device__ __forceinline__ void add_group(const Plan& p, int k0, int k1,
                                          const float* win,
                                          const __nv_bfloat16* __restrict__ data,
                                          long long n_out, long long base,
                                          float (&acc)[kOut]) {
  for (int k = k0; k < k1; ++k) {
    const int r = p.shift[k] & (kLanes - 1);
    const __nv_bfloat16* dk = data + p.diag[k] * n_out + base;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o = threadIdx.x + j * kThreads;
      const float term = mul_rn(widen(dk[o]), win[o + r]);
      acc[j] = k == 0 ? term : add_rn(acc[j], term);
    }
  }
}

// grouped (kAsync false: plain loads, one slot) and shear (kAsync true:
// cp.async into two slots): a block computes one piece of kPieceRows rows.
template <bool kAsync>
__global__ void __launch_bounds__(kThreads)
window_staged_kernel(const float* __restrict__ x,
                     const __nv_bfloat16* __restrict__ data,
                     float* __restrict__ y, const int* __restrict__ plan, int nd,
                     long long n_out) {
  __shared__ Plan p;
  __shared__ __align__(16) float win[kAsync ? 2 : 1][kWin];
  load_plan(plan, nd, p);
  const long long row0 = static_cast<long long>(blockIdx.x) * kPieceRows;
  const long long base = row0 * kLanes;
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.0f;
  if constexpr (kAsync) {
    stage_async(win[0], x, row0, p.g_q[0]);
    for (int g = 0; g < p.n_groups; ++g) {
      if (g + 1 < p.n_groups) {
        stage_async(win[(g + 1) & 1], x, row0, p.g_q[g + 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      add_group(p, p.g_begin[g], p.g_begin[g + 1], win[g & 1], data, n_out,
                base, acc);
      __syncthreads();  // slot g & 1 is refilled by the next iteration's copy
    }
  } else {
    for (int g = 0; g < p.n_groups; ++g) {
      const float* src = x + (row0 + p.g_q[g]) * kLanes;
      __syncthreads();
      for (int c = threadIdx.x; c < kWin; c += kThreads) win[0][c] = __ldg(src + c);
      __syncthreads();
      add_group(p, p.g_begin[g], p.g_begin[g + 1], win[0], data, n_out, base,
                acc);
    }
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) y[base + threadIdx.x + j * kThreads] = acc[j];
}

int launch(const void* x, const void* data, void* y, const int* plan, int nd,
           long long n_rows, int schedule, void* stream) {
  if (nd <= 0 || nd > kMaxDiags || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* db = static_cast<const __nv_bfloat16*>(data);
  auto* yf = static_cast<float*>(y);
  const long long n_out = n_rows * kLanes;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool staged = schedule == kGrouped || schedule == kShear;
  if (staged && n_rows % kPieceRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = staged ? n_rows / kPieceRows : (n_out + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(grid);
  switch (schedule) {
    case kDirect:
      window_direct_kernel<kDirect><<<g, kThreads, 0, st>>>(xf, db, yf, plan, nd, n_out);
      break;
    case kQfloor:
      window_direct_kernel<kQfloor><<<g, kThreads, 0, st>>>(xf, db, yf, plan, nd, n_out);
      break;
    case kFloor:
      window_direct_kernel<kFloor><<<g, kThreads, 0, st>>>(xf, db, yf, plan, nd, n_out);
      break;
    case kGrouped:
      window_staged_kernel<false><<<g, kThreads, 0, st>>>(xf, db, yf, plan, nd, n_out);
      break;
    case kShear:
      window_staged_kernel<true><<<g, kThreads, 0, st>>>(xf, db, yf, plan, nd, n_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// P1: schedule 0 direct, 1 grouped, 2 qfloor, 3 floor.
int sb_dia_window_f32(const void* x, const void* data, void* y, const void* plan,
                      int nd, long long n_rows, int schedule, void* stream) {
  if (schedule < kDirect || schedule > kFloor) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(x, data, y, static_cast<const int*>(plan), nd, n_rows, schedule,
                stream);
}

// P2: shear 0 the roll path (the direct schedule), 1 shear_chunk (cp.async).
int sb_dia_shear_f32(const void* x, const void* data, void* y, const void* plan,
                     int nd, long long n_rows, int shear, void* stream) {
  if (shear != 0 && shear != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, data, y, static_cast<const int*>(plan), nd, n_rows,
                shear ? kShear : kDirect, stream);
}

}  // extern "C"
