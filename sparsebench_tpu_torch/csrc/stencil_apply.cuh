// The matrix-free 27/7-point stencil apply of csrc/stencil.cu (K2, K3) and
// csrc/stencil_cg_vmem.cu (K5): march forms a tile of points a plane at a
// time from planes staged in shared memory, so no point reads its
// neighbours from memory one load at a time.
//
// The generated matrix (reference src/matrix.c:30-121) is, with S_a the
// zero-boundary 3-point sum along axis a, (S_a v)[i] = v[i-1] + v[i] + v[i+1]:
//
//     27-point:  y = 28 v - Sz(Sy(Sx v))
//     7-point:   y = 30 v - ((Sx v + Sy v) + Sz v)
//
// Vectors are in the generator's natural row order, i = (iz*ny + iy)*nx + ix,
// with no padding: a neighbour outside the domain contributes 0, at every
// stage of the separable sum, exactly as the plain version's zero padding
// does (ops/stencil.py _sum3). Each 3-point sum is ((left + centre) + right)
// and every operation is rounded on its own, so a kernel and the plain
// version agree bit for bit: the march stages a 0 wherever the plain
// version pads, and a sum over a plane or row outside the domain is
// (0 + 0) + 0 = +0, the plain version's value there.
//
// A Stage functor gives what one staged value needs from memory and the
// compute-type value made from it; K3 and K5 form r + beta*p there, so the
// p-update of a neighbour is recomputed instead of read back.
//
// The march. A block of kThreads threads (8 warps) owns an (x, y) tile of
// kTileX = 32 columns (a warp's lanes) by 8 R rows (R rows a warp, one
// column and R consecutive rows a thread) over a run of tz planes. It walks
// the run's planes and the one on each side, z0 - 1 .. z0 + tz, and stages
// each plane once: the tile and a 1-point halo in x and y, (8 R + 2) x 34
// values at the compute width, into one of two shared buffers. From the
// staged plane a thread forms Sx of its R + 2 rows and Sy(Sx) of its R rows
// (27-point), or Sx + Sy at its R points (7-point), and keeps them with the
// centre values in registers; when plane k is staged, plane k - 1 has its
// three z-sums and is written out. The loads of the next two planes stay
// in flight in registers while the block sums, and with two buffers one
// barrier a plane suffices. A plane or row outside the domain is staged as
// zeros, so the edges need no other case. The caller names the tile: K2
// and K3 march the tile of their block index, K5's persistent blocks walk
// tiles b, b + G, b + 2G, ... The host-side plan (tile counts, runs, grid
// and shared bytes) is checked by march_shape_ok and march_plan_ok against
// what ops/stencil.py tile_plan (K5: ops/stencil_cg_vmem.py cg_plan)
// computes.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace sb {

struct Grid3 {
  int nx, ny, nz;
  long long plane;  // nx * ny
  long long n;      // nx * ny * nz
};

// -- the tiled plane march ---------------------------------------------------

constexpr int kMarchWarps = kThreads / 32;  // 8: one warp for R rows of a tile
constexpr int kTileX = 32;                  // a warp's lanes: one column each
constexpr int kStageX = kTileX + 2;         // a staged row: the tile and its halo

template <int R>
struct MarchShape {
  static constexpr int kTileY = kMarchWarps * R;
  static constexpr int kRows = kTileY + 2;                             // staged rows
  static constexpr int kBuffer = kRows * kStageX;                      // values a buffer
  static constexpr int kSlots = (kBuffer + kThreads - 1) / kThreads;  // values a thread stages
};

// Tile b of the plan: x tiles fastest, then y tiles, then runs of tz
// planes (ops/stencil.py block_origin).
struct MarchTile {
  int x0, y0, z0, z1;  // first column and row; planes [z0, z1)
};

__device__ __forceinline__ MarchTile march_tile(const Grid3& g, int b,
                                                int tile_y, int tz,
                                                int tiles_x, int tiles_y) {
  const int rest = b / tiles_x;
  MarchTile t;
  t.x0 = (b - rest * tiles_x) * kTileX;
  t.y0 = (rest % tiles_y) * tile_y;
  t.z0 = (rest / tiles_y) * tz;
  t.z1 = min(t.z0 + tz, g.nz);
  return t;
}

// Walks tile ``tile`` of the plan (march_tile) and calls out(i, y, c) for
// each of the thread's R points i inside the domain, y the apply at i and c
// the operand there. Stage gives Raw, what one staged value needs from
// memory, by load(flat index) and the compute-type value by make(raw).
// smem holds two buffers of MarchShape<R>::kBuffer values. Every thread of
// the block must call it; a caller that marches another tile with the same
// buffers puts a __syncthreads() between the two, since a thread's first
// plane of the next tile may overwrite a buffer that another thread still
// reads.
//
// Thread t stages values t + 256 s of a buffer (row e / 34, column e % 34
// of the tile and its halo), so a warp's loads cover one or two runs of a
// row. Two register sets hold the loads of the next two planes: plane k is
// put into its buffer while k + 1 is in flight, and k + 2 is issued before
// plane k's sums, so every thread keeps two planes of loads in flight.
template <typename C, int R, bool kSeven, typename Stage, typename Out>
__device__ __forceinline__ void march(const Stage& st, const Grid3& g, int tz,
                                      int tiles_x, int tiles_y, int tile,
                                      C* smem, Out& out) {
  using Shape = MarchShape<R>;
  using Raw = typename Stage::Raw;
  using Set = Raw[Shape::kSlots];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const MarchTile t = march_tile(g, tile, Shape::kTileY, tz, tiles_x, tiles_y);
  // each staged value's offset in a plane, and whether it lies in the
  // domain's (x, y) range (bit s); a plane holds fewer than 2^31 values
  // (march_plan_ok)
  int off[Shape::kSlots];
  unsigned in_xy = 0;
#pragma unroll
  for (int s = 0; s < Shape::kSlots; ++s) {
    const int e = threadIdx.x + kThreads * s;
    const int lr = e / kStageX;
    const int ix = t.x0 - 1 + (e - lr * kStageX);
    const int iy = t.y0 - 1 + lr;
    off[s] = iy * g.nx + ix;
    if (e < Shape::kBuffer && iy >= 0 && iy < g.ny && ix >= 0 && ix < g.nx)
      in_xy |= 1u << s;
  }
  auto fetch = [&](Set& raw, int k) {
    if (k < 0 || k >= g.nz) return;  // uniform; put stages zeros there
    const long long plane = static_cast<long long>(k) * g.plane;
#pragma unroll
    for (int s = 0; s < Shape::kSlots; ++s)
      if (in_xy >> s & 1u) raw[s] = st.load(plane + off[s]);
  };
  auto put = [&](const Set& raw, int k, C* buf) {
    const bool in_z = k >= 0 && k < g.nz;
#pragma unroll
    for (int s = 0; s < Shape::kSlots; ++s) {
      const int e = threadIdx.x + kThreads * s;
      if (e < Shape::kBuffer) buf[e] = in_z && (in_xy >> s & 1u) ? st.make(raw[s]) : C(0);
    }
  };

  // registers of the planes behind the one being staged: 27-point, the
  // Sy(Sx) sums of planes k-2 and k-1; 7-point, the operand at k-2 and the
  // Sx + Sy sums at k-1; both, the operand at k-1
  C back2[R], back1[R], cen1[R];
#pragma unroll
  for (int j = 0; j < R; ++j) back2[j] = back1[j] = cen1[j] = C(0);
  const int ix = t.x0 + lane;
  const int iy0 = t.y0 + warp * R;  // the thread's first row
  // stage plane k from raw, issue plane k + 2 into raw, form plane k's sums
  // and write plane k - 1
  auto step = [&](Set& raw, int k, C* buf) {
    put(raw, k, buf);
    __syncthreads();
    if (k + 2 <= t.z1) fetch(raw, k + 2);
    const C* base = buf + (warp * R) * kStageX + lane;  // the thread's first staged row, left
    C sum[R], cen[R];
    if constexpr (!kSeven) {
      C sx[R + 2];
#pragma unroll
      for (int j = 0; j < R + 2; ++j) {
        const C* v = base + j * kStageX;
        sx[j] = add_rn(add_rn(v[0], v[1]), v[2]);
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sum[j] = add_rn(add_rn(sx[j], sx[j + 1]), sx[j + 2]);
        cen[j] = base[(j + 1) * kStageX + 1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const C* v = base + (j + 1) * kStageX + 1;
        cen[j] = v[0];
        const C sx = add_rn(add_rn(v[-1], v[0]), v[1]);
        const C sy = add_rn(add_rn(v[-kStageX], v[0]), v[kStageX]);
        sum[j] = add_rn(sx, sy);
      }
    }
    if (k > t.z0) {  // plane k - 1 has all its z-neighbours
      const long long plane0 = static_cast<long long>(k - 1) * g.ny;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int iy = iy0 + j;
        if (ix >= g.nx || iy >= g.ny) continue;
        C y;
        if constexpr (!kSeven) {
          y = sub_rn(mul_rn(C(28), cen1[j]), add_rn(add_rn(back2[j], back1[j]), sum[j]));
        } else {
          const C sz = add_rn(add_rn(back2[j], cen1[j]), cen[j]);
          y = sub_rn(mul_rn(C(30), cen1[j]), add_rn(back1[j], sz));
        }
        out((plane0 + iy) * g.nx + ix, y, cen1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      back2[j] = kSeven ? cen1[j] : back1[j];
      back1[j] = sum[j];
      cen1[j] = cen[j];
    }
  };

  Set even, odd;  // the planes z0 - 1 + 2 m and z0 + 2 m
#pragma unroll
  for (int s = 0; s < Shape::kSlots; ++s) even[s] = odd[s] = Raw{};
  fetch(even, t.z0 - 1);
  fetch(odd, t.z0);
  for (int k = t.z0 - 1; k <= t.z1; k += 2) {
    step(even, k, smem);
    if (k + 1 <= t.z1) step(odd, k + 1, smem + Shape::kBuffer);
  }
}

// The march's shape on the grid, as the host plans it: R one of 1, 2, 4,
// 8; tz >= 1; the shared bytes of two staged planes; at most 2^31 - 1
// tiles and a plane of fewer than 2^31 values (the march's int offsets).
// Fills the tile counts.
template <typename C>
inline bool march_shape_ok(const Grid3& g, int r, int tz, long long smem,
                           int* tiles_x, int* tiles_y, long long* tiles) {
  if (r != 1 && r != 2 && r != 4 && r != 8) return false;
  if (tz < 1) return false;
  const long long tile_y = static_cast<long long>(kMarchWarps) * r;
  const long long tx = (g.nx + kTileX - 1) / kTileX;
  const long long ty = (g.ny + tile_y - 1) / tile_y;
  const long long runs = (g.nz + tz - 1) / tz;
  const long long bytes = 2 * (tile_y + 2) * kStageX * static_cast<long long>(sizeof(C));
  if (tx * ty * runs > 0x7fffffffLL || smem != bytes) return false;
  if ((static_cast<long long>(g.ny) + 2) * g.nx >= 0x7fffffffLL) return false;  // int offsets
  *tiles_x = static_cast<int>(tx);
  *tiles_y = static_cast<int>(ty);
  *tiles = tx * ty * runs;
  return true;
}

// The plan of K2 and K3 (ops/stencil.py tile_plan): the march's shape and a
// grid of one block a tile.
template <typename C>
inline bool march_plan_ok(const Grid3& g, int r, int tz, long long grid,
                          long long smem, int* tiles_x, int* tiles_y) {
  long long tiles = 0;
  return march_shape_ok<C>(g, r, tz, smem, tiles_x, tiles_y, &tiles) &&
         grid == tiles;
}

// Calls launch(integral_constant<int, R>, bool_constant<7-point>) for the
// plan's R, which march_shape_ok has checked is one the kernels are built
// for.
template <int R, typename Launch>
bool with_r(int r, bool use_7pt, Launch&& launch) {
  if (r != R) return false;
  if (use_7pt) {
    launch(std::integral_constant<int, R>{}, std::true_type{});
  } else {
    launch(std::integral_constant<int, R>{}, std::false_type{});
  }
  return true;
}

template <typename Launch>
void dispatch(int r, bool use_7pt, Launch&& launch) {
  with_r<1>(r, use_7pt, launch) || with_r<2>(r, use_7pt, launch) ||
      with_r<4>(r, use_7pt, launch) || with_r<8>(r, use_7pt, launch);
}

inline Grid3 make_grid(int nx, int ny, int nz) {
  Grid3 g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  g.plane = static_cast<long long>(nx) * ny;
  g.n = g.plane * nz;
  return g;
}

}  // namespace sb
