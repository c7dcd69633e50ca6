// The matrix-free 27/7-point stencil apply at one grid point, shared by
// csrc/stencil.cu (K2, K3) and csrc/stencil_cg_vmem.cu (K5).
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
// version agree bit for bit.
//
// A Load functor gives the compute-type value of the operand at a flat
// index; K3 forms r + beta*p there, so the p-update of a neighbour is
// recomputed instead of read back.

#pragma once

#include "common.cuh"

namespace sb {

struct Grid3 {
  int nx, ny, nz;
  long long plane;  // nx * ny
  long long n;      // nx * ny * nz
};

template <typename C, typename Load>
__device__ __forceinline__ C sum_x(const Load& ld, long long i, int ix, int nx) {
  const C m = ix > 0 ? ld(i - 1) : C(0);
  const C c = ld(i);
  const C p = ix + 1 < nx ? ld(i + 1) : C(0);
  return add_rn(add_rn(m, c), p);
}

template <typename C, typename Load>
__device__ __forceinline__ C sum_yx(const Load& ld, long long i, int ix, int iy,
                                    const Grid3& g) {
  const C m = iy > 0 ? sum_x<C>(ld, i - g.nx, ix, g.nx) : C(0);
  const C c = sum_x<C>(ld, i, ix, g.nx);
  const C p = iy + 1 < g.ny ? sum_x<C>(ld, i + g.nx, ix, g.nx) : C(0);
  return add_rn(add_rn(m, c), p);
}

// y = (A v)[i]; *centre receives v[i] as ld gives it
template <typename C, typename Load>
__device__ __forceinline__ C apply_point(const Load& ld, long long i,
                                         const Grid3& g, bool use_7pt,
                                         C* centre) {
  const int ix = static_cast<int>(i % g.nx);
  const long long line = i / g.nx;
  const int iy = static_cast<int>(line % g.ny);
  const int iz = static_cast<int>(line / g.ny);
  const C c = ld(i);
  *centre = c;
  if (!use_7pt) {
    const C m = iz > 0 ? sum_yx<C>(ld, i - g.plane, ix, iy, g) : C(0);
    const C s = sum_yx<C>(ld, i, ix, iy, g);
    const C p = iz + 1 < g.nz ? sum_yx<C>(ld, i + g.plane, ix, iy, g) : C(0);
    return sub_rn(mul_rn(C(28), c), add_rn(add_rn(m, s), p));
  }
  const C sx = sum_x<C>(ld, i, ix, g.nx);
  const C sy = add_rn(add_rn(iy > 0 ? ld(i - g.nx) : C(0), c),
                      iy + 1 < g.ny ? ld(i + g.nx) : C(0));
  const C sz = add_rn(add_rn(iz > 0 ? ld(i - g.plane) : C(0), c),
                      iz + 1 < g.nz ? ld(i + g.plane) : C(0));
  return sub_rn(mul_rn(C(30), c), add_rn(add_rn(sx, sy), sz));
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
