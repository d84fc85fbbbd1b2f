// Cell-grid geometry shared by every sweep over the cell-major slot layout
// (packed_lj_force.cu, packed_lj_force_v1.cu, and through order_cv.cuh
// packed_order.cu and packed_fused_lj_order.cu).
//
// The box is the upper-triangular cell matrix h (HOOMD's tilt convention,
// core/box.py), passed as its six entries.  Cells are bins of fractional
// coordinates, so a neighbour cell that lies past a box face holds partners
// seen at x_j + h u, with u the integer wrap counts of the three axes.  The
// shift is formed in the order of the plain sweeps (ops/packed.py
// shift_rows_cart):
//   x: Lx ux + (xy Ly) uy + (xz Lz) uz,   y: Ly uy + (yz Lz) uz,   z: Lz uz.
// Each u is -1, 0 or 1, so every product is exact and the sums round as the
// plain version's do, with or without FMA contraction; with zero tilt the
// shift is exactly +-L per axis.

#pragma once

#include <cuda_runtime.h>

namespace cell_geom {

// The six entries of h as host floats (core/box.py Box.h_host): the
// diagonal, and the off-diagonal products xy*Ly, xz*Lz, yz*Lz rounded to
// f32 once on the host.
struct HBox {
  float Lx, Ly, Lz;
  float xyLy, xzLz, yzLz;
};

// Neighbour index along one axis, j = (i + o) mod c, with its wrap count
// u = floor((i + o) / c) in {-1, 0, 1}.
__device__ __forceinline__ int wrap_axis(int i, int o, int c, int* u) {
  int j = i + o;
  *u = 0;
  if (j < 0) {
    j += c;
    *u = -1;
  } else if (j >= c) {
    j -= c;
    *u = 1;
  }
  return j;
}

// The linear index (jx * cy + jy) * cz + jz of the neighbour cell at
// offset (ox, oy, oz) from cell (ix, iy, iz), and the Cartesian shift h u
// that its partners take.
__device__ __forceinline__ int neighbour_cell(int ix, int iy, int iz, int ox,
                                              int oy, int oz, int cx, int cy,
                                              int cz, const HBox& h,
                                              float3* shift) {
  int ux, uy, uz;
  const int jx = wrap_axis(ix, ox, cx, &ux);
  const int jy = wrap_axis(iy, oy, cy, &uy);
  const int jz = wrap_axis(iz, oz, cz, &uz);
  const float fx = static_cast<float>(ux);
  const float fy = static_cast<float>(uy);
  const float fz = static_cast<float>(uz);
  shift->x = h.Lx * fx + h.xyLy * fy + h.xzLz * fz;
  shift->y = h.Ly * fy + h.yzLz * fz;
  shift->z = h.Lz * fz;
  return (jx * cy + jy) * cz + jz;
}

}  // namespace cell_geom
