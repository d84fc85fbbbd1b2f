// Cell-grid geometry shared by every sweep over the cell-major slot layout
// (packed_lj_force.cu, packed_lj_force_v1.cu, and through order_cv.cuh
// packed_order.cu and packed_fused_lj_order.cu).
//
// The box is the upper-triangular cell matrix h (HOOMD's tilt convention,
// core/box.py), read from device memory as its six entries (the first of a
// box's geometry row, core/box.py Box.geo: one row per box, one box per
// walker of a batch), so a box that the NPT barostat rescales on the device
// reaches every kernel without a host read.  Cells are bins of fractional
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

// The six entries of h: the diagonal, and the off-diagonal products xy*Ly,
// xz*Lz, yz*Lz rounded to f32 (core/box.py Box.h).
struct HBox {
  float Lx, Ly, Lz;
  float xyLy, xzLz, yzLz;
};

// A box's row of device geometry (core/box.py Box.geo, BOX_ROW floats): the
// cell matrix, then the perpendicular widths and their sum.
struct BoxRow {
  HBox h;
  float widths[3];
  float width_sum;
};
constexpr int kBoxRow = sizeof(BoxRow) / sizeof(float);
static_assert(kBoxRow == 10, "core/box.py BOX_ROW");

// The cell matrix of row w of the (n, kBoxRow) f32 geometry rows at `box`
// (device memory).
__device__ __forceinline__ HBox load_box(const float* __restrict__ box,
                                         int w) {
  const float* b = box + kBoxRow * w;
  return HBox{b[0], b[1], b[2], b[3], b[4], b[5]};
}

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
