// Fused LJ + order-CV sweep over the cell-major slot layout (sentinel
// layout, orthorhombic or tilted box): the hand-written Hopper counterpart of
// metadyn_tpu/ops/packed_fused_pallas.py fused_lj_order_force (kernel 4) in
// its recurrence mode and its monomial mode (mono, Q_l in the monomial basis
// of cv/ylm_mono.py; order_cv.cuh), with the cell mask of the value sums
// (the spatial decomposition's).  One traversal gives the LJ pair force,
// the order-CV bias force from the lagged bias coefficients, and the fresh
// value sums: the trailing force call of each multiple-time-stepping
// sub-chunk on the lagged path (sampler.make_stride_chunk), on one grid or
// on each shard's halo-extended grid (parallel/spatial.py).
//
// It runs order_cv.cuh's block-per-cell kernel: one staging of the 27
// neighbour cells' real rows, prefiltered to the larger of the LJ cut-off
// and the largest CV cut-off, serves both the LJ rows and the CV rows; one
// warp per real i row queues the staged rows inside that radius and runs
// the LJ force (inside r_cut, forces only, uniform sigma and epsilon, as
// the reference's kernel) and the CV value and gradient math on them, 32 at
// a time.  f and g are written per i row (0 on vacant slots); the value
// sums per lane go to one partials row per cell and a second pass in
// double.  Pair math, descriptor format and prefilter: order_cv.cuh.
//
// What bounds it on Hopper: the CV math of the in-cut pairs and the
// candidate tests (~60 LJ partners per row at Config 3's density, ~50 of
// them inside the coordination cut-off, ~12 inside Q6's); the inputs stay in
// the 50 MB L2.  No atomics: two calls give the same bits.

#include "order_cv.cuh"

using namespace order_cv;

extern "C" {

// r: (3, n_pad) f32; desc: desc_len f32; aux: n_aux f32 on the device;
// f, g: (3, n_pad) f32 out (LJ force, CV bias force; 0 on vacant slots);
// partials: (cx cy cz, n_terms) f32 scratch; out: (n_terms,) f32 value
// sums.  box: (kBoxRow,) f32 in device memory, the box's geometry row
// (cell_geom.cuh BoxRow).  rc2 = r_cut^2, sig2 = sigma^2, eps4
// = 4 epsilon.  cv_set, l_fixed, lanes: the CV list's instantiation
// (packed_order.cu packed_order_values); rc2_hit: max(r_cut^2, the largest
// CV cut-off squared) (inf if a CV has none); pre_rc, margin: the
// prefilter radius is pre_rc + margin * (the sum of the box's perpendicular
// widths; pre_rc inf: no prefilter); mono: nonzero for the monomial mode
// (aux as in the recurrence; n_terms and partials the monomial sums'
// lanes, out the recurrence's value lanes, each Q_l's table the monomial
// one; order_cv.cuh); n_bvec: with mono, the floats of the Q_l's force
// vectors, 4 n_mono(l - 1) each (0 without mono); cell_mask: (cx cy cz,)
// f32 weights of each cell's value sums, or null.
// Launches on `stream` and returns 0, a refused argument
// (cudaErrorInvalidValue), -2 when cap does not fit a block's shared
// memory, or a CUDA error.
int packed_fused_lj_order(const float* r, const float* desc, int desc_len,
                          int n_cvs, int n_terms, const float* aux, int n_aux,
                          float* f, float* g, float* partials, float* out,
                          int n_pad, int cap, int cx, int cy, int cz,
                          const float* box, float rc2, float sig2, float eps4,
                          int cv_set, int l_fixed, int lanes, float rc2_hit,
                          float pre_rc, float margin, int mono, int n_bvec,
                          const float* cell_mask, void* stream) {
  const int bad = check_args(n_cvs, desc_len, n_terms, n_aux, n_pad);
  if (bad) return bad;
  const StagedArgs a{
      r, nullptr, desc, desc_len, n_cvs, n_terms, aux, n_aux,
      StagedParams{{n_pad, cap, cx, cy, cz, box}, 0, rc2_hit, rc2, sig2,
                   eps4, pre_rc, margin},
      f, g, partials, out, cell_mask, n_bvec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      mono ? launch_staged_set<true, true, true, false, true>(cv_set, l_fixed,
                                                              lanes, a, st)
           : launch_staged_set<true, true, true, false>(cv_set, l_fixed,
                                                        lanes, a, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
