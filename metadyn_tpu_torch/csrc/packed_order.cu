// Order-CV value and bias-force sweeps over the cell-major slot layout
// (sentinel or validity layout, orthorhombic or tilted box): the
// hand-written Hopper counterparts of metadyn_tpu/ops/packed_order_pallas.py
// order_values_pallas (kernel 2, with its cell_mask) and order_force_pallas
// (kernel 3).
//
// Both run order_cv.cuh's block-per-cell kernel over the rows of the 27
// neighbour cells staged in shared memory (cell_stage.cuh), prefiltered to
// the CVs' reach: one block per cell, its warps over the cell's real i rows.
// The force kernel flushes its hit queue per i row and writes g per row; the
// values kernel keeps one queue across a warp's rows, sums per lane and
// writes one partials row per cell, times the cell's weight where a cell
// mask is given (the spatial decomposition's), summed in double by a
// second pass.  Pair math, descriptor format, prefilter and the parity
// argument for summing each ordered pair once on the i side: order_cv.cuh.
//
// Vacant i slots get zero force.  No atomics: two calls give the same bits.

#include "order_cv.cuh"

using namespace order_cv;

extern "C" {

// Value sums of every CV of the descriptor, one block per cell.  r: (3,
// n_pad) f32; pid: (n_pad,) i32 for the validity layout (vacant where pid >=
// n_real), or null for the sentinel layout (n_real is then not read); desc:
// desc_len f32 (order_cv.cuh); partials: (cx cy cz, n_terms) f32 scratch;
// out: (n_terms,) f32.  box: (kBoxRow,) f32 in device memory, the box's
// geometry row (cell_geom.cuh BoxRow: the cell matrix, zero tilt for an
// orthorhombic box; the perpendicular widths and their sum).  cv_set: 1 if
// every CV is a Q_l, 2 if every CV is a coordination, 3 if mixed; l_fixed: 6
// if every Q_l CV has l = 6, else 0; lanes: 1 for the CV list [Q6], 2 for
// [Q6, coordination], else 0; rc2_max: the largest CV cut-off squared (inf
// if a CV has none); pre_rc, margin: the prefilter radius is pre_rc +
// margin * (the sum of the box's widths; pre_rc inf: no prefilter);
// cell_mask: (cx cy cz,) f32
// weights of each cell's value sums, or null.  Launches on `stream` and
// returns
// 0, a refused argument (cudaErrorInvalidValue), -2 when cap does not fit a
// block's shared memory, or a CUDA error.
int packed_order_values(const float* r, const int* pid, int n_real,
                        const float* desc, int desc_len, int n_cvs,
                        int n_terms, float* partials, float* out, int n_pad,
                        int cap, int cx, int cy, int cz, const float* box,
                        int cv_set, int l_fixed, int lanes, float rc2_max,
                        float pre_rc, float margin, const float* cell_mask,
                        void* stream) {
  const int bad = check_args(n_cvs, desc_len, n_terms, 0, n_pad);
  if (bad) return bad;
  const StagedArgs a{
      r, pid, desc, desc_len, n_cvs, n_terms, nullptr, 0,
      StagedParams{{n_pad, cap, cx, cy, cz, box}, n_real, rc2_max, 0.0f,
                   0.0f, 0.0f, pre_rc, margin},
      nullptr, nullptr, partials, out, cell_mask};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      pid != nullptr
          ? launch_staged_set<false, true, false, true>(cv_set, l_fixed,
                                                        lanes, a, st)
          : launch_staged_set<false, true, false, false>(cv_set, l_fixed,
                                                         lanes, a, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Bias force g = sum_cv sum_j grad_cv(d_ij; aux) onto every slot i (0 on
// vacant slots), one block per cell.  pid, the box, cv_set, l_fixed,
// rc2_max, pre_rc and margin as packed_order_values; aux: n_aux f32 on
// the device (the CVs' grad_aux lanes); g: (3, n_pad) f32 out.  Returns as
// packed_order_values.
int packed_order_force(const float* r, const int* pid, int n_real,
                       const float* desc, int desc_len, int n_cvs,
                       const float* aux, int n_aux, float* g, int n_pad,
                       int cap, int cx, int cy, int cz, const float* box,
                       int cv_set, int l_fixed, float rc2_max, float pre_rc,
                       float margin, void* stream) {
  const int bad = check_args(n_cvs, desc_len, 0, n_aux, n_pad);
  if (bad) return bad;
  const StagedArgs a{
      r, pid, desc, desc_len, n_cvs, 0, aux, n_aux,
      StagedParams{{n_pad, cap, cx, cy, cz, box}, n_real, rc2_max, 0.0f,
                   0.0f, 0.0f, pre_rc, margin},
      nullptr, g, nullptr, nullptr, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      pid != nullptr
          ? launch_staged_set<false, false, true, true>(cv_set, l_fixed,
                                                        kLanesAny, a, st)
          : launch_staged_set<false, false, true, false>(cv_set, l_fixed,
                                                         kLanesAny, a, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
