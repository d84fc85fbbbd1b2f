// The parts subsets of the fused LJ + order-CV sweep (kernel 4) in its
// monomial mode: the hand-written Hopper counterpart of
// metadyn_tpu/ops/packed_fused_pallas.py fused_lj_order_force with parts a
// proper subset of {lj, vals, force} and mono=True (packed_fused_pallas.py:
// 75, 143-229), with the cell mask of the value sums.  The design and the
// bounds: fused_parts.cuh; the recurrence mode's library:
// packed_fused_parts.cu.

#include "fused_parts.cuh"

extern "C" {

// The parts subsets in the monomial mode (mono != 0): fused_parts::run<true>
// (fused_parts.cuh), whose comment gives the arguments.
int packed_fused_parts_mono(int parts, const float* r, const float* desc, int desc_len,
    int n_cvs, int n_terms, const float* aux, int n_aux, float* f, float* g,
    float* partials, float* out, int n_pad, int cap, int cx, int cy, int cz,
    const float* box, float rc2, float sig2, float eps4, int cv_set,
    int l_fixed, int lanes, float rc2_hit, float pre_rc, float margin,
    int mono, int n_bvec, const float* cell_mask, void* stream) {
  return fused_parts::run<true>(
      parts, r, desc, desc_len, n_cvs, n_terms, aux, n_aux, f, g, partials,
      out, n_pad, cap, cx, cy, cz, box, rc2, sig2, eps4, cv_set, l_fixed,
      lanes, rc2_hit, pre_rc, margin, mono, n_bvec, cell_mask, stream);
}

}  // extern "C"
