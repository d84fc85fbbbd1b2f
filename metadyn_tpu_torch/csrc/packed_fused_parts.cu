// The parts subsets of the fused LJ + order-CV sweep (kernel 4): the
// hand-written Hopper counterpart of metadyn_tpu/ops/packed_fused_pallas.py
// fused_lj_order_force with parts a proper subset of {lj, vals, force}
// (_kernel's parts switch, packed_fused_pallas.py:75, 143-229), in its
// recurrence and its monomial mode, with the cell mask of the value sums.
// A timing mode with no production caller, as in the reference: it splits
// kernel 4's time among its parts.  The full set is kernel 4 itself
// (packed_fused_lj_order.cu); this library holds the other seven triples of
// order_cv.cuh's order_staged_kernel<WithLJ, Vals, Grad, ...>, so the
// production kernel's build and binary stay as they are.
//
// Every subset runs kernel 4's sweep (order_cv.cuh Split): the same
// staged rows, the prefilter radius the larger of the LJ cut-off and the
// largest CV cut-off whatever the subset computes (ops/packed_fused_cuda.py
// fused_reach), one hit queue per i row, and kernel 4's launch bounds (4
// blocks per SM, 64 registers a thread), so the subsets differ only in the
// math on the queued pairs and {} is the staging, the candidate tests and
// the queue alone.  The outputs a subset does not compute are not written
// here: the wrapper allocates them as zeros.
//
// What bounds each subset on Hopper: {} the staging (positions read once,
// in the 50 MB L2) and the candidate tests; with lj the LJ pairs inside
// r_cut (~60 per row at Config 3's density); with vals or force the CV math
// of the pairs inside each CV's cut-off (~12 for Q6, ~50 for coordination),
// the gradient about twice the values.  No atomics: two calls give the same
// bits.

#include "order_cv.cuh"

using namespace order_cv;

namespace {

constexpr int kLJ = 1;
constexpr int kVals = 2;
constexpr int kForce = 4;

template <bool WithLJ, bool Vals, bool Grad>
int launch_parts(int mono, int cv_set, int l_fixed, int lanes,
                 const StagedArgs& a, cudaStream_t st) {
  return mono ? launch_staged_set<WithLJ, Vals, Grad, false, true, true>(
                    cv_set, l_fixed, lanes, a, st)
              : launch_staged_set<WithLJ, Vals, Grad, false, false, true>(
                    cv_set, l_fixed, lanes, a, st);
}

}  // namespace

extern "C" {

// parts: a bit set of kLJ (1), kVals (2), kForce (4), below 7 (the full set
// is packed_fused_lj_order).  f is written with kLJ, g with kForce,
// partials and out with kVals; each may be null without its bit.  The other
// arguments as packed_fused_lj_order's (packed_fused_lj_order.cu).
// Launches on `stream` and returns 0, a refused argument
// (cudaErrorInvalidValue), -2 when cap does not fit a block's shared
// memory, or a CUDA error.
int packed_fused_parts(int parts, const float* r, const float* desc,
                       int desc_len, int n_cvs, int n_terms, const float* aux,
                       int n_aux, float* f, float* g, float* partials,
                       float* out, int n_pad, int cap, int cx, int cy, int cz,
                       const float* box, float rc2, float sig2, float eps4,
                       int cv_set, int l_fixed, int lanes, float rc2_hit,
                       float pre_rc, float margin, int mono,
                       const float* cell_mask, void* stream) {
  constexpr int bad_arg = static_cast<int>(cudaErrorInvalidValue);
  const int bad = check_args(n_cvs, desc_len, n_terms, n_aux, n_pad);
  if (bad) return bad;
  if (parts < 0 || parts >= (kLJ | kVals | kForce)) return bad_arg;
  if (((parts & kLJ) && !f) || ((parts & kForce) && !g) ||
      ((parts & kVals) && (!partials || !out))) {
    return bad_arg;
  }
  const StagedArgs a{
      r, nullptr, desc, desc_len, n_cvs, n_terms, aux, n_aux,
      StagedParams{{n_pad, cap, cx, cy, cz, box}, 0, rc2_hit, rc2, sig2,
                   eps4, pre_rc, margin},
      f, g, partials, out, cell_mask};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = bad_arg;
  switch (parts) {
    case 0:
      rc = launch_parts<false, false, false>(mono, cv_set, l_fixed, lanes, a,
                                             st);
      break;
    case kLJ:
      rc = launch_parts<true, false, false>(mono, cv_set, l_fixed, lanes, a,
                                            st);
      break;
    case kVals:
      rc = launch_parts<false, true, false>(mono, cv_set, l_fixed, lanes, a,
                                            st);
      break;
    case kLJ | kVals:
      rc = launch_parts<true, true, false>(mono, cv_set, l_fixed, lanes, a,
                                           st);
      break;
    case kForce:
      rc = launch_parts<false, false, true>(mono, cv_set, l_fixed, lanes, a,
                                            st);
      break;
    case kLJ | kForce:
      rc = launch_parts<true, false, true>(mono, cv_set, l_fixed, lanes, a,
                                           st);
      break;
    case kVals | kForce:
      rc = launch_parts<false, true, true>(mono, cv_set, l_fixed, lanes, a,
                                           st);
      break;
    default: break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
