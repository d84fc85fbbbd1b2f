// Fused LJ + order-CV sweep over the cell-major slot layout (sentinel
// layout, orthorhombic or tilted box): the hand-written Hopper counterpart of
// metadyn_tpu/ops/packed_fused_pallas.py fused_lj_order_force (kernel 4) in
// its recurrence mode.  One traversal gives the LJ pair force, the order-CV
// bias force from the lagged bias coefficients, and the fresh value sums:
// the trailing force call of each multiple-time-stepping sub-chunk on the
// lagged path (sampler.make_stride_chunk).  Traversal, pair math and
// descriptor format: order_cv.cuh.

#include "order_cv.cuh"

using namespace order_cv;

extern "C" {

int packed_fused_lj_order_threads() { return kThreads; }

// r: (3, n_pad) f32; desc: desc_len f32; aux: n_aux f32 on the device;
// f, g: (3, n_pad) f32 out (LJ force, CV bias force; 0 on vacant slots);
// partials: (ceil(n_pad / threads), n_terms) f32 scratch; out: (n_terms,) f32
// value sums.  Lx..Lz and xyLy, xzLz, yzLz: the cell matrix (cell_geom.cuh
// HBox; zero tilt for an orthorhombic box).  rc2 = r_cut^2, sig2 = sigma^2,
// eps4 = 4 epsilon.  Launches on `stream` and returns 0, a refused argument
// (cudaErrorInvalidValue) or cudaGetLastError().
int packed_fused_lj_order(const float* r, const float* desc, int desc_len,
                          int n_cvs, int n_terms, const float* aux, int n_aux,
                          float* f, float* g, float* partials, float* out,
                          int n_pad, int cap, int cx, int cy, int cz, float Lx,
                          float Ly, float Lz, float xyLy, float xzLz,
                          float yzLz, float rc2, float sig2, float eps4,
                          void* stream) {
  const int bad = check_args(n_cvs, desc_len, n_terms, n_aux, n_pad);
  if (bad) return bad;
  Geom p{n_pad, cap, cx, cy, cz, 0, {Lx, Ly, Lz, xyLy, xzLz, yzLz}};
  LJParams lj{rc2, sig2, eps4};
  const int n_blocks = n_blocks_for(n_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  order_sweep_kernel<true, true, true, false><<<n_blocks, kThreads, 0, st>>>(
      r, nullptr, desc, desc_len, n_cvs, n_terms, aux, n_aux, p, lj, f, g,
      partials);
  reduce_terms_kernel<<<1, kThreads, 0, st>>>(partials, n_blocks, n_terms,
                                              out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
