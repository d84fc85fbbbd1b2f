// Order-CV value and bias-force sweeps over the cell-major slot layout
// (sentinel or validity layout, orthorhombic or tilted box): the
// hand-written Hopper counterparts of metadyn_tpu/ops/packed_order_pallas.py
// order_values_pallas (kernel 2) and order_force_pallas (kernel 3).  The
// traversal, the per-CV pair math, the descriptor format and the design
// notes are in order_cv.cuh.

#include "order_cv.cuh"

using namespace order_cv;

extern "C" {

// Threads per block of the sweep: the values partials buffer has
// ceil(n_pad / threads) rows of n_terms.
int packed_order_threads() { return kThreads; }

// Value sums of every CV of the descriptor.  r: (3, n_pad) f32; pid:
// (n_pad,) i32 for the validity layout (vacant where pid >= n_real), or null
// for the sentinel layout (n_real is then not read); desc: desc_len f32
// (order_cv.cuh); partials: (ceil(n_pad / threads), n_terms) f32 scratch;
// out: (n_terms,) f32.  Lx..Lz and xyLy, xzLz, yzLz: the cell matrix
// (cell_geom.cuh HBox; zero tilt for an orthorhombic box).  Launches on
// `stream` and returns 0, a refused argument (cudaErrorInvalidValue) or
// cudaGetLastError().
int packed_order_values(const float* r, const int* pid, int n_real,
                        const float* desc, int desc_len, int n_cvs,
                        int n_terms, float* partials, float* out, int n_pad,
                        int cap, int cx, int cy, int cz, float Lx, float Ly,
                        float Lz, float xyLy, float xzLz, float yzLz,
                        void* stream) {
  const int bad = check_args(n_cvs, desc_len, n_terms, 0, n_pad);
  if (bad) return bad;
  Geom p{n_pad, cap, cx, cy, cz, n_real, {Lx, Ly, Lz, xyLy, xzLz, yzLz}};
  LJParams lj{0.0f, 0.0f, 0.0f};
  const int n_blocks = n_blocks_for(n_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pid != nullptr) {
    order_sweep_kernel<false, true, false, true><<<n_blocks, kThreads, 0,
                                                   st>>>(
        r, pid, desc, desc_len, n_cvs, n_terms, nullptr, 0, p, lj, nullptr,
        nullptr, partials);
  } else {
    order_sweep_kernel<false, true, false, false><<<n_blocks, kThreads, 0,
                                                    st>>>(
        r, nullptr, desc, desc_len, n_cvs, n_terms, nullptr, 0, p, lj,
        nullptr, nullptr, partials);
  }
  reduce_terms_kernel<<<1, kThreads, 0, st>>>(partials, n_blocks, n_terms,
                                              out);
  return static_cast<int>(cudaGetLastError());
}

// Bias force g = sum_cv sum_j grad_cv(d_ij; aux) onto every slot i (0 on
// vacant slots).  pid and the box as packed_order_values; aux: n_aux f32 on
// the device (the CVs' grad_aux lanes); g: (3, n_pad) f32 out.
int packed_order_force(const float* r, const int* pid, int n_real,
                       const float* desc, int desc_len, int n_cvs,
                       const float* aux, int n_aux, float* g, int n_pad,
                       int cap, int cx, int cy, int cz, float Lx, float Ly,
                       float Lz, float xyLy, float xzLz, float yzLz,
                       void* stream) {
  const int bad = check_args(n_cvs, desc_len, 0, n_aux, n_pad);
  if (bad) return bad;
  Geom p{n_pad, cap, cx, cy, cz, n_real, {Lx, Ly, Lz, xyLy, xzLz, yzLz}};
  LJParams lj{0.0f, 0.0f, 0.0f};
  const int n_blocks = n_blocks_for(n_pad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pid != nullptr) {
    order_sweep_kernel<false, false, true, true><<<n_blocks, kThreads, 0,
                                                   st>>>(
        r, pid, desc, desc_len, n_cvs, 0, aux, n_aux, p, lj, nullptr, g,
        nullptr);
  } else {
    order_sweep_kernel<false, false, true, false><<<n_blocks, kThreads, 0,
                                                    st>>>(
        r, nullptr, desc, desc_len, n_cvs, 0, aux, n_aux, p, lj, nullptr, g,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
