// Order-CV value and bias-force sweeps over the cell-major slot layout
// (sentinel or validity layout, orthorhombic or tilted box): the
// hand-written Hopper counterparts of metadyn_tpu/ops/packed_order_pallas.py
// order_values_pallas (kernel 2) and order_force_pallas (kernel 3).  The
// per-CV pair math, the descriptor format and the parity argument for
// summing each ordered pair once on the i side are in order_cv.cuh.
//
// Kernel 2 (values) runs the one-thread-per-slot traversal of order_cv.cuh.
//
// Kernel 3 (bias force) runs the block-per-cell traversal of
// cell_stage.cuh: one block per cell stages the real rows of its 27
// neighbour cells in shared memory (vacancy from the coordinate sentinel,
// or from pid < n_real in the validity layout), then one warp per real i
// row queues the staged rows inside the largest CV cut-off and runs the CV
// gradient math on the queue 32 at a time.  What bounds it on Hopper: the CV math of the in-cut pairs
// (~12 per slot for Q6 at r_cut 1.49, ~300 FP32 operations each) and the
// candidate tests; the inputs stay in L2.
//
// Staging prefilter: a row is staged only if it can lie within the largest
// cut-off of some i row of the cell.  The block first takes the box of its
// real i rows in fractional coordinates, [lo, hi] per lattice axis; a row
// at fractional f lies at least g_d w_d from every point of that box, with
// g_d = max(lo_d - f_d, f_d - hi_d, 0) and w_d the box's perpendicular
// width along axis d (core/box.perpendicular_widths), since the planes of
// constant f_d are w_d apart per unit of f_d.  A row is kept when
// max_d g_d w_d < R, in any box, tilted or not; R is the largest cut-off
// plus a margin far above the f32 rounding of the test
// (ops/packed_order_cuda.py prefilter_radius).  A CV without a cut-off (rc2 = inf) turns the
// prefilter off.  ops/packed_order_cuda.prefilter_keep is the same rule in
// plain PyTorch, which the CPU tests check for dropped pairs.
//
// The per-CV dispatch is out of the pair loop: the kernel is a template on
// the set of CV kinds (Q_l only, coordination only, mixed) and on l where
// every Q_l CV has l = 6, so Q6's m and Horner loops unroll.
//
// Vacant i slots get zero force.  No atomics: two calls give the same bits.

#include <math.h>

#include "cell_stage.cuh"
#include "order_cv.cuh"

using namespace order_cv;

namespace {

constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kSetQl = 1;     // every CV a Q_l
constexpr int kSetCoord = 2;  // every CV a coordination
constexpr int kSetMixed = 3;

struct ForceParams {
  cell_stage::Grid g;
  int n_real;      // the validity layout's vacancy bound on pid
  float rc2_max;   // the largest CV cut-off squared (inf without one)
  float pre_r;     // the prefilter radius (inf: no prefilter)
  float wx, wy, wz;  // the box's perpendicular widths
};

template <bool Valid, int Kinds, int L>
__global__ void __launch_bounds__(kStageThreads)
order_force_staged_kernel(const float* __restrict__ r,
                          const int* __restrict__ pid,
                          const float* __restrict__ desc, int desc_len,
                          int n_cvs, const float* __restrict__ aux, int n_aux,
                          ForceParams p, float* __restrict__ g) {
  extern __shared__ float4 s_pos[];  // (27 cap): x, y, z with the shift
  __shared__ float s_desc[kMaxDesc];
  __shared__ float s_aux[kMaxAux];
  __shared__ float s_box[6];  // fractional lo (3) and hi (3) of the i rows
  const int cap = p.g.cap;
  const int n_pad = p.g.n_pad;
  const int C = p.g.cx * p.g.cy * p.g.cz;
  const int cell = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const cell_stage::Scratch sc = cell_stage::scratch_at(
      s_pos + cell_stage::kOffsets * cap, cap);
  for (int k = threadIdx.x; k < desc_len; k += kStageThreads) {
    s_desc[k] = desc[k];
  }
  for (int k = threadIdx.x; k < n_aux; k += kStageThreads) s_aux[k] = aux[k];

  auto real = [&](int j) -> bool {
    return Valid ? pid[j] < p.n_real : r[j] < kVacantThr;
  };
  const bool pre = isfinite(p.pre_r);
  if (pre && warp == 0) {
    // warp 0: the box of the cell's real rows
    float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
    for (int k = lane; k < cap; k += 32) {
      const int s = k * C + cell;
      if (real(s)) {
        const float3 fr = cell_stage::fractional(
            make_float3(r[s], r[n_pad + s], r[2 * n_pad + s]), p.g.h);
        b[0] = fminf(b[0], fr.x);
        b[1] = fminf(b[1], fr.y);
        b[2] = fminf(b[2], fr.z);
        b[3] = fmaxf(b[3], fr.x);
        b[4] = fmaxf(b[4], fr.y);
        b[5] = fmaxf(b[5], fr.z);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      for (int d = 0; d < 3; ++d) {
        b[d] = fminf(b[d], __shfl_xor_sync(cell_stage::kFull, b[d], off));
        b[3 + d] =
            fmaxf(b[3 + d], __shfl_xor_sync(cell_stage::kFull, b[3 + d], off));
      }
    }
    if (lane == 0) {
      for (int d = 0; d < 6; ++d) s_box[d] = b[d];
    }
  }
  __syncthreads();
  auto near = [&](float3 x) -> bool {
    const float3 fr = cell_stage::fractional(x, p.g.h);
    const float gx = fmaxf(fmaxf(s_box[0] - fr.x, fr.x - s_box[3]), 0.0f) * p.wx;
    const float gy = fmaxf(fmaxf(s_box[1] - fr.y, fr.y - s_box[4]), 0.0f) * p.wy;
    const float gz = fmaxf(fmaxf(s_box[2] - fr.z, fr.z - s_box[5]), 0.0f) * p.wz;
    return fmaxf(fmaxf(gx, gy), gz) < p.pre_r;
  };
  auto keep = [&](int o, int j, float3 x) -> bool {
    return real(j) && (o == cell_stage::kSelf || !pre || near(x));
  };
  auto store = [&](int q, int, float3 x) {
    s_pos[q] = make_float4(x.x, x.y, x.z, 0.0f);
  };
  const int n_rows = cell_stage::stage_neighbours(r, p.g, cell, sc, keep,
                                                  store);
  for (int k = threadIdx.x; k < cap; k += kStageThreads) {
    if (cell_stage::own_dropped(sc, cap, k)) {
      const int s = k * C + cell;
      g[s] = 0.0f;
      g[n_pad + s] = 0.0f;
      g[2 * n_pad + s] = 0.0f;
    }
  }

  const int i0 = sc.off[cell_stage::kSelf];
  const int n_i = sc.off[cell_stage::kSelf + 1] - i0;
  int* queue = sc.queue + warp * cell_stage::kQueue;
  for (int ii = warp; ii < n_i; ii += kStageWarps) {
    const float4 xi = s_pos[i0 + ii];
    auto geom = [&](int q, float* dx, float* dy, float* dz) -> float {
      const float4 xj = s_pos[q];
      *dx = xi.x - xj.x;
      *dy = xi.y - xj.y;
      *dz = xi.z - xj.z;
      return *dx * *dx + *dy * *dy + *dz * *dz;
    };
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    cell_stage::warp_sweep(
        n_rows, queue,
        [&](int q) {
          float dx, dy, dz;
          const float r2 = geom(q, &dx, &dy, &dz);
          return r2 > 1.0e-12f && r2 < p.rc2_max;  // not the slot itself
        },
        [&](int q) {
          float dx, dy, dz;
          const float r2 = geom(q, &dx, &dy, &dz);
          for (int c = 0; c < n_cvs; ++c) {
            const float* h = s_desc + c * kHdr;
            if (Kinds == kSetQl ||
                (Kinds == kSetMixed && static_cast<int>(h[0]) == kQl)) {
              ql_pair<false, true, L>(h, s_desc + static_cast<int>(h[4]),
                                      s_aux, dx, dy, dz, r2, nullptr, gx, gy,
                                      gz);
            } else {
              coord_pair<false, true>(h, s_aux, dx, dy, dz, r2, nullptr, gx,
                                      gy, gz);
            }
          }
        });
    gx = cell_stage::warp_sum(gx);
    gy = cell_stage::warp_sum(gy);
    gz = cell_stage::warp_sum(gz);
    if (lane == 0) {
      const int s = sc.islot[ii];
      g[s] = gx;
      g[n_pad + s] = gy;
      g[2 * n_pad + s] = gz;
    }
  }
}

struct ForceArgs {
  const float* r;
  const int* pid;
  const float* desc;
  int desc_len;
  int n_cvs;
  const float* aux;
  int n_aux;
  ForceParams p;
  float* g;
};

template <bool Valid, int Kinds, int L>
int launch_force(const ForceArgs& a, cudaStream_t st) {
  const int cap = a.p.g.cap;
  const size_t smem = sizeof(float4) * cell_stage::kOffsets * cap +
                      cell_stage::scratch_bytes(cap, kStageWarps);
  auto kernel = order_force_staged_kernel<Valid, Kinds, L>;
  // the static arrays (descriptor, aux, box) share the 227 KB with it
  const size_t static_bytes = sizeof(float) * (kMaxDesc + kMaxAux + 6);
  const int rc = cell_stage::request_smem(kernel, smem, static_bytes);
  if (rc != 0) return rc;
  kernel<<<a.p.g.cx * a.p.g.cy * a.p.g.cz, kStageThreads, smem, st>>>(
      a.r, a.pid, a.desc, a.desc_len, a.n_cvs, a.aux, a.n_aux, a.p, a.g);
  return 0;
}

template <bool Valid>
int launch_force_set(int cv_set, int l_fixed, const ForceArgs& a,
                     cudaStream_t st) {
  if (l_fixed != 0 && l_fixed != 6) return cudaErrorInvalidValue;
  switch (cv_set) {
    case kSetQl:
      return l_fixed ? launch_force<Valid, kSetQl, 6>(a, st)
                     : launch_force<Valid, kSetQl, 0>(a, st);
    case kSetCoord: return launch_force<Valid, kSetCoord, 0>(a, st);
    case kSetMixed:
      return l_fixed ? launch_force<Valid, kSetMixed, 6>(a, st)
                     : launch_force<Valid, kSetMixed, 0>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Threads per block of the values sweep: its partials buffer has
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
// vacant slots), one block per cell.  pid and the box as
// packed_order_values; aux: n_aux f32 on the device (the CVs' grad_aux
// lanes); g: (3, n_pad) f32 out.  cv_set: 1 if every CV is a Q_l, 2 if
// every CV is a coordination, 3 if mixed; l_fixed: 6 if every Q_l CV has
// l = 6, else 0; rc2_max: the largest CV cut-off squared (inf if a CV has
// none); pre_r: the prefilter radius (inf: no prefilter); wx, wy, wz: the
// box's perpendicular widths.  Returns 0, a refused argument
// (cudaErrorInvalidValue), -2 when cap does not fit a block's shared
// memory, or a CUDA error.
int packed_order_force(const float* r, const int* pid, int n_real,
                       const float* desc, int desc_len, int n_cvs,
                       const float* aux, int n_aux, float* g, int n_pad,
                       int cap, int cx, int cy, int cz, float Lx, float Ly,
                       float Lz, float xyLy, float xzLz, float yzLz,
                       int cv_set, int l_fixed, float rc2_max, float pre_r,
                       float wx, float wy, float wz, void* stream) {
  const int bad = check_args(n_cvs, desc_len, 0, n_aux, n_pad);
  if (bad) return bad;
  ForceArgs a{r, pid, desc, desc_len, n_cvs, aux, n_aux,
              ForceParams{{n_pad, cap, cx, cy, cz,
                           {Lx, Ly, Lz, xyLy, xzLz, yzLz}},
                          n_real, rc2_max, pre_r, wx, wy, wz},
              g};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = pid != nullptr
                     ? launch_force_set<true>(cv_set, l_fixed, a, st)
                     : launch_force_set<false>(cv_set, l_fixed, a, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
