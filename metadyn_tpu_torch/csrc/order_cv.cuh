// Order-CV pair sweep over the cell-major slot layout (sentinel or validity
// layout, orthorhombic or tilted box): the per-CV pair math that kernels 2,
// 3 and 4 share, and the one-thread-per-slot traversal of kernels 2 and 4.
// Kernel 3 runs the same pair math on the block-per-cell traversal of
// cell_stage.cuh (packed_order.cu).
//
// Replaces, in metadyn_tpu/ops:
//   packed_order_pallas.py  order_values_pallas  (Vals)
//   packed_order_pallas.py  order_force_pallas   (Grad; packed_order.cu)
//   packed_fused_pallas.py  fused_lj_order_force (LJ + Vals + Grad,
//                                                 recurrence mode)
//
// Layout as in packed_lj_force.cu: positions (3, Npad) f32, slot = rank * C +
// cell; a cell's partners are the `cap` rows of each of its 27 neighbour
// cells, seen across a box face at x_j + h u (cell_geom.cuh: one shift per
// neighbour cell, exactly +-L per axis in an orthorhombic box).
//
// Design: one thread per i slot sweeps all 27 * cap partners, i side only.
// The TPU kernels halve the sweep (self cell weight 1, 13 cross offsets
// weight 2) and roll a j-side reaction back in an XLA pass.  Both halvings
// rest on parity: every per-pair value term is even in d (Q_l with even l by
// (-1)^l; coordination depends on r^2 alone), and the j-side reaction of a
// halved force sweep equals the i-side gradient seen from j.  So summing each
// ordered pair once with weight 1, i side only, gives the same values and
// forces with no atomics and no rollback buffer, deterministically, at twice
// the pair evaluations.
//
// Vacancy: an explicit weight, as packed_order_pallas._pair_geom applies it.
// In the sentinel layout (uniform sigma and epsilon) (x_i < VACANT_THR) &
// (x_j < VACANT_THR) & (r^2 > 1e-12).  In the validity layout (template flag
// Valid, per-slot se/hs) (pid_i < n_real) & (pid_j < n_real) & (r^2 >
// 1e-12), read from the int32 pids: there vacant slots are not parked at the
// sentinel (the pack leaves them at 0 and the integrator moves them), so a
// coordinate test would count them.  The r^2 tests alone, which the LJ
// kernel relies on, do not cull a vacant partner for a CV with no cut-off
// short of the stencil.  A vacant i slot writes zero force.
//
// CVs come as a small float descriptor in device memory, built by
// ops/packed_order_cuda.py: per CV a header of kHdr floats
//   [kind, l, val_off, aux_off, tab_off, rc2, r02, sc, scale]
// then the tables.  Q_l (kind 0) reads at tab_off the norms N_m (l + 1), the
// coefficients of p_lm = P_l^m / sin^m in cos(theta) (l - m + 1 per m) and
// those of their derivatives (max(l - m, 1) per m): the numbers of
// cv/steinhardt.py, uploaded once per CV.  Coordination (kind 1) uses r0^2
// and the stretch s -> (s - sc) * scale below rc2 (rc2 = inf, sc = 0, scale
// = 1 without a cut-off).  Value terms go to lanes val_off.., the bias
// coefficients (grad_aux, computed on the device each call) come from lanes
// aux_off.. of a device buffer: no host read per call.
//
// What bounds it on Hopper: the partner-coordinate reads from L1/L2 (27 * cap
// rows of 12 bytes per i slot; the (3, Npad) positions, 1.05 MB at Config 3,
// stay in the 50 MB L2).  The CV math runs only for the ~12 (Q6) and ~50
// (coordination) partners inside the CV cut-offs, so its run-time loops over
// m and the local-memory value accumulators cost little beside the sweep.
//
// Value sums: per-thread f32 accumulators, a warp-shuffle and shared-memory
// reduction per block into a (n_blocks, n_terms) partials buffer that every
// block writes in full, and a one-block second pass summing in double.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cell_geom.cuh"

namespace order_cv {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kVacantThr = 1.0e6f;  // ops/packed.py VACANT_THR
constexpr int kHdr = 9;
constexpr int kMaxCVs = 8;
constexpr int kMaxTerms = 64;  // value lanes over all CVs
constexpr int kMaxAux = 64;    // aux lanes over all CVs
constexpr int kMaxDesc = 1024; // descriptor floats
constexpr int kQl = 0;
constexpr int kCoord = 1;

struct Geom {
  int n_pad;
  int cap;
  int cx, cy, cz;
  int n_real;  // the validity layout's vacancy bound on pid
  cell_geom::HBox h;
};

struct LJParams {
  float rc2;   // r_cut^2
  float sig2;  // sigma^2
  float eps4;  // 4 * epsilon
};

// The arguments every entry point validates before a launch.  Returns 0 or
// cudaErrorInvalidValue.
inline int check_args(int n_cvs, int desc_len, int n_terms, int n_aux,
                      int n_pad) {
  if (n_cvs < 1 || n_cvs > kMaxCVs || desc_len < kHdr * n_cvs ||
      desc_len > kMaxDesc || n_terms < 0 || n_terms > kMaxTerms ||
      n_aux < 0 || n_aux > kMaxAux || n_pad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Horner in ascending-power coefficients c[0..n-1], from the top, as the
// reference evaluates them.
__device__ __forceinline__ float horner(const float* c, int n, float x) {
  float p = 0.0f;
  for (int i = n - 1; i >= 0; --i) p = p * x + c[i];
  return p;
}

// Q_l of one ordered pair (cv/packed_order.PackedSteinhardtQl.
// pair_value_and_grad): value terms (Re S_m, Im S_m, n_b) into vacc, and the
// closed-form gradient of phi(d) = sum_m N_m p_m(c) Re[(g_re - i g_im) u^m]
// into g.  r2 > 1e-12 is guaranteed by the caller.  L > 0 fixes l at
// compile time (the caller guarantees h[1] == L), so the m and Horner loops
// unroll; L = 0 reads l from the header.
template <bool Vals, bool Grad, int L = 0>
__device__ __forceinline__ void ql_pair(const float* h, const float* tab,
                                        const float* aux, float dx, float dy,
                                        float dz, float r2, float* vacc,
                                        float& gx, float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const int l = L > 0 ? L : static_cast<int>(h[1]);
  const int vo = static_cast<int>(h[2]);
  const float* norms = tab;
  const float* coef = tab + (l + 1);
  const float* dcoef = coef + (l + 1) * (l + 2) / 2;
  const float* gre = aux + static_cast<int>(h[3]);
  const float* gim = gre + (l + 1);
  const float inv_r = rsqrtf(r2);
  const float cth = dz * inv_r;
  const float ux = dx * inv_r;
  const float uy = dy * inv_r;
  float pr = 1.0f, pi = 0.0f;  // u^m
  float qr = 0.0f, qi = 0.0f;  // u^(m-1)
  float D = 0.0f, E = 0.0f, F = 0.0f, BU = 0.0f;
  int co = 0, dco = 0;
  for (int m = 0; m <= l; ++m) {
    const int nc = l - m + 1;
    const float pl = horner(coef + co, nc, cth);
    co += nc;
    if (Vals) {
      const float wn = norms[m] * pl;
      vacc[vo + m] += wn * pr;
      vacc[vo + l + 1 + m] += wn * pi;
    }
    if (Grad) {
      const int nd = nc > 1 ? nc - 1 : 1;
      const float dpl = horner(dcoef + dco, nd, cth);
      dco += nd;
      const float a_re = gre[m];
      const float a_im = gim[m];
      D += norms[m] * dpl * (a_re * pr + a_im * pi);
      if (m > 0) {
        const float br = m * (a_re * qr + a_im * qi);
        const float bi = m * (a_re * qi - a_im * qr);
        E += norms[m] * pl * br;
        F += norms[m] * pl * bi;
        BU += norms[m] * pl * (br * ux - bi * uy);
      }
    }
    qr = pr;
    qi = pi;
    const float npr = pr * ux - pi * uy;
    pi = pr * uy + pi * ux;
    pr = npr;
  }
  if (Vals) vacc[vo + 2 * (l + 1)] += 1.0f;
  if (Grad) {
    gx += (D * (-cth * ux) + E - ux * BU) * inv_r;
    gy += (D * (-cth * uy) - F - uy * BU) * inv_r;
    gz += (D * (1.0f - cth * cth) - cth * BU) * inv_r;
  }
}

// Coordination of one ordered pair (cv/packed_order.PackedCoordination):
// s = 1 / (1 + (r/r0)^6), stretched below the cut-off.
template <bool Vals, bool Grad>
__device__ __forceinline__ void coord_pair(const float* h, const float* aux,
                                           float dx, float dy, float dz,
                                           float r2, float* vacc, float& gx,
                                           float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const float r02 = h[6];
  const float t = r2 / r02;
  const float den = 1.0f + t * t * t;
  if (Vals) vacc[static_cast<int>(h[2])] += (1.0f / den - h[7]) * h[8];
  if (Grad) {
    const float dphi_dr2 = -3.0f * t * t / (r02 * (den * den)) * h[8];
    const float c = aux[static_cast<int>(h[3])] * 2.0f * dphi_dr2;
    gx += c * dx;
    gy += c * dy;
    gz += c * dz;
  }
}

// The traversal.  WithLJ adds the Lennard-Jones pair force (sentinel layout,
// forces only) into f; Vals accumulates value terms into partials (one row
// of n_terms per block); Grad writes the CV bias force into g.  Valid: the
// validity layout, vacancy from pid (otherwise from the coordinate
// sentinel; pid is then not read and may be null).
template <bool WithLJ, bool Vals, bool Grad, bool Valid>
__global__ void __launch_bounds__(kThreads)
order_sweep_kernel(const float* __restrict__ r, const int* __restrict__ pid,
                   const float* __restrict__ desc,
                   int desc_len, int n_cvs, int n_terms,
                   const float* __restrict__ aux, int n_aux, Geom p,
                   LJParams lj, float* __restrict__ f, float* __restrict__ g,
                   float* __restrict__ partials) {
  __shared__ float s_desc[kMaxDesc];
  __shared__ float s_aux[kMaxAux];
  for (int k = threadIdx.x; k < desc_len; k += kThreads) s_desc[k] = desc[k];
  if (Grad) {
    for (int k = threadIdx.x; k < n_aux; k += kThreads) s_aux[k] = aux[k];
  }
  __syncthreads();

  const int C = p.cx * p.cy * p.cz;
  const int n_pad = p.n_pad;
  const float* __restrict__ rx = r;
  const float* __restrict__ ry = r + n_pad;
  const float* __restrict__ rz = r + 2 * n_pad;
  const int s = blockIdx.x * kThreads + threadIdx.x;

  float vacc[kMaxTerms];
  if (Vals) {
    for (int t = 0; t < n_terms; ++t) vacc[t] = 0.0f;
  }
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (s < n_pad) {
    const float xi = rx[s];
    const float yi = ry[s];
    const float zi = rz[s];
    if (Valid ? pid[s] < p.n_real : xi < kVacantThr) {
      const int cell = s % C;
      const int iz = cell % p.cz;
      const int iy = (cell / p.cz) % p.cy;
      const int ix = cell / (p.cy * p.cz);
      for (int ox = -1; ox <= 1; ++ox) {
        for (int oy = -1; oy <= 1; ++oy) {
          for (int oz = -1; oz <= 1; ++oz) {
            float3 sh;
            const int jcell = cell_geom::neighbour_cell(
                ix, iy, iz, ox, oy, oz, p.cx, p.cy, p.cz, p.h, &sh);
            for (int k = 0; k < p.cap; ++k) {
              const int j = k * C + jcell;
              const float xj = rx[j];
              // vacant partner
              if (Valid ? !(pid[j] < p.n_real) : !(xj < kVacantThr)) continue;
              const float dx = xi - (xj + sh.x);
              const float dy = yi - (ry[j] + sh.y);
              const float dz = zi - (rz[j] + sh.z);
              const float r2 = dx * dx + dy * dy + dz * dz;
              if (!(r2 > 1.0e-12f)) continue;  // the slot itself
              if (WithLJ && r2 < lj.rc2) {
                const float inv = 1.0f / r2;
                const float s2 = lj.sig2 * inv;
                const float s6 = s2 * s2 * s2;
                const float coef = lj.eps4 * (12.0f * s6 * s6 - 6.0f * s6) * inv;
                fx += coef * dx;
                fy += coef * dy;
                fz += coef * dz;
              }
              for (int c = 0; c < n_cvs; ++c) {
                const float* h = s_desc + c * kHdr;
                if (static_cast<int>(h[0]) == kQl) {
                  ql_pair<Vals, Grad>(h, s_desc + static_cast<int>(h[4]),
                                      s_aux, dx, dy, dz, r2, vacc, gx, gy, gz);
                } else {
                  coord_pair<Vals, Grad>(h, s_aux, dx, dy, dz, r2, vacc, gx,
                                         gy, gz);
                }
              }
            }
          }
        }
      }
    }
    if (WithLJ) {
      f[s] = fx;
      f[n_pad + s] = fy;
      f[2 * n_pad + s] = fz;
    }
    if (Grad) {
      g[s] = gx;
      g[n_pad + s] = gy;
      g[2 * n_pad + s] = gz;
    }
  }

  if (Vals) {
    // warp shuffle, then the kWarps warp sums in a fixed order
    __shared__ float sh[kWarps][kMaxTerms];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int t = 0; t < n_terms; ++t) {
      float v = vacc[t];
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) sh[warp][t] = v;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n_terms; t += kThreads) {
      float acc = 0.0f;
      for (int w = 0; w < kWarps; ++w) acc += sh[w][t];
      partials[blockIdx.x * n_terms + t] = acc;
    }
  }
}

// One block: out[t] = sum_b partials[b, t], in double, blocks in order.
__global__ void __launch_bounds__(kThreads)
reduce_terms_kernel(const float* __restrict__ partials, int n_blocks,
                    int n_terms, float* __restrict__ out) {
  for (int t = threadIdx.x; t < n_terms; t += kThreads) {
    double acc = 0.0;
    for (int b = 0; b < n_blocks; ++b) acc += partials[b * n_terms + t];
    out[t] = static_cast<float>(acc);
  }
}

inline int n_blocks_for(int n_pad) { return (n_pad + kThreads - 1) / kThreads; }

}  // namespace order_cv
