// Order-CV sweeps over the cell-major slot layout (sentinel or validity
// layout, orthorhombic or tilted box): the per-CV pair math, the descriptor
// format and the block-per-cell kernel that kernels 2, 3 and 4 share.
//
// Replaces, in metadyn_tpu/ops:
//   packed_order_pallas.py  order_values_pallas  (Vals, cell_mask optional;
//                                                 packed_order.cu)
//   packed_order_pallas.py  order_force_pallas   (Grad; packed_order.cu)
//   packed_fused_pallas.py  fused_lj_order_force (LJ + Vals + Grad, the
//                                                 recurrence and the
//                                                 monomial mode, cell_mask
//                                                 optional;
//                                                 packed_fused_lj_order.cu)
//
// Layout as in packed_lj_force.cu: positions (3, Npad) f32, slot = rank * C +
// cell; a cell's partners are the `cap` rows of each of its 27 neighbour
// cells, seen across a box face at x_j + h u (cell_geom.cuh: one shift per
// neighbour cell, exactly +-L per axis in an orthorhombic box).
//
// Traversal (cell_stage.cuh): one block per cell stages the kept rows of its
// 27 neighbour cells in shared memory; the warps take the cell's real i rows
// and queue the staged rows inside the hit radius (the largest CV cut-off,
// or the LJ cut-off if larger), then run the pair math on the queue 32 at a
// time.  The kernels with a per-row output (the bias force g, the LJ force
// f) flush the queue at the end of each i row (warp_sweep); the values
// kernel, whose output is one sum over all pairs, keeps one queue across
// all the rows of a warp (warp_sweep_rows), so that Q6's ~12 hits per row
// still fill all 32 lanes.
//
// Keep rule of the staging: a real row (vacancy below), within reach of the
// cell.  The block first takes the box of its real i rows in fractional
// coordinates, [lo, hi] per lattice axis; a row at fractional f lies at
// least g_d w_d from every point of that box, with g_d = max(lo_d - f_d,
// f_d - hi_d, 0) and w_d the box's perpendicular width along axis d
// (core/box.perpendicular_widths), since the planes of constant f_d are w_d
// apart per unit of f_d.  A row is kept when max_d g_d w_d < R, in any box,
// tilted or not; R is the hit radius plus a margin far above the f32
// rounding of the test (ops/packed_order_cuda.py prefilter_radius).  A CV
// without a cut-off (rc2 = inf) turns the prefilter off.
// ops/packed_order_cuda.prefilter_keep is the same rule in plain PyTorch,
// which the CPU tests check for dropped pairs.
//
// Sums: the i side of every ordered pair with weight 1.  The TPU kernels
// halve the sweep (self cell weight 1, 13 cross offsets weight 2) and roll a
// j-side reaction back in an XLA pass.  Both halvings rest on parity: every
// per-pair value term is even in d (Q_l with even l by (-1)^l; coordination
// depends on r^2 alone), and the j-side reaction of a halved force sweep
// equals the i-side gradient seen from j.  So summing each ordered pair once
// with weight 1, i side only, gives the same values and forces with no
// atomics and no rollback buffer, deterministically, at twice the pair
// evaluations.
//
// Vacancy, read only while staging: in the sentinel layout (uniform sigma
// and epsilon) x < VACANT_THR; in the validity layout (per-slot se/hs) pid <
// n_real, read from the int32 pids: there vacant slots are not parked at the
// sentinel (the pack leaves them at 0 and the integrator moves them), so a
// coordinate test would count them.  r^2 > 1e-12 drops the slot itself.  A
// vacant i slot gets zero force.
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
// The per-CV dispatch is out of the pair loop: the kernel is a template on
// the set of CV kinds (Q_l only, coordination only, mixed), on l where every
// Q_l CV has l = 6, so Q6's m and Horner loops unroll, and on the value
// lanes: the CV lists [Q6] and [Q6, coordination] (the main paths') have
// their lane offsets at compile time, so the per-lane value sums live in
// registers; other lists index them at run time (local memory).
//
// What bounds it on Hopper: the CV math of the in-cut pairs (~12 per slot
// for Q6 at r_cut 1.37-1.49, ~300 FP32 operations each for the gradient,
// about half that for the values) and the candidate tests; the inputs stay
// in the 50 MB L2.
//
// Value sums: per-lane f32 sums, a shuffle tree per term in each warp, the
// warps in order into one row of a (cells, n_terms) partials buffer that
// every block writes in full, and a one-block second pass in double, one
// warp per term (reduce_terms_kernel).  Every sum runs in an order fixed
// for a given input: two calls give the same bits.
//
// Cell mask (the spatial decomposition's per-i-cell weight: 1 on a shard's
// interior cells, 0 on its ghost planes; metadyn_tpu/parallel/spatial.py):
// each block's partials row is multiplied by its cell's weight, so every
// ordered pair counts with the weight of its i cell, and the forces stay
// unmasked.  The TPU kernels halve the pairs and weight a cross-cell pair
// by its i cell with weight 2; summed over the shards both give the global
// value sums, each ordered pair on exactly one shard.
//
// Monomial mode (Mono; metadyn_tpu/cv/ylm_mono.py, the fused kernel's
// mono=True): Q_l with l = 6 in the homogeneous-monomial basis of the unit
// bond vector u.  Its value lanes hold sum mono_6(u) (28) and the bond
// count; its bias force per pair is g_a = b_a . mono_5(u) for a = x, y, z
// (three aux vectors of 21, from the CV's mono_force_vecs), projected off
// u and divided by r.  The monomials are built by degree halving in the
// reference's order (build_mono, cv/ylm_mono.py _split_plan), so every
// monomial is the same f32 product as the plain version's.  Coordination
// keeps its math.  l = 6 alone: its 63 + 1 aux lanes fill kMaxAux.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cell_geom.cuh"
#include "cell_stage.cuh"

namespace order_cv {

constexpr float kVacantThr = 1.0e6f;  // ops/packed.py VACANT_THR
constexpr int kHdr = 9;
constexpr int kMaxCVs = 8;
constexpr int kMaxTerms = 64;  // value lanes over all CVs
constexpr int kMaxAux = 64;    // aux lanes over all CVs
constexpr int kMaxDesc = 1024; // descriptor floats
constexpr int kQl = 0;
constexpr int kCoord = 1;
// the CV-kind sets (ops/packed_order_cuda.py CV_SET_*)
constexpr int kSetQl = 1;     // every CV a Q_l
constexpr int kSetCoord = 2;  // every CV a coordination
constexpr int kSetMixed = 3;
// the value-lane layouts (ops/packed_order_cuda.py LANES_*)
constexpr int kLanesAny = 0;      // offsets from the descriptor
constexpr int kLanesQ6 = 1;       // [Q6]: lanes 0..14
constexpr int kLanesQ6Coord = 2;  // [Q6, coordination]: 0..14, 15
constexpr int kQ6Terms = 15;      // Re (7), Im (7), bond count
constexpr int kQ6MonoTerms = 29;  // mono_6 sums (28), bond count

// Q6's value lanes in the recurrence (15) or the monomial mode (29).
template <bool Mono>
__host__ __device__ constexpr int q6_terms() {
  return Mono ? kQ6MonoTerms : kQ6Terms;
}

constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kReduceThreads = 512;

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
#pragma unroll
  for (int i = n - 1; i >= 0; --i) p = p * x + c[i];
  return p;
}

// Q_l of one ordered pair (cv/packed_order.PackedSteinhardtQl.
// pair_value_and_grad): value terms (Re S_m, Im S_m, n_b) into vacc, and the
// closed-form gradient of phi(d) = sum_m N_m p_m(c) Re[(g_re - i g_im) u^m]
// into g.  r2 > 1e-12 is guaranteed by the caller.  L > 0 fixes l at
// compile time (the caller guarantees h[1] == L), so the m and Horner loops
// unroll; L = 0 reads l from the header.  VO >= 0 fixes the value lane
// offset at compile time (the caller guarantees h[2] == VO); VO < 0 reads
// it from the header.
template <bool Vals, bool Grad, int L = 0, int VO = -1>
__device__ __forceinline__ void ql_pair(const float* h, const float* tab,
                                        const float* aux, float dx, float dy,
                                        float dz, float r2, float* vacc,
                                        float& gx, float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const int l = L > 0 ? L : static_cast<int>(h[1]);
  const int vo = VO >= 0 ? VO : static_cast<int>(h[2]);
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
#pragma unroll
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

// The number of homogeneous monomials of degree d, and the position of
// ux^i uy^j uz^(d-i-j) in cv/ylm_mono.py's mono_powers(d) order (i from d
// down to 0, then j from d - i down to 0).
__host__ __device__ constexpr int n_mono(int d) {
  return (d + 1) * (d + 2) / 2;
}
__host__ __device__ constexpr int mono_index(int d, int i, int j) {
  return (d - i) * (d - i + 1) / 2 + (d - i - j);
}

// The degree-D monomials from those of degree hi = D - D/2 (mh) and lo =
// D/2 (ml): each the product of the greedy split of its exponents, as
// cv/ylm_mono.py _split_plan plans it.  Both loops unroll, so every index
// is a constant and the arrays stay in registers.
template <int D>
__device__ __forceinline__ void build_mono(const float* mh, const float* ml,
                                           float* out) {
  constexpr int hi = D - D / 2;
  constexpr int lo = D / 2;
#pragma unroll
  for (int i = D; i >= 0; --i) {
#pragma unroll
    for (int j = D - i; j >= 0; --j) {
      const int i2 = i < hi ? i : hi;
      const int j2 = j < hi - i2 ? j : hi - i2;
      out[mono_index(D, i, j)] =
          mh[mono_index(hi, i2, j2)] * ml[mono_index(lo, i - i2, j - j2)];
    }
  }
}

// Q_6 of one ordered pair in the monomial mode (cv/packed_order.
// PackedSteinhardtQl pair_mono_sums and pair_mono_grad_terms): value lanes
// sum mono_6(u) and the bond count; gradient (g - u (u . g)) / r with g_a =
// b_a . mono_5(u), the b_a at aux lanes h[3] + 21 a.  VO as ql_pair.
template <bool Vals, bool Grad, int VO = -1>
__device__ __forceinline__ void ql_mono_pair(const float* h, const float* aux,
                                             float dx, float dy, float dz,
                                             float r2, float* vacc, float& gx,
                                             float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const float inv_r = rsqrtf(r2);
  const float m1[3] = {dx * inv_r, dy * inv_r, dz * inv_r};
  float m2[n_mono(2)], m3[n_mono(3)];
  build_mono<2>(m1, m1, m2);
  build_mono<3>(m2, m1, m3);
  if (Vals) {
    const int vo = VO >= 0 ? VO : static_cast<int>(h[2]);
    float m6[n_mono(6)];
    build_mono<6>(m3, m3, m6);
#pragma unroll
    for (int t = 0; t < n_mono(6); ++t) vacc[vo + t] += m6[t];
    vacc[vo + n_mono(6)] += 1.0f;
  }
  if (Grad) {
    float m5[n_mono(5)];
    build_mono<5>(m3, m2, m5);
    const float* b = aux + static_cast<int>(h[3]);
    float gux = 0.0f, guy = 0.0f, guz = 0.0f;
#pragma unroll
    for (int t = 0; t < n_mono(5); ++t) {
      gux += b[t] * m5[t];
      guy += b[n_mono(5) + t] * m5[t];
      guz += b[2 * n_mono(5) + t] * m5[t];
    }
    const float dot = m1[0] * gux + m1[1] * guy + m1[2] * guz;
    gx += (gux - m1[0] * dot) * inv_r;
    gy += (guy - m1[1] * dot) * inv_r;
    gz += (guz - m1[2] * dot) * inv_r;
  }
}

// Coordination of one ordered pair (cv/packed_order.PackedCoordination):
// s = 1 / (1 + (r/r0)^6), stretched below the cut-off.  VO as ql_pair.
template <bool Vals, bool Grad, int VO = -1>
__device__ __forceinline__ void coord_pair(const float* h, const float* aux,
                                           float dx, float dy, float dz,
                                           float r2, float* vacc, float& gx,
                                           float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const float r02 = h[6];
  const float t = r2 / r02;
  const float den = 1.0f + t * t * t;
  if (Vals) {
    vacc[VO >= 0 ? VO : static_cast<int>(h[2])] += (1.0f / den - h[7]) * h[8];
  }
  if (Grad) {
    const float dphi_dr2 = -3.0f * t * t / (r02 * (den * den)) * h[8];
    const float c = aux[static_cast<int>(h[3])] * 2.0f * dphi_dr2;
    gx += c * dx;
    gy += c * dy;
    gz += c * dz;
  }
}

// Every CV of the descriptor on one pair.  Kinds: kSet*; L: 6 or 0 (ql_pair);
// Lanes: kLanes* (with a fixed layout, Kinds and L are implied); Mono: Q_l
// in the monomial mode (L = 6).
template <bool Vals, bool Grad, int Kinds, int L, int Lanes, bool Mono>
__device__ __forceinline__ void cv_pair(const float* desc, int n_cvs,
                                        const float* aux, float dx, float dy,
                                        float dz, float r2, float* vacc,
                                        float& gx, float& gy, float& gz) {
  static_assert(!Mono || L == 6, "the monomial mode is Q_6's");
  if constexpr (Lanes != kLanesAny) {
    if constexpr (Mono) {
      ql_mono_pair<Vals, Grad, 0>(desc, aux, dx, dy, dz, r2, vacc, gx, gy,
                                  gz);
    } else {
      ql_pair<Vals, Grad, 6, 0>(desc, desc + static_cast<int>(desc[4]), aux,
                                dx, dy, dz, r2, vacc, gx, gy, gz);
    }
    if constexpr (Lanes == kLanesQ6Coord) {
      coord_pair<Vals, Grad, q6_terms<Mono>()>(desc + kHdr, aux, dx, dy, dz,
                                               r2, vacc, gx, gy, gz);
    }
  } else {
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = desc + c * kHdr;
      if (Kinds == kSetQl ||
          (Kinds == kSetMixed && static_cast<int>(h[0]) == kQl)) {
        if constexpr (Mono) {
          ql_mono_pair<Vals, Grad>(h, aux, dx, dy, dz, r2, vacc, gx, gy, gz);
        } else {
          ql_pair<Vals, Grad, L>(h, desc + static_cast<int>(h[4]), aux, dx,
                                 dy, dz, r2, vacc, gx, gy, gz);
        }
      } else {
        coord_pair<Vals, Grad>(h, aux, dx, dy, dz, r2, vacc, gx, gy, gz);
      }
    }
  }
}

// Value lanes a thread sums: the fixed layouts' count, else the limit.
template <int Lanes, bool Mono>
__host__ __device__ constexpr int lane_count() {
  return Lanes == kLanesQ6       ? q6_terms<Mono>()
         : Lanes == kLanesQ6Coord ? q6_terms<Mono>() + 1
                                  : kMaxTerms;
}

struct StagedParams {
  cell_stage::Grid g;
  int n_real;      // the validity layout's vacancy bound on pid
  float rc2_hit;   // the hit radius squared: max(LJ, largest CV cut-off)^2
  float rc2_lj;    // the LJ cut-off squared (WithLJ)
  float sig2;      // sigma^2 (WithLJ)
  float eps4;      // 4 epsilon (WithLJ)
  float pre_rc;    // the prefilter's base radius (inf: no prefilter)
  float margin;    // its margin per unit of the summed perpendicular widths
};

// The launch's box geometry (the cell matrix, the perpendicular widths and
// their sum): copied from device memory (StagedParams.g.box) by one
// device-to-device copy queued before each launch on its stream, so the
// kernel reads it as kernel parameters are read, from the constant bank (a
// register or shared-memory copy cost these kernels 3-14% of their device
// time).  One per library: each .cu file has its own.
__constant__ cell_geom::BoxRow c_geo;

// Static shared memory of order_staged_kernel, beside its dynamic rows.
constexpr size_t kStaticSmem =
    sizeof(float) * (kMaxDesc + kMaxAux + 6 + kStageWarps * kMaxTerms);

// Dynamic shared memory: the staged rows and cell_stage's scratch.
inline size_t staged_smem(int cap) {
  return sizeof(float4) * cell_stage::kOffsets * cap +
         cell_stage::scratch_bytes(cap, kStageWarps);
}

// The block-per-cell kernel.  WithLJ adds the Lennard-Jones pair force
// (sentinel layout, forces only, uniform sigma and epsilon) into f; Vals
// sums value terms into partials (one row of n_terms per cell, times the
// cell's weight in cell_mask where it is not null); Grad writes the CV bias
// force into g.  Valid: the validity layout, vacancy from pid (otherwise
// from the coordinate sentinel; pid is then not read and may be null).
// Mono: Q_l in the monomial mode.  With Vals alone, a warp keeps one hit
// queue across its rows.
// Blocks per SM each sweep keeps: the values and force sweeps 5 (48
// registers a thread), the fused sweep 4 (64).  Reading the box from
// constant memory (c_geo) took the values sweep to 54 registers, 4 blocks
// per SM and 9% of its time on Config 3's input, and a bound of 1 lets
// the compiler take more than 64.
template <bool WithLJ>
constexpr int min_blocks() {
  return WithLJ ? 4 : 5;
}

template <bool WithLJ, bool Vals, bool Grad, bool Valid, int Kinds, int L,
          int Lanes, bool Mono>
__global__ void __launch_bounds__(kStageThreads, min_blocks<WithLJ>())
order_staged_kernel(const float* __restrict__ r, const int* __restrict__ pid,
                    const float* __restrict__ desc, int desc_len, int n_cvs,
                    int n_terms, const float* __restrict__ aux, int n_aux,
                    StagedParams p, float* __restrict__ f,
                    float* __restrict__ g, float* __restrict__ partials,
                    const float* __restrict__ cell_mask) {
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
  if (Grad) {
    for (int k = threadIdx.x; k < n_aux; k += kStageThreads) s_aux[k] = aux[k];
  }

  auto real = [&](int j) -> bool {
    return Valid ? pid[j] < p.n_real : r[j] < kVacantThr;
  };
  const bool pre = isfinite(p.pre_rc);
  if (pre && warp == 0) {
    // warp 0: the box of the cell's real rows
    float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
    for (int k = lane; k < cap; k += 32) {
      const int s = k * C + cell;
      if (real(s)) {
        const float3 fr = cell_stage::fractional(
            make_float3(r[s], r[n_pad + s], r[2 * n_pad + s]), c_geo.h);
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
    const float3 fr = cell_stage::fractional(x, c_geo.h);
    const float gx =
        fmaxf(fmaxf(s_box[0] - fr.x, fr.x - s_box[3]), 0.0f) * c_geo.widths[0];
    const float gy =
        fmaxf(fmaxf(s_box[1] - fr.y, fr.y - s_box[4]), 0.0f) * c_geo.widths[1];
    const float gz =
        fmaxf(fmaxf(s_box[2] - fr.z, fr.z - s_box[5]), 0.0f) * c_geo.widths[2];
    // the prefilter radius R = pre_rc + margin * (wx + wy + wz)
    // (ops/packed_order_cuda.py prefilter_radius)
    return fmaxf(fmaxf(gx, gy), gz) < p.pre_rc + p.margin * c_geo.width_sum;
  };
  auto keep = [&](int o, int j, float3 x) -> bool {
    return real(j) && (o == cell_stage::kSelf || !pre || near(x));
  };
  auto store = [&](int q, int, float3 x) {
    s_pos[q] = make_float4(x.x, x.y, x.z, 0.0f);
  };
  const int n_rows = cell_stage::stage_neighbours(r, p.g, c_geo.h, cell, sc,
                                                  keep,
                                                  store);
  for (int k = threadIdx.x; k < cap; k += kStageThreads) {
    if (cell_stage::own_dropped(sc, cap, k)) {
      const int s = k * C + cell;
      if (WithLJ) {
        f[s] = 0.0f;
        f[n_pad + s] = 0.0f;
        f[2 * n_pad + s] = 0.0f;
      }
      if (Grad) {
        g[s] = 0.0f;
        g[n_pad + s] = 0.0f;
        g[2 * n_pad + s] = 0.0f;
      }
    }
  }

  const int i0 = sc.off[cell_stage::kSelf];
  const int n_i = sc.off[cell_stage::kSelf + 1] - i0;
  int* queue = sc.queue + warp * cell_stage::kQueue;
  constexpr int kTerms = Vals ? lane_count<Lanes, Mono>() : 1;
  // compile-time in the fixed layouts, so their loops over t unroll
  const int nt = !Vals ? 0 : Lanes == kLanesAny ? n_terms : kTerms;
  float vacc[kTerms];
#pragma unroll
  for (int t = 0; t < nt; ++t) vacc[t] = 0.0f;
  // the pair's displacement r_i - r_j (staged row q) and r^2
  auto geom = [&](float4 xi, int q, float* dx, float* dy, float* dz) -> float {
    const float4 xj = s_pos[q];
    *dx = xi.x - xj.x;
    *dy = xi.y - xj.y;
    *dz = xi.z - xj.z;
    return *dx * *dx + *dy * *dy + *dz * *dz;
  };
  auto hit = [&](float4 xi, int q) -> bool {
    float dx, dy, dz;
    const float r2 = geom(xi, q, &dx, &dy, &dz);
    return r2 > 1.0e-12f && r2 < p.rc2_hit;  // not the slot itself
  };

  if constexpr (Vals && !Grad && !WithLJ) {
    float unused = 0.0f;
    cell_stage::warp_sweep_rows(
        i0 + warp, i0 + n_i, kStageWarps, n_rows, queue,
        [&](int i, int q) { return hit(s_pos[i], q); },
        [&](int i, int q) {
          float dx, dy, dz;
          const float r2 = geom(s_pos[i], q, &dx, &dy, &dz);
          cv_pair<true, false, Kinds, L, Lanes, Mono>(
              s_desc, n_cvs, s_aux, dx, dy, dz, r2, vacc, unused, unused,
              unused);
        });
  } else {
    for (int ii = warp; ii < n_i; ii += kStageWarps) {
      const float4 xi = s_pos[i0 + ii];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      float gx = 0.0f, gy = 0.0f, gz = 0.0f;
      cell_stage::warp_sweep(
          n_rows, queue, [&](int q) { return hit(xi, q); },
          [&](int q) {
            float dx, dy, dz;
            const float r2 = geom(xi, q, &dx, &dy, &dz);
            if (WithLJ && r2 < p.rc2_lj) {
              const float inv = 1.0f / r2;
              const float s2 = p.sig2 * inv;
              const float s6 = s2 * s2 * s2;
              const float coef = p.eps4 * (12.0f * s6 * s6 - 6.0f * s6) * inv;
              fx += coef * dx;
              fy += coef * dy;
              fz += coef * dz;
            }
            cv_pair<Vals, Grad, Kinds, L, Lanes, Mono>(
                s_desc, n_cvs, s_aux, dx, dy, dz, r2, vacc, gx, gy, gz);
          });
      const int s = sc.islot[ii];
      if (WithLJ) {
        fx = cell_stage::warp_sum(fx);
        fy = cell_stage::warp_sum(fy);
        fz = cell_stage::warp_sum(fz);
        if (lane == 0) {
          f[s] = fx;
          f[n_pad + s] = fy;
          f[2 * n_pad + s] = fz;
        }
      }
      if (Grad) {
        gx = cell_stage::warp_sum(gx);
        gy = cell_stage::warp_sum(gy);
        gz = cell_stage::warp_sum(gz);
        if (lane == 0) {
          g[s] = gx;
          g[n_pad + s] = gy;
          g[2 * n_pad + s] = gz;
        }
      }
    }
  }

  if (Vals) {
    // a shuffle tree per term, then the warps in order into the cell's row
    __shared__ float s_red[kStageWarps][kMaxTerms];
#pragma unroll
    for (int t = 0; t < nt; ++t) {
      const float v = cell_stage::warp_sum(vacc[t]);
      if (lane == 0) s_red[warp][t] = v;
    }
    __syncthreads();
    const float m = cell_mask != nullptr ? cell_mask[cell] : 1.0f;
    for (int t = threadIdx.x; t < nt; t += kStageThreads) {
      float acc = 0.0f;
      for (int w = 0; w < kStageWarps; ++w) acc += s_red[w][t];
      partials[cell * nt + t] = acc * m;
    }
  }
}

// One block: out[t] = sum_b partials[b, t] over the n_blocks rows, in double,
// in a fixed order: warp w takes the terms t = w, w + warps, ...; lane k of
// the warp sums the rows k, k + 32, ... of term t in order, and a shuffle
// tree adds the 32 lane sums.  Two calls give the same bits.
__global__ void __launch_bounds__(kReduceThreads)
reduce_terms_kernel(const float* __restrict__ partials, int n_blocks,
                    int n_terms, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n_terms; t += kReduceThreads / 32) {
    double acc = 0.0;
#pragma unroll 4
    for (int b = lane; b < n_blocks; b += 32) acc += partials[b * n_terms + t];
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(cell_stage::kFull, acc, off);
    }
    if (lane == 0) out[t] = static_cast<float>(acc);
  }
}

struct StagedArgs {
  const float* r;
  const int* pid;
  const float* desc;
  int desc_len;
  int n_cvs;
  int n_terms;
  const float* aux;
  int n_aux;
  StagedParams p;
  float* f;
  float* g;
  float* partials;  // (cells, n_terms) with Vals
  float* out;       // (n_terms,) with Vals
  const float* cell_mask;  // (cells,) value weights with Vals, or null
};

// Launches one instantiation on a block per cell, and with Vals the second
// pass.  Returns 0, a CUDA error of the shared-memory request, or
// cell_stage::kSmemTooLarge when cap does not fit a block's shared memory.
template <bool WithLJ, bool Vals, bool Grad, bool Valid, int Kinds, int L,
          int Lanes, bool Mono = false>
int launch_staged(const StagedArgs& a, cudaStream_t st) {
  const size_t smem = staged_smem(a.p.g.cap);
  auto kernel =
      order_staged_kernel<WithLJ, Vals, Grad, Valid, Kinds, L, Lanes, Mono>;
  const int rc = cell_stage::request_smem(kernel, smem, kStaticSmem);
  if (rc != 0) return rc;
  const cudaError_t copied = cudaMemcpyToSymbolAsync(
      c_geo, a.p.g.box, sizeof(cell_geom::BoxRow), 0,
      cudaMemcpyDeviceToDevice, st);
  if (copied != cudaSuccess) return static_cast<int>(copied);
  const int n_cells = a.p.g.cx * a.p.g.cy * a.p.g.cz;
  kernel<<<n_cells, kStageThreads, smem, st>>>(
      a.r, a.pid, a.desc, a.desc_len, a.n_cvs, a.n_terms, a.aux, a.n_aux,
      a.p, a.f, a.g, a.partials, a.cell_mask);
  if (Vals) {
    reduce_terms_kernel<<<1, kReduceThreads, 0, st>>>(a.partials, n_cells,
                                                      a.n_terms, a.out);
  }
  return 0;
}

// Picks the instantiation of a CV list: cv_set (kSet*), l_fixed (6 if every
// Q_l has l = 6, else 0), lanes (kLanes*; with Vals only, else ignored).
// Mono (the fused kernel's monomial mode) needs a Q_l and l_fixed = 6.
// Returns launch_staged's code, or cudaErrorInvalidValue for a combination
// without an instantiation.
template <bool WithLJ, bool Vals, bool Grad, bool Valid, bool Mono = false>
int launch_staged_set(int cv_set, int l_fixed, int lanes,
                      const StagedArgs& a, cudaStream_t st) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  if (l_fixed != 0 && l_fixed != 6) return bad;
  if (Mono && (l_fixed != 6 || cv_set == kSetCoord)) return bad;
  if constexpr (Vals) {
    if (lanes == kLanesQ6) {
      if (cv_set != kSetQl || l_fixed != 6 || a.n_cvs != 1 ||
          a.n_terms != q6_terms<Mono>()) {
        return bad;
      }
      return launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6, kLanesQ6,
                           Mono>(a, st);
    }
    if (lanes == kLanesQ6Coord) {
      if (cv_set != kSetMixed || l_fixed != 6 || a.n_cvs != 2 ||
          a.n_terms != q6_terms<Mono>() + 1) {
        return bad;
      }
      return launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                           kLanesQ6Coord, Mono>(a, st);
    }
    if (lanes != kLanesAny) return bad;
  }
  if constexpr (Mono) {
    return cv_set == kSetQl
               ? launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6,
                               kLanesAny, true>(a, st)
               : launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                               kLanesAny, true>(a, st);
  } else {
    switch (cv_set) {
      case kSetQl:
        return l_fixed
                   ? launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6,
                                   kLanesAny>(a, st)
                   : launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 0,
                                   kLanesAny>(a, st);
      case kSetCoord:
        return launch_staged<WithLJ, Vals, Grad, Valid, kSetCoord, 0,
                             kLanesAny>(a, st);
      case kSetMixed:
        return l_fixed
                   ? launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                                   kLanesAny>(a, st)
                   : launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 0,
                                   kLanesAny>(a, st);
      default: return bad;
    }
  }
}

}  // namespace order_cv
