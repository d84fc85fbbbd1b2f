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
//                                                 packed_fused_lj_order.cu;
//                                                 the parts subsets, Split:
//                                                 packed_fused_parts.cu)
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
// registers; other lists index them at run time (local memory).  Those
// layouts keep the descriptor (kMaxDesc floats), the aux lanes (kMaxAux)
// and the value sums (kMaxTerms) in static arrays; a list past any of
// them runs the wide layout (kLanesWide: kinds and l read per CV, the
// arrays in dynamic shared memory sized from the plan), up to the
// reference's 128 value and 128 aux lanes, any number of CVs, any l.  In
// the recurrence the wide layout keeps no value sum in a thread: its Q_l
// pairs run on a queue of their own, each Q_l at a compile-time l for the
// even l up to 12 (ql_round), their value terms through a per-warp tile
// into the warp's row of value sums (order_staged_kernel).
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
// mono=True), first one Q_l, l = 6, in the homogeneous-monomial basis of the unit
// bond vector u; coordination keeps its math.  Per pair the bias force is
// g_a = b_a . mono_5(u) for a = x, y, z, projected off u and divided by r,
// and the value terms are mono_6(u) (28) and the bond count.  The monomials
// are built by degree halving in the reference's order (each_mono,
// cv/ylm_mono.py _split_plan), so every monomial is the same f32 product as
// the plain version's.  The design keeps the sweep inside 64 registers:
// - the kernel takes the Q_6's grad_aux as the recurrence does (Re, Im: 14
//   lanes) and forms a = C^T aux and b_a = D_a a once per block into shared
//   memory (C = ylm_mono_matrix(6), D_a = diff_matrices(6): the Q_6's table
//   in the descriptor, which every block copies to shared memory; from
//   constant memory, each lane's column of C cost a serialized read);
// - the Q_6 hits have a queue of their own (mono_sweep), so the monomial
//   math runs on about 12 lanes once per i row, not on every round of the
//   ~60 LJ and coordination hits;
// - the force builds each degree-5 monomial into the three dot products
//   (no mono_5 array), then the values build the degree-6 ones, never both
//   at once;
// - a round's degree-6 monomials go to a per-warp tile in shared memory,
//   one column per Q_6 hit, and lane t < 28 adds row t in column order: one
//   running sum per lane, not 28;
// - the second pass (reduce_mono_kernel) sums the partials as
//   reduce_terms_kernel does and writes the recurrence's value lanes, C
//   times the monomial sums, in double.
// So a mono call runs the same device operations as a recurrence call.
// Any other list of Q_l (each l <= 8, several, with different cut-offs)
// runs the general monomial mode (L = 0, the wide layout): each Q_l's C
// and D tables in its descriptor table, its force vectors at h[6] of a
// shared array, the pairs inside the largest Q_l cut-off on the Q_l
// queue, and per round mono_round: the powers of u in a per-warp table,
// each Q_l's force per lane, its monomial sums across the round's pairs
// by lanes t, t + 32, ... into the warp's row of value sums.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "cell_geom.cuh"
#include "cell_stage.cuh"

namespace order_cv {

constexpr float kVacantThr = 1.0e6f;  // ops/packed.py VACANT_THR
constexpr int kHdr = 9;
// Value and aux lanes over all CVs: the reference's lane row (1, 128).
constexpr int kMaxLanes = 128;
// The narrow instantiations' static arrays (every layout but kLanesWide):
// a plan past any of these runs the wide one, whose arrays are sized from
// the plan (WideSmem).
constexpr int kMaxTerms = 64;  // value lanes
constexpr int kMaxAux = 64;    // aux lanes
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
// offsets from the descriptor; the descriptor, the aux lanes and the
// value sums in dynamic shared memory sized from the plan, up to kMaxLanes
// lanes (launch_staged_set picks it past the narrow arrays, and for the
// general monomial mode)
constexpr int kLanesWide = 3;
constexpr int kQ6Terms = 15;      // Re (7), Im (7), bond count
constexpr int kQ6MonoTerms = 29;  // mono_6 sums (28), bond count

// The monomial mode's sizes, and its Q_6's table in the descriptor
// (ops/packed_order_cuda.py mono_tables, from cv/ylm_mono.py): C =
// ylm_mono_matrix(6), (14, 28) row-major, Re rows then Im rows; then each
// row of D_x, D_y, D_z (21 x 28 each, one nonzero per row) as its column,
// then as its value.
constexpr int kMono6 = 28;        // n_mono(6)
constexpr int kMono5 = 21;        // n_mono(5)
constexpr int kY6 = 14;           // Q_6's Re and Im lanes
constexpr int kMonoDcol = kY6 * kMono6;             // the table's columns
constexpr int kMonoDval = kMonoDcol + 3 * kMono5;   // and values
constexpr int kMonoB = 64;  // s_aux: (b_x, b_y, b_z, 0)_t after the aux lanes
constexpr int kTileLd = 33;       // a tile row: 32 columns and a pad
// The general monomial mode's largest degree: 3 n_mono(l - 1) aux lanes of
// one sphere CV fit the 128 of the reference's lane row up to l = 8.
constexpr int kMaxMonoDeg = 8;
constexpr int kPowRows = kMaxMonoDeg + 1;  // powers 0..8 per axis

__host__ __device__ constexpr bool fixed_lanes(int lanes) {
  return lanes == kLanesQ6 || lanes == kLanesQ6Coord;
}

// Q6's value lanes in the recurrence (15) or the monomial mode (29).
template <bool Mono>
__host__ __device__ constexpr int q6_terms() {
  return Mono ? kQ6MonoTerms : kQ6Terms;
}

constexpr int kStageThreads = 256;
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kReduceThreads = 512;
constexpr int kMonoReduceThreads = 1024;  // a warp per monomial lane

// The arguments every entry point validates before a launch.  Returns 0 or
// cudaErrorInvalidValue.
inline int check_args(int n_cvs, int desc_len, int n_terms, int n_aux,
                      int n_pad) {
  if (n_cvs < 1 || desc_len < kHdr * n_cvs || n_terms < 0 ||
      n_terms > kMaxLanes || n_aux < 0 || n_aux > kMaxLanes || n_pad < 1) {
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

// The recurrence of one Q_l on one ordered pair (cv/packed_order.
// PackedSteinhardtQl.pair_value_and_grad), r2 > 1e-12: with Vals the value
// terms Re S_m and Im S_m, m = 0..l, handed to value(m, re, im) as they are
// formed; with Grad the closed-form gradient of phi(d) = sum_m N_m p_m(c)
// Re[(g_re - i g_im) u^m] added into g.  tab: the Q_l's table (the norms
// N_m, the p_lm coefficients, their derivatives'); gre: its aux lanes
// (g_re, then g_im).  L > 0 fixes l at compile time (the caller guarantees
// l_rt == L), so the m and Horner loops unroll; L = 0 takes l_rt.
template <bool Vals, bool Grad, int L, class Value>
__device__ __forceinline__ void ql_terms(int l_rt, const float* tab,
                                         const float* gre, float dx, float dy,
                                         float dz, float r2, Value value,
                                         float& gx, float& gy, float& gz) {
  const int l = L > 0 ? L : l_rt;
  const float* norms = tab;
  const float* coef = tab + (l + 1);
  const float* dcoef = coef + (l + 1) * (l + 2) / 2;
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
      value(m, wn * pr, wn * pi);
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
  if (Grad) {
    gx += (D * (-cth * ux) + E - ux * BU) * inv_r;
    gy += (D * (-cth * uy) - F - uy * BU) * inv_r;
    gz += (D * (1.0f - cth * cth) - cth * BU) * inv_r;
  }
}

// Q_l of one ordered pair inside its cut-off (ql_terms): value terms (Re
// S_m, Im S_m, n_b) into vacc and the gradient into g.  r2 > 1e-12 is
// guaranteed by the caller.  L > 0 fixes l at compile time (the caller
// guarantees h[1] == L); L = 0 reads l from the header.  VO >= 0 fixes the
// value lane offset at compile time (the caller guarantees h[2] == VO);
// VO < 0 reads it from the header.
template <bool Vals, bool Grad, int L = 0, int VO = -1>
__device__ __forceinline__ void ql_pair(const float* h, const float* tab,
                                        const float* aux, float dx, float dy,
                                        float dz, float r2, float* vacc,
                                        float& gx, float& gy, float& gz) {
  if (!(r2 < h[5])) return;
  const int l = L > 0 ? L : static_cast<int>(h[1]);
  const int vo = VO >= 0 ? VO : static_cast<int>(h[2]);
  ql_terms<Vals, Grad, L>(
      l, tab, aux + static_cast<int>(h[3]), dx, dy, dz, r2,
      [&](int m, float re, float im) {
        vacc[vo + m] += re;
        vacc[vo + l + 1 + m] += im;
      },
      gx, gy, gz);
  if (Vals) vacc[vo + 2 * (l + 1)] += 1.0f;
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
// D/2 (ml), each handed to f(index, value) as it is built: the product of
// the greedy split of its exponents, as cv/ylm_mono.py _split_plan plans
// it.  Both loops unroll, so every index is a constant and mh, ml stay in
// registers; a caller that takes each monomial into its sums at once holds
// no array of them.
template <int D, class F>
__device__ __forceinline__ void each_mono(const float* mh, const float* ml,
                                          F f) {
  constexpr int hi = D - D / 2;
  constexpr int lo = D / 2;
#pragma unroll
  for (int i = D; i >= 0; --i) {
#pragma unroll
    for (int j = D - i; j >= 0; --j) {
      const int i2 = i < hi ? i : hi;
      const int j2 = j < hi - i2 ? j : hi - i2;
      f(mono_index(D, i, j),
        mh[mono_index(hi, i2, j2)] * ml[mono_index(lo, i - i2, j - j2)]);
    }
  }
}

// u and its monomials of degrees 2 and 3 (m1, m2, m3) for one pair.
__device__ __forceinline__ void mono_low(float dx, float dy, float dz,
                                         float inv_r, float* m1, float* m2,
                                         float* m3) {
  m1[0] = dx * inv_r;
  m1[1] = dy * inv_r;
  m1[2] = dz * inv_r;
  each_mono<2>(m1, m1, [&](int t, float v) { m2[t] = v; });
  each_mono<3>(m2, m1, [&](int t, float v) { m3[t] = v; });
}

// Q_6's bias force of one pair in the monomial mode (cv/packed_order.
// PackedSteinhardtQl pair_mono_grad_terms): (g - u (u . g)) / r with g_a =
// b_a . mono_5(u), (b_x, b_y, b_z)_t in b[t] (one 16-byte load each).
__device__ __forceinline__ void q6_mono_grad(const float4* b, const float* m1,
                                             const float* m2, const float* m3,
                                             float inv_r, float& gx, float& gy,
                                             float& gz) {
  float gux = 0.0f, guy = 0.0f, guz = 0.0f;
  each_mono<5>(m3, m2, [&](int t, float v) {
    const float4 c = b[t];
    gux += c.x * v;
    guy += c.y * v;
    guz += c.z * v;
  });
  const float dot = m1[0] * gux + m1[1] * guy + m1[2] * guz;
  gx += (gux - m1[0] * dot) * inv_r;
  gy += (guy - m1[1] * dot) * inv_r;
  gz += (guz - m1[2] * dot) * inv_r;
}

// One warp's sweep of one i row in the monomial mode: cell_stage::
// warp_sweep with the Q_6 pairs apart.  hit(q) is the cheap test; hits are
// queued in staged order and run 32 at a time through near(q, live) (LJ and
// the other CVs), which returns whether the pair lies inside Q_6's cut-off.
// A round's Q_6 pairs are then moved onto queue_q, and q6(q, live) runs on
// 32 of them at a time and on the rest at the row's end, so the monomial
// math runs about once per row rather than beside near on every round.
// Every lane calls near and q6 with the warp converged, live false on a
// lane without an entry, so that q6 may sum across the warp.  Called by
// all 32 lanes of the warp.
template <class Hit, class Near, class Q6>
__device__ void mono_sweep(int n_rows, int* queue, int* queue_q, Hit hit,
                           Near near, Q6 q6) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int qn = 0, qm = 0;
  auto round = [&](int e, bool live) {
    const bool in_q6 = near(e, live);
    const unsigned mq = __ballot_sync(cell_stage::kFull, in_q6);
    if (in_q6) queue_q[qm + __popc(mq & lower)] = e;
    qm += __popc(mq);
    __syncwarp();
    if (qm >= 32) {
      q6(queue_q[lane], true);
      qm -= 32;
      __syncwarp();
      if (lane < qm) queue_q[lane] = queue_q[32 + lane];
      __syncwarp();
    }
  };
  for (int base = 0; base < n_rows; base += 32) {
    const int q = base + lane;
    const bool h = q < n_rows && hit(q);
    const unsigned m = __ballot_sync(cell_stage::kFull, h);
    if (h) queue[qn + __popc(m & lower)] = q;
    qn += __popc(m);
    __syncwarp();
    if (qn >= 32) {
      round(queue[lane], true);
      qn -= 32;
      __syncwarp();
      if (lane < qn) queue[lane] = queue[32 + lane];
      __syncwarp();
    }
  }
  round(lane < qn ? queue[lane] : 0, lane < qn);
  q6(lane < qm ? queue_q[lane] : 0, lane < qm);
  __syncwarp();
}

// The general monomial mode (any list of Q_l CVs, each l <= kMaxMonoDeg,
// read from the descriptor; the L = 0 instantiations).  A warp's power
// table holds u_a^n (a = x, y, z; n = 0..kMaxMonoDeg) of each Q_l pair of
// a round, one column per lane, rows kTileLd apart: lanes that read
// different powers of one column read different banks.  Monomial ux^i uy^j
// uz^k of a pair is pw(x, i) pw(y, j) pw(z, k), its powers by repeated
// products: the plain version's split products to a few ulp.
__device__ __forceinline__ float pw_at(const float* pw, int axis, int n,
                                       int col) {
  return pw[(axis * kPowRows + n) * kTileLd + col];
}

// The exponents (i, j) of monomial t of degree d in cv/ylm_mono.py's
// mono_powers order: t = s (s + 1) / 2 + k with s = d - i, k = s - j.
__device__ __forceinline__ void mono_exps(int d, int t, int& i, int& j) {
  int s = 0;
  while ((s + 1) * (s + 2) / 2 <= t) ++s;
  i = d - s;
  j = s - (t - s * (s + 1) / 2);
}

// One round of Q_l pairs in the general monomial mode, called by all 32
// lanes with the warp converged; live: this lane holds a pair inside the
// largest Q_l cut-off, (dx, dy, dz, r2) its geometry.  Per Q_l CV (header
// h: l at h[1], value lanes from h[2], cut-off h[5], force vectors at
// bvec + h[6], (b_x, b_y, b_z, 0) per degree-(l - 1) monomial): Grad adds
// the force of this lane's pair inside the CV's cut-off, (g - u (u . g))
// / r with g_a = b_a . mono_{l-1}(u), into (gx, gy, gz); Vals adds the
// round's monomial sums into this warp's row red, lane t taking monomials
// t, t + 32, ... over the pairs in lane order, and lane 0 the bond count.
template <bool Vals, bool Grad>
__device__ void mono_round(const float* desc, int n_cvs, const float* bvec,
                           float* pw, float* red, int l_max, bool live,
                           float dx, float dy, float dz, float r2, float& gx,
                           float& gy, float& gz) {
  const int lane = threadIdx.x & 31;
  float ux = 0.0f, uy = 0.0f, uz = 0.0f, inv_r = 0.0f;
  if (live) {
    inv_r = rsqrtf(r2);
    ux = dx * inv_r;
    uy = dy * inv_r;
    uz = dz * inv_r;
    float px = 1.0f, py = 1.0f, pz = 1.0f;
    for (int n = 0; n <= l_max; ++n) {
      pw[n * kTileLd + lane] = px;
      pw[(kPowRows + n) * kTileLd + lane] = py;
      pw[(2 * kPowRows + n) * kTileLd + lane] = pz;
      px *= ux;
      py *= uy;
      pz *= uz;
    }
  }
  __syncwarp();
  for (int c = 0; c < n_cvs; ++c) {
    const float* h = desc + c * kHdr;
    if (static_cast<int>(h[0]) != kQl) continue;
    const int l = static_cast<int>(h[1]);
    const bool on = live && r2 < h[5];
    if (Grad && on) {
      const float4* b = reinterpret_cast<const float4*>(
          bvec + static_cast<int>(h[6]));
      const int d = l - 1;
      float gux = 0.0f, guy = 0.0f, guz = 0.0f;
      int t = 0;
      for (int i = d; i >= 0; --i) {
        const float a = pw_at(pw, 0, i, lane);
        for (int j = d - i; j >= 0; --j, ++t) {
          const float v =
              a * pw_at(pw, 1, j, lane) * pw_at(pw, 2, d - i - j, lane);
          const float4 cb = b[t];
          gux += cb.x * v;
          guy += cb.y * v;
          guz += cb.z * v;
        }
      }
      const float dot = ux * gux + uy * guy + uz * guz;
      gx += (gux - ux * dot) * inv_r;
      gy += (guy - uy * dot) * inv_r;
      gz += (guz - uz * dot) * inv_r;
    }
    if (Vals) {
      const unsigned mq = __ballot_sync(cell_stage::kFull, on);
      if (mq != 0u) {  // the same on every lane
        const int vo = static_cast<int>(h[2]);
        const int nm = n_mono(l);
        for (int t = lane; t < nm; t += 32) {
          int i, j;
          mono_exps(l, t, i, j);
          float acc = 0.0f;
          for (unsigned m = mq; m != 0u; m &= m - 1u) {
            const int col = __ffs(m) - 1;
            acc += pw_at(pw, 0, i, col) * pw_at(pw, 1, j, col) *
                   pw_at(pw, 2, l - i - j, col);
          }
          red[vo + t] += acc;
        }
        if (lane == 0) red[vo + nm] += static_cast<float>(__popc(mq));
      }
    }
  }
  __syncwarp();
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

// Every CV of the descriptor on one pair (the recurrence).  Kinds: kSet*;
// L: 6 or 0 (ql_pair); Lanes: kLanes* (with a fixed layout, Kinds and L are
// implied).
template <bool Vals, bool Grad, int Kinds, int L, int Lanes>
__device__ __forceinline__ void cv_pair(const float* desc, int n_cvs,
                                        const float* aux, float dx, float dy,
                                        float dz, float r2, float* vacc,
                                        float& gx, float& gy, float& gz) {
  if constexpr (fixed_lanes(Lanes)) {
    ql_pair<Vals, Grad, 6, 0>(desc, desc + static_cast<int>(desc[4]), aux,
                              dx, dy, dz, r2, vacc, gx, gy, gz);
    if constexpr (Lanes == kLanesQ6Coord) {
      coord_pair<Vals, Grad, kQ6Terms>(desc + kHdr, aux, dx, dy, dz, r2, vacc,
                                       gx, gy, gz);
    }
  } else {
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = desc + c * kHdr;
      if (Kinds == kSetQl ||
          (Kinds == kSetMixed && static_cast<int>(h[0]) == kQl)) {
        ql_pair<Vals, Grad, L>(h, desc + static_cast<int>(h[4]), aux, dx, dy,
                               dz, r2, vacc, gx, gy, gz);
      } else {
        coord_pair<Vals, Grad>(h, aux, dx, dy, dz, r2, vacc, gx, gy, gz);
      }
    }
  }
}

// The CVs other than the Q_l on one pair in the monomial mode: the
// coordination of [Q6, coordination] (its value lane after the Q_6's 29),
// or every non-Q_l CV of a list read from the descriptor.
template <bool Vals, bool Grad, int Kinds, int Lanes>
__device__ __forceinline__ void mono_others(const float* desc, int n_cvs,
                                            const float* aux, float dx,
                                            float dy, float dz, float r2,
                                            float* vacc, float& gx, float& gy,
                                            float& gz) {
  if constexpr (Lanes == kLanesQ6Coord) {
    coord_pair<Vals, Grad, kQ6MonoTerms>(desc + kHdr, aux, dx, dy, dz, r2,
                                         vacc, gx, gy, gz);
  } else if constexpr (!fixed_lanes(Lanes) && Kinds == kSetMixed) {
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = desc + c * kHdr;
      if (static_cast<int>(h[0]) != kQl) {
        coord_pair<Vals, Grad>(h, aux, dx, dy, dz, r2, vacc, gx, gy, gz);
      }
    }
  }
}

// The wide recurrence (kLanesWide without Mono): the rows of a warp's
// value tile, Re and Im of one Q_l of l <= 12 (the compile-time degrees of
// ql_round's dispatch; every even l of the reference's lists up to Q12).
constexpr int kWideTileRows = 26;

// One round of the wide recurrence's Q_l queue, called by all 32 lanes
// with the warp converged; live: this lane holds a pair inside the largest
// Q_l cut-off, (dx, dy, dz, r2) its geometry (r2 > 0 on every lane).  Per
// Q_l CV of the descriptor (header h): the lanes with their pair inside
// its cut-off run its math (ql_terms); Grad adds each pair's force into
// (gx, gy, gz).  At a compile-time l (l = 2, 4, ..., 12) Vals writes the
// pairs' value terms to the warp's tile, one column per pair in lane
// order, and lane t adds row t over the columns, in column order, into the
// warp's row of value sums red; at any other l, read from the header, every
// lane runs the math and each term is summed by a shuffle tree.  Lane 0
// adds the bond count.
template <bool Vals, bool Grad>
__device__ __forceinline__ void ql_round(const float* desc, int n_cvs,
                                         const float* aux, float* tile,
                                         float* red, bool live, float dx,
                                         float dy, float dz, float r2,
                                         float& gx, float& gy, float& gz) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n_cvs; ++c) {
    const float* h = desc + c * kHdr;
    if (static_cast<int>(h[0]) != kQl) continue;
    const bool on = live && r2 < h[5];
    const unsigned mq = __ballot_sync(cell_stage::kFull, on);
    if (mq == 0u) continue;  // the same on every lane
    const int l = static_cast<int>(h[1]);
    const int vo = static_cast<int>(h[2]);
    const float* tab = desc + static_cast<int>(h[4]);
    const float* ga = aux + static_cast<int>(h[3]);
    float* const col = tile + __popc(mq & ((1u << lane) - 1u));
    bool tiled = true;  // a compile-time l: its terms through the tile
#define ORDER_CV_QL_CASE(LL)                                               \
  case LL:                                                                 \
    if (on) {                                                              \
      ql_terms<Vals, Grad, LL>(                                            \
          LL, tab, ga, dx, dy, dz, r2,                                     \
          [&](int m, float re, float im) {                                 \
            col[m * kTileLd] = re;                                         \
            col[(LL + 1 + m) * kTileLd] = im;                              \
          },                                                               \
          gx, gy, gz);                                                     \
    }                                                                      \
    break;
    switch (l) {
      ORDER_CV_QL_CASE(2)
      ORDER_CV_QL_CASE(4)
      ORDER_CV_QL_CASE(6)
      ORDER_CV_QL_CASE(8)
      ORDER_CV_QL_CASE(10)
      ORDER_CV_QL_CASE(12)
      default:
        // any other l: with Vals every lane runs the math and each term
        // is summed by a shuffle tree; a force alone runs on the lanes
        // inside the cut-off
        tiled = false;
        if constexpr (Vals) {
          float hx = 0.0f, hy = 0.0f, hz = 0.0f;
          ql_terms<Vals, Grad, 0>(
              l, tab, ga, dx, dy, dz, r2,
              [&](int m, float re, float im) {
                re = cell_stage::warp_sum(on ? re : 0.0f);
                im = cell_stage::warp_sum(on ? im : 0.0f);
                if (lane == 0) {
                  red[vo + m] += re;
                  red[vo + l + 1 + m] += im;
                }
              },
              hx, hy, hz);
          if (on) {
            gx += hx;
            gy += hy;
            gz += hz;
          }
        } else if (on) {
          ql_terms<Vals, Grad, 0>(l, tab, ga, dx, dy, dz, r2,
                                  [](int, float, float) {}, gx, gy, gz);
        }
    }
#undef ORDER_CV_QL_CASE
    if (Vals) {
      const int n_on = __popc(mq);
      if (tiled) {
        __syncwarp();
        if (lane < 2 * (l + 1)) {
          const float* row = tile + lane * kTileLd;
          float acc = 0.0f;
          for (int k = 0; k < n_on; ++k) acc += row[k];
          red[vo + lane] += acc;
        }
        __syncwarp();
      }
      if (lane == 0) red[vo + 2 * (l + 1)] += static_cast<float>(n_on);
    }
  }
}

// The CVs other than Q_l (coordination) on one round of the wide
// recurrence's hit queue, called by all 32 lanes with the warp converged,
// live: this lane holds a pair.  Grad adds the pair's force into (gx, gy,
// gz); Vals sums each CV's value over the round's pairs by a shuffle tree
// into the warp's row red (lane 0).
template <bool Vals, bool Grad>
__device__ __forceinline__ void wide_others(const float* desc, int n_cvs,
                                            const float* aux, float* red,
                                            bool live, float dx, float dy,
                                            float dz, float r2, float& gx,
                                            float& gy, float& gz) {
  for (int c = 0; c < n_cvs; ++c) {
    const float* h = desc + c * kHdr;
    if (static_cast<int>(h[0]) == kQl) continue;
    const bool on = live && r2 < h[5];
    if (Grad && on) {
      coord_pair<false, true>(h, aux, dx, dy, dz, r2, nullptr, gx, gy, gz);
    }
    if (Vals && __ballot_sync(cell_stage::kFull, on) != 0u) {
      float v = 0.0f, unused = 0.0f;
      if (on) {
        coord_pair<true, false, 0>(h, aux, dx, dy, dz, r2, &v, unused,
                                   unused, unused);
      }
      v = cell_stage::warp_sum(v);
      if ((threadIdx.x & 31) == 0) red[static_cast<int>(h[2])] += v;
    }
  }
}

// One warp's sweep of its i rows i = first, first + stride, ... < end
// (the own cell's kept rows) in the wide recurrence: two queues, as
// mono_sweep, each entry (i << 16) | q.  hit(i, q) is the cheap test;
// hits are queued in order and run 32 at a time through near(e, live) (LJ
// and the CVs other than Q_l), which returns whether the pair lies inside
// the largest Q_l cut-off; those pairs move onto queue_q, and qround(e,
// live) runs on 32 of them at a time, across rows, and on the rest at the
// end.  PerRow: the hit queue is flushed at the end of each row, so that
// each of its rounds holds one row; otherwise it is kept across the rows
// too.  Every lane calls near and qround with the warp converged, live
// false on a lane without an entry.  Called by all 32 lanes of the warp.
template <bool PerRow, class Hit, class Near, class QRound>
__device__ void wide_sweep(int first, int end, int stride, int n_rows,
                           int* queue, int* queue_q, Hit hit, Near near,
                           QRound qround) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int qn = 0, qm = 0;
  auto round = [&](int e, bool live) {
    const bool in_q = near(e, live);
    const unsigned mq = __ballot_sync(cell_stage::kFull, in_q);
    if (in_q) queue_q[qm + __popc(mq & lower)] = e;
    qm += __popc(mq);
    __syncwarp();
    if (qm >= 32) {
      qround(queue_q[lane], true);
      qm -= 32;
      __syncwarp();
      if (lane < qm) queue_q[lane] = queue_q[32 + lane];
      __syncwarp();
    }
  };
  for (int i = first; i < end; i += stride) {
    for (int base = 0; base < n_rows; base += 32) {
      const int q = base + lane;
      const bool h = q < n_rows && hit(i, q);
      const unsigned m = __ballot_sync(cell_stage::kFull, h);
      if (h) queue[qn + __popc(m & lower)] = (i << 16) | q;
      qn += __popc(m);
      __syncwarp();
      if (qn >= 32) {
        round(queue[lane], true);
        qn -= 32;
        __syncwarp();
        if (lane < qn) queue[lane] = queue[32 + lane];
        __syncwarp();
      }
    }
    if constexpr (PerRow) {
      round(lane < qn ? queue[lane] : 0, lane < qn);
      qn = 0;
      __syncwarp();
    }
  }
  if constexpr (!PerRow) round(lane < qn ? queue[lane] : 0, lane < qn);
  qround(lane < qm ? queue_q[lane] : 0, lane < qm);
  __syncwarp();
}

// Value lanes a thread sums: the fixed layouts' count, else the limit.
template <int Lanes, bool Mono>
__host__ __device__ constexpr int lane_count() {
  return Lanes == kLanesQ6       ? q6_terms<Mono>()
         : Lanes == kLanesQ6Coord ? q6_terms<Mono>() + 1
         : Lanes == kLanesWide    ? kMaxLanes
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

// The aux lanes in shared memory: the CVs' lanes, then (Mono) the Q_6's
// (b_x, b_y, b_z, 0) per degree-5 monomial at kMonoB.
template <bool Mono>
__host__ __device__ constexpr int aux_smem() {
  return Mono ? kMonoB + 4 * kMono5 : kMaxAux;
}

// The static arrays of order_staged_kernel (the descriptor, the aux lanes,
// the warps' value sums): the narrow layouts' sizes, a placeholder in the
// wide layout, whose arrays are dynamic (WideSmem).
template <int Lanes>
__host__ __device__ constexpr int desc_static() {
  return Lanes == kLanesWide ? 1 : kMaxDesc;
}
template <bool Mono, int Lanes>
__host__ __device__ constexpr int aux_static() {
  return Lanes == kLanesWide ? 4 : aux_smem<Mono>();
}
template <int Lanes>
__host__ __device__ constexpr int red_static() {
  return Lanes == kLanesWide ? 1 : kStageWarps * kMaxTerms;
}

// Static shared memory of order_staged_kernel, beside its dynamic rows.
template <bool Mono, int Lanes>
constexpr size_t static_smem() {
  return sizeof(float) * (desc_static<Lanes>() + aux_static<Mono, Lanes>() +
                          6 + red_static<Lanes>());
}

// The monomial mode's dynamic shared memory past cell_stage's scratch
// (which then holds no hit queues), per warp: its hit queue and its Q_l
// queue (kQueue ints each).  Q_6 alone (L = 6): with Vals its tile, kMono6
// rows of kTileLd floats: row t takes monomial t of each Q_6 pair of a
// round, one column per pair.  The tile takes the 28 value sums off each
// lane's registers (PERF.md: with them in registers the fused sweep
// spilled).  The general mode (L = 0): the power table of mono_round, 3
// kPowRows rows of kTileLd floats.
template <bool Mono, bool Vals, bool Grad, int L>
struct MonoSmem {
  static constexpr bool kOn = Mono && (Vals || Grad);
  static constexpr bool kGen = kOn && L == 0;
  static constexpr bool kTile = kOn && Vals && !kGen;
  static constexpr int kQueueWords = kOn ? 2 * cell_stage::kQueue : 0;
  static constexpr int kWarpWords =
      kQueueWords + (kTile ? kMono6 * kTileLd : 0) +
      (kGen ? 3 * kPowRows * kTileLd : 0);
  static constexpr int kScratchWarps = kOn ? 0 : kStageWarps;
  static constexpr size_t kBytes = sizeof(float) * kStageWarps * kWarpWords;
};

// Dynamic shared memory: the staged rows, cell_stage's scratch and MonoSmem.
template <bool Mono, bool Vals, bool Grad, int L>
inline size_t staged_smem(int cap) {
  using MS = MonoSmem<Mono, Vals, Grad, L>;
  return sizeof(float4) * cell_stage::kOffsets * cap +
         cell_stage::scratch_bytes(cap, MS::kScratchWarps) + MS::kBytes;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The wide layout's arrays, past staged_smem from the next 16-byte
// boundary, in floats: the descriptor (desc_len), the aux lanes (n_aux)
// and, Mono, the force vectors of every Q_l (n_bvec: 4 n_mono(l - 1)
// each), each rounded to 4; Mono with Grad the scratch of the conversion
// a = C^T aux (n_terms); with Vals the warps' value sums (kStageWarps rows
// of n_terms).  The recurrence (not Mono, with Vals or Grad): each warp's
// Q_l queue (kQueue ints); with Vals each warp's value tile (kWideTileRows
// rows of kTileLd); with WithLJ or Grad the LJ force and the bias force of
// each of the cell's cap rows (3 floats each).
struct WideSmem {
  int desc, aux, bvec, conv, red, qq, tile, fsum, gsum, words;
  __host__ __device__ WideSmem(int desc_len, int n_aux, int n_bvec,
                               int n_terms, bool mono, bool grad, bool vals,
                               bool lj, int cap)
      : desc(0),
        aux(round4(desc_len)),
        bvec(aux + round4(n_aux)),
        conv(bvec + round4(n_bvec)),
        red(conv + (mono && grad ? round4(n_terms) : 0)),
        qq(red + (vals ? round4(kStageWarps * n_terms) : 0)),
        tile(qq + (!mono && (vals || grad) ? kStageWarps * cell_stage::kQueue
                                           : 0)),
        fsum(tile + (!mono && vals ? kStageWarps * kWideTileRows * kTileLd
                                   : 0)),
        gsum(fsum + 3 * cap),
        words(fsum + (!mono && (lj || grad) ? 6 * cap : 0)) {}
};

// The Q_6's place in the monomial mode's CV list: 0 in the fixed layouts,
// else the list's one Q_l.
template <int Lanes>
__device__ __forceinline__ int mono_cv(const float* desc, int n_cvs) {
  int qc = 0;
  if constexpr (Lanes == kLanesAny) {
    for (int c = 0; c < n_cvs; ++c) {
      if (static_cast<int>(desc[c * kHdr]) == kQl) qc = c;
    }
  }
  return qc;
}

// The block-per-cell kernel.  WithLJ adds the Lennard-Jones pair force
// (sentinel layout, forces only, uniform sigma and epsilon) into f; Vals
// sums value terms into partials (one row of n_terms per cell, times the
// cell's weight in cell_mask where it is not null); Grad writes the CV bias
// force into g.  Valid: the validity layout, vacancy from pid (otherwise
// from the coordinate sentinel; pid is then not read and may be null).
// Mono: the Q_6 in the monomial mode (mono_sweep; aux holds the CVs'
// grad_aux lanes as in the recurrence, partials the monomial sums).  With
// Vals alone, a warp keeps one hit queue across its rows, unless Split.
// Split (the parts subsets of the fused sweep, packed_fused_parts.cu): the
// fused sweep's traversal and launch bounds whatever the subset, so that
// the subsets differ in their math alone.
// The wide layout without Mono (the wide recurrence): wide_sweep, the Q_l
// pairs on a queue of their own across the warp's rows, each Q_l at a
// compile-time l where it is even and at most 12 (ql_round), its value
// sums through the warp's tile into the warp's row of value sums in
// shared memory; the forces of each round summed per row (a shuffle tree
// per row of the round) into per-row arrays in shared memory, so that no
// force sum stays in a register across rounds: no value sum in local
// memory, and the Q_l math on full rounds of 32 pairs rather than on the
// lanes of the LJ and coordination rounds that lie inside Q_l's cut-off.
// With Vals alone (and not Split) the hit queue too is kept across the
// rows.
// Blocks per SM each sweep keeps: the values and force sweeps 5 (48
// registers a thread), the fused sweep and the monomial mode 4 (64; 3
// blocks at 80 registers measured slower, PERF.md).  Reading the box from constant memory (c_geo)
// took the values sweep to 54 registers, 4 blocks per SM and 9% of its
// time on Config 3's input, and a bound of 1 lets the compiler take more
// than 64.
// The wide layout: the general monomial mode (runtime degrees) 3 (80): at
// 4 blocks its fused sweep spilled; the recurrence's values and force
// sweeps 4 (64), its fused sweep 3 (at 4 it spilled 124 bytes; at 2, 128
// registers, it ran 15% slower; PERF.md).
template <bool WithLJ, bool Mono, int Lanes>
constexpr int min_blocks() {
  return Lanes == kLanesWide ? (Mono || WithLJ ? 3 : 4)
                             : WithLJ || Mono ? 4 : 5;
}

template <bool WithLJ, bool Vals, bool Grad, bool Valid, int Kinds, int L,
          int Lanes, bool Mono, bool Split = false>
__global__ void __launch_bounds__(kStageThreads,
                                  min_blocks<WithLJ || Split, Mono, Lanes>())
order_staged_kernel(const float* __restrict__ r, const int* __restrict__ pid,
                    const float* __restrict__ desc, int desc_len, int n_cvs,
                    int n_terms, const float* __restrict__ aux, int n_aux,
                    StagedParams p, float* __restrict__ f,
                    float* __restrict__ g, float* __restrict__ partials,
                    const float* __restrict__ cell_mask, int n_bvec) {
  using MS = MonoSmem<Mono, Vals, Grad, L>;
  constexpr bool kWide = Lanes == kLanesWide;
  extern __shared__ float4 s_pos[];  // (27 cap): x, y, z with the shift
  __shared__ float s_desc_n[desc_static<Lanes>()];
  __shared__ __align__(16) float s_aux_n[aux_static<Mono, Lanes>()];
  __shared__ float s_red_n[red_static<Lanes>()];
  __shared__ float s_box[6];  // fractional lo (3) and hi (3) of the i rows
  const int cap = p.g.cap;
  const int n_pad = p.g.n_pad;
  const int C = p.g.cx * p.g.cy * p.g.cz;
  const int cell = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const cell_stage::Scratch sc = cell_stage::scratch_at(
      s_pos + cell_stage::kOffsets * cap, cap);
  // this warp's MonoSmem past the scratch
  float* const m_warp =
      reinterpret_cast<float*>(
          reinterpret_cast<char*>(s_pos + cell_stage::kOffsets * cap) +
          cell_stage::scratch_bytes(cap, MS::kScratchWarps)) +
      warp * MS::kWarpWords;
  // the descriptor, the aux lanes and the warps' value sums (kStageWarps
  // rows of red_ld): the static arrays, or in the wide layout WideSmem's
  // from the 16-byte boundary past the last warp's MonoSmem
  constexpr bool kWideRec = kWide && !Mono;
  const WideSmem ws(desc_len, n_aux, n_bvec, n_terms, Mono, Grad, Vals,
                    WithLJ, cap);
  float* const wide =
      kWide ? reinterpret_cast<float*>(
                  (reinterpret_cast<size_t>(
                       m_warp + (kStageWarps - warp) * MS::kWarpWords) +
                   15) &
                  ~static_cast<size_t>(15))
            : nullptr;
  float* const s_desc = kWide ? wide + ws.desc : s_desc_n;
  float* const s_aux = kWide ? wide + ws.aux : s_aux_n;
  float* const s_red = kWide ? wide + ws.red : s_red_n;
  const int red_ld = kWide ? n_terms : kMaxTerms;
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
  // the general monomial mode and the wide recurrence: the largest degree
  // and cut-off of their Q_l
  int l_max = 0;
  float rc2_q = 0.0f;
  if constexpr (MS::kGen || kWideRec) {
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = s_desc + c * kHdr;
      if (static_cast<int>(h[0]) == kQl) {
        l_max = max(l_max, static_cast<int>(h[1]));
        rc2_q = fmaxf(rc2_q, h[5]);
      }
    }
    if (Vals) {
      for (int k = threadIdx.x; k < kStageWarps * n_terms;
           k += kStageThreads) {
        s_red[k] = 0.0f;
      }
    }
    if (kWideRec && (WithLJ || Grad)) {
      for (int k = threadIdx.x; k < 6 * cap; k += kStageThreads) {
        wide[ws.fsum + k] = 0.0f;
      }
    }
  }
  if constexpr (MS::kGen && Grad) {
    // per Q_l: a = C^T (Re, Im) of its aux lanes (m in order) into the
    // scratch at its value lanes, then b_a = D_a a into its force vectors
    // (bvec + h[6]; C, then the columns and values of D_x, D_y, D_z: its
    // table in the descriptor); the staging's barriers order them before
    // the sweep
    float* const conv = wide + ws.conv;
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = s_desc + c * kHdr;
      if (static_cast<int>(h[0]) != kQl) continue;
      const int l = static_cast<int>(h[1]);
      const int nm = n_mono(l);
      const float* tab = s_desc + static_cast<int>(h[4]);
      const float* re_im = s_aux + static_cast<int>(h[3]);
      for (int t = threadIdx.x; t < nm; t += kStageThreads) {
        float a = 0.0f;
        for (int m = 0; m < 2 * (l + 1); ++m) a += tab[m * nm + t] * re_im[m];
        conv[static_cast<int>(h[2]) + t] = a;
      }
    }
    __syncthreads();
    for (int c = 0; c < n_cvs; ++c) {
      const float* h = s_desc + c * kHdr;
      if (static_cast<int>(h[0]) != kQl) continue;
      const int l = static_cast<int>(h[1]);
      const int nb = n_mono(l - 1);
      const float* cols =
          s_desc + static_cast<int>(h[4]) + 2 * (l + 1) * n_mono(l);
      const float* a = conv + static_cast<int>(h[2]);
      float* const b = wide + ws.bvec + static_cast<int>(h[6]);
      for (int j = threadIdx.x; j < 4 * nb; j += kStageThreads) {
        const int t = j >> 2;
        const int ax = j & 3;
        b[j] = ax < 3 ? cols[3 * nb + ax * nb + t] *
                            a[static_cast<int>(cols[ax * nb + t])]
                      : 0.0f;
      }
    }
  }
  if constexpr (MS::kOn && !MS::kGen && Grad) {
    // b_a = D_a C^T (Re, Im) of the Q_6's aux lanes into s_aux, by warp 1
    // (its share of the staging below is one column of the nine, warp 0's
    // two): lane t < 28 forms a_t, then lane j takes b_j = value_j
    // a[column_j] from that lane; read after the staging's barriers
    if (warp == 1) {
      const float* h = s_desc + mono_cv<Lanes>(s_desc, n_cvs) * kHdr;
      const float* re_im = s_aux + static_cast<int>(h[3]);
      const float* tab = s_desc + static_cast<int>(h[4]);
      float a = 0.0f;
      if (lane < kMono6) {
#pragma unroll
        for (int m = 0; m < kY6; ++m) a += tab[m * kMono6 + lane] * re_im[m];
      }
#pragma unroll
      for (int j = lane; j < 64; j += 32) {
        const int jj = j < 3 * kMono5 ? j : 0;
        const float v =
            tab[kMonoDval + jj] *
            __shfl_sync(cell_stage::kFull, a,
                        static_cast<int>(tab[kMonoDcol + jj]));
        if (j < 3 * kMono5) s_aux[kMonoB + 4 * (j % kMono5) + j / kMono5] = v;
      }
    }
  }
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
  // the per-thread value sums (none in the wide recurrence)
  constexpr int kTerms = Vals && !kWideRec ? lane_count<Lanes, Mono>() : 1;
  // compile-time in the fixed layouts, so their loops over t unroll
  const int nt = !Vals ? 0 : fixed_lanes(Lanes) ? kTerms : n_terms;
  float vacc[kTerms];
  if constexpr (!kWideRec) {
#pragma unroll
    for (int t = 0; t < nt; ++t) vacc[t] = 0.0f;
  }
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
  // the LJ force of a pair inside r_cut (WithLJ)
  auto lj = [&](float dx, float dy, float dz, float r2, float& fx, float& fy,
                float& fz) {
    if (WithLJ && r2 < p.rc2_lj) {
      const float inv = 1.0f / r2;
      const float s2 = p.sig2 * inv;
      const float s6 = s2 * s2 * s2;
      const float coef = p.eps4 * (12.0f * s6 * s6 - 6.0f * s6) * inv;
      fx += coef * dx;
      fy += coef * dy;
      fz += coef * dz;
    }
  };
  // the i row's outputs: LJ and bias force summed over the warp
  auto write_row = [&](int ii, float fx, float fy, float fz, float gx,
                       float gy, float gz) {
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
  };

  // the monomial mode: the Q_6's header at qc (0 at compile time in the
  // fixed layouts), its value lanes from vq (the monomial sums, then its
  // bond count)
  const int qc = MS::kOn && !MS::kGen ? mono_cv<Lanes>(s_desc, n_cvs) : 0;
  const int vq = MS::kOn && !MS::kGen && Vals && Lanes == kLanesAny
                     ? static_cast<int>(s_desc[qc * kHdr + 2])
                     : 0;
  float tacc = 0.0f;
  if constexpr (kWideRec) {
    int* const queue_q =
        reinterpret_cast<int*>(wide + ws.qq) + warp * cell_stage::kQueue;
    float* const tile = wide + ws.tile + warp * kWideTileRows * kTileLd;
    // (cap, 3) each: the rows' LJ force and bias force
    float* const fsum = wide + ws.fsum;
    float* const gsum = wide + ws.gsum;
    float* const red = s_red + warp * red_ld;
    constexpr bool kPerRow = WithLJ || Grad || Split;
    wide_sweep<kPerRow>(
        warp, n_i, kStageWarps, n_rows, queue, queue_q,
        [&](int i, int q) { return hit(s_pos[i0 + i], q); },
        [&](int e, bool live) -> bool {
          float dx = 0.0f, dy = 0.0f, dz = 0.0f, r2 = 0.0f;
          float fx = 0.0f, fy = 0.0f, fz = 0.0f;
          float gx = 0.0f, gy = 0.0f, gz = 0.0f;
          if (live) {
            r2 = geom(s_pos[i0 + (e >> 16)], e & 0xffff, &dx, &dy, &dz);
            lj(dx, dy, dz, r2, fx, fy, fz);
          }
          wide_others<Vals, Grad>(s_desc, n_cvs, s_aux, red, live, dx, dy,
                                  dz, r2, gx, gy, gz);
          if constexpr (kPerRow && (WithLJ || Grad)) {
            // a round of the hit queue holds one row (flushed per row), its
            // live lanes first: its forces by shuffle trees into the row's
            // sums (lane 0, if live: a round with none is another warp's
            // row 0), so no sum lives across the Q_l rounds
            const int row = __shfl_sync(cell_stage::kFull, e >> 16, 0);
            if (WithLJ) {
              fx = cell_stage::warp_sum(fx);
              fy = cell_stage::warp_sum(fy);
              fz = cell_stage::warp_sum(fz);
              if (lane == 0 && live) {
                fsum[3 * row] += fx;
                fsum[3 * row + 1] += fy;
                fsum[3 * row + 2] += fz;
              }
            }
            if (Grad) {
              gx = cell_stage::warp_sum(gx);
              gy = cell_stage::warp_sum(gy);
              gz = cell_stage::warp_sum(gz);
              if (lane == 0 && live) {
                gsum[3 * row] += gx;
                gsum[3 * row + 1] += gy;
                gsum[3 * row + 2] += gz;
              }
            }
          }
          return live && r2 < rc2_q;
        },
        [&](int e, bool live) {
          const int i = e >> 16;
          float dx = 0.0f, dy = 0.0f, dz = 1.0f, r2 = 1.0f;
          if (live) r2 = geom(s_pos[i0 + i], e & 0xffff, &dx, &dy, &dz);
          float qx = 0.0f, qy = 0.0f, qz = 0.0f;
          ql_round<Vals, Grad>(s_desc, n_cvs, s_aux, tile, red, live, dx, dy,
                               dz, r2, qx, qy, qz);
          if constexpr (Grad) {
            // each row of the round in turn: its lanes' forces by a
            // shuffle tree into its gsum row (lane 0)
            unsigned rem = __ballot_sync(cell_stage::kFull, live);
            while (rem != 0u) {
              const int row = __shfl_sync(cell_stage::kFull, i,
                                          __ffs(rem) - 1);
              const unsigned seg =
                  __ballot_sync(cell_stage::kFull, live && i == row);
              const bool mine = (seg >> lane) & 1u;
              const float sx = cell_stage::warp_sum(mine ? qx : 0.0f);
              const float sy = cell_stage::warp_sum(mine ? qy : 0.0f);
              const float sz = cell_stage::warp_sum(mine ? qz : 0.0f);
              if (lane == 0) {
                gsum[3 * row] += sx;
                gsum[3 * row + 1] += sy;
                gsum[3 * row + 2] += sz;
              }
              rem &= ~seg;
            }
          }
        });
    // the warp's rows' forces, summed by lane 0 (the sweep ended
    // converged)
    for (int ii = warp + lane * kStageWarps; ii < n_i;
         ii += 32 * kStageWarps) {
      const int s = sc.islot[ii];
      if (WithLJ) {
        f[s] = fsum[3 * ii];
        f[n_pad + s] = fsum[3 * ii + 1];
        f[2 * n_pad + s] = fsum[3 * ii + 2];
      }
      if (Grad) {
        g[s] = gsum[3 * ii];
        g[n_pad + s] = gsum[3 * ii + 1];
        g[2 * n_pad + s] = gsum[3 * ii + 2];
      }
    }
  } else if constexpr (MS::kGen) {
    // the general monomial mode: the Q_l pairs on their own queue, each
    // round through mono_round
    int* const mqueue = reinterpret_cast<int*>(m_warp);
    int* const queue_q = mqueue + cell_stage::kQueue;
    float* const pw = m_warp + MS::kQueueWords;
    float* const red = s_red + warp * red_ld;
    const float* const bvec = wide + ws.bvec;
    for (int ii = warp; ii < n_i; ii += kStageWarps) {
      const float4 xi = s_pos[i0 + ii];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      float gx = 0.0f, gy = 0.0f, gz = 0.0f;
      mono_sweep(
          n_rows, mqueue, queue_q,
          [&](int q) { return hit(xi, q); },
          [&](int q, bool live) -> bool {
            if (!live) return false;
            float dx, dy, dz;
            const float r2 = geom(xi, q, &dx, &dy, &dz);
            lj(dx, dy, dz, r2, fx, fy, fz);
            mono_others<Vals, Grad, Kinds, Lanes>(s_desc, n_cvs, s_aux, dx,
                                                  dy, dz, r2, vacc, gx, gy,
                                                  gz);
            return r2 < rc2_q;
          },
          [&](int q, bool live) {
            float dx = 0.0f, dy = 0.0f, dz = 0.0f, r2 = 0.0f;
            if (live) r2 = geom(xi, q, &dx, &dy, &dz);
            mono_round<Vals, Grad>(s_desc, n_cvs, bvec, pw, red, l_max, live,
                                   dx, dy, dz, r2, gx, gy, gz);
          });
      write_row(ii, fx, fy, fz, gx, gy, gz);
    }
  } else if constexpr (MS::kOn) {
    // Q_6's cut-off and the i row read from shared memory where used:
    // two registers fewer across the sweep, none spilled
    auto rc2_q = [&]() -> float { return s_desc[qc * kHdr + 5]; };
    int* const mqueue = reinterpret_cast<int*>(m_warp);
    int* const queue_q = mqueue + cell_stage::kQueue;
    float* const tile = m_warp + MS::kQueueWords;
    const float4* const bvec = reinterpret_cast<const float4*>(s_aux + kMonoB);
    for (int ii = warp; ii < n_i; ii += kStageWarps) {
      const float4 xi = s_pos[i0 + ii];
      float fx = 0.0f, fy = 0.0f, fz = 0.0f;
      float gx = 0.0f, gy = 0.0f, gz = 0.0f;
      mono_sweep(
          n_rows, mqueue, queue_q,
          [&](int q) { return hit(xi, q); },
          [&](int q, bool live) -> bool {
            if (!live) return false;
            float dx, dy, dz;
            const float r2 = geom(xi, q, &dx, &dy, &dz);
            lj(dx, dy, dz, r2, fx, fy, fz);
            mono_others<Vals, Grad, Kinds, Lanes>(s_desc, n_cvs, s_aux, dx,
                                                  dy, dz, r2, vacc, gx, gy,
                                                  gz);
            return r2 < rc2_q();
          },
          [&](int q, bool live) {
            float dx = 0.0f, dy = 0.0f, dz = 0.0f, r2 = 0.0f;
            if (live) {
              r2 = geom(s_pos[i0 + ii], q, &dx, &dy, &dz);
            }
            const bool on = live && r2 < rc2_q();
            // one column of this warp's tile per Q_6 pair, in lane order
            unsigned mq = 0u;
            if constexpr (MS::kTile) {
              mq = __ballot_sync(cell_stage::kFull, on);
              if (mq == 0u) return;  // the same on every lane
            }
            if (on) {
              // the force from u and its monomials of degrees 2 and 3,
              // then the values from the degree-3 ones
              const float inv_r = rsqrtf(r2);
              float m1[3], m2[n_mono(2)], m3[n_mono(3)];
              mono_low(dx, dy, dz, inv_r, m1, m2, m3);
              if constexpr (Grad) {
                q6_mono_grad(bvec, m1, m2, m3, inv_r, gx, gy, gz);
              }
              if constexpr (MS::kTile) {
                float* const column = tile + __popc(mq & ((1u << lane) - 1u));
                each_mono<6>(m3, m3,
                             [&](int t, float v) { column[t * kTileLd] = v; });
              }
            }
            if constexpr (MS::kTile) {
              // lane t < 28 adds row t in column order, lane 28 the count
              __syncwarp();
              const int n_on = __popc(mq);
              if (lane < kMono6) {
                for (int c = 0; c < n_on; ++c) tacc += tile[lane * kTileLd + c];
              } else if (lane == kMono6) {
                tacc += static_cast<float>(n_on);
              }
              __syncwarp();
            }
          });
      write_row(ii, fx, fy, fz, gx, gy, gz);
    }
  } else if constexpr (Vals && !Grad && !WithLJ && !Split) {
    float unused = 0.0f;
    cell_stage::warp_sweep_rows(
        i0 + warp, i0 + n_i, kStageWarps, n_rows, queue,
        [&](int i, int q) { return hit(s_pos[i], q); },
        [&](int i, int q) {
          float dx, dy, dz;
          const float r2 = geom(s_pos[i], q, &dx, &dy, &dz);
          cv_pair<true, false, Kinds, L, Lanes>(
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
            lj(dx, dy, dz, r2, fx, fy, fz);
            if constexpr (!Mono) {
              cv_pair<Vals, Grad, Kinds, L, Lanes>(
                  s_desc, n_cvs, s_aux, dx, dy, dz, r2, vacc, gx, gy, gz);
            }
          });
      write_row(ii, fx, fy, fz, gx, gy, gz);
    }
  }

  if (Vals) {
    // a shuffle tree per term (the tile's terms: lane t's sum), then the
    // warps in order into the cell's row; the general monomial mode adds
    // the trees (its Q_l lanes' sums are in the row already, their vacc
    // zero)
    if constexpr (MS::kTile) {
      if (lane <= kMono6) s_red[warp * red_ld + vq + lane] = tacc;
    }
    if constexpr (!kWideRec) {
#pragma unroll
      for (int t = 0; t < nt; ++t) {
        if (MS::kTile && t >= vq && t <= vq + kMono6) continue;
        const float v = cell_stage::warp_sum(vacc[t]);
        if (lane == 0) {
          if (MS::kGen) {
            s_red[warp * red_ld + t] += v;
          } else {
            s_red[warp * red_ld + t] = v;
          }
        }
      }
    }
    __syncthreads();
    const float m = cell_mask != nullptr ? cell_mask[cell] : 1.0f;
    for (int t = threadIdx.x; t < nt; t += kStageThreads) {
      float acc = 0.0f;
      for (int w = 0; w < kStageWarps; ++w) acc += s_red[w * red_ld + t];
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

// The monomial mode's second pass: every partials lane summed as
// reduce_terms_kernel sums it, then written as the recurrence's value lanes,
// the descriptor's CVs in order: a Q_l's Re and Im lanes C . (its
// monomial sums) in double, k = 0..n_mono(l) - 1 in order, then its bond
// count; a coordination's lane as summed.  out: the recurrence's lanes
// (2 (l + 1) + 1 per Q_l, 1 per coordination).  Two calls give the same
// bits.
__global__ void __launch_bounds__(kMonoReduceThreads)
reduce_mono_kernel(const float* __restrict__ partials, int n_blocks,
                   int n_terms, const float* __restrict__ desc, int n_cvs,
                   float* __restrict__ out) {
  __shared__ double s_sum[kMaxLanes];
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n_terms;
       t += kMonoReduceThreads / 32) {
    double acc = 0.0;
#pragma unroll 4
    for (int b = lane; b < n_blocks; b += 32) acc += partials[b * n_terms + t];
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(cell_stage::kFull, acc, off);
    }
    if (lane == 0) s_sum[t] = acc;
  }
  __syncthreads();
  const int k = threadIdx.x;  // this thread's output lane
  int dec = 0;
  for (int c = 0; c < n_cvs; ++c) {
    const float* h = desc + c * kHdr;
    const int vo = static_cast<int>(h[2]);
    const bool ql = static_cast<int>(h[0]) == kQl;
    const int l = static_cast<int>(h[1]);
    const int ny = ql ? 2 * (l + 1) : 0;  // Re and Im lanes
    const int nm = ql ? n_mono(l) : 0;
    const int width = ny + 1;
    if (k >= dec && k < dec + width) {
      const int j = k - dec;
      double v = 0.0;
      if (j < ny) {
        const float* C = desc + static_cast<int>(h[4]);
        for (int t = 0; t < nm; ++t) {
          v += static_cast<double>(C[j * nm + t]) * s_sum[vo + t];
        }
      } else {
        v = s_sum[vo + nm];
      }
      out[k] = static_cast<float>(v);
    }
    dec += width;
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
  float* out;       // (n_terms,) with Vals; Mono: the recurrence's lanes
  const float* cell_mask;  // (cells,) value weights with Vals, or null
  int n_bvec;  // Mono: the Q_l's force vectors, 4 n_mono(l - 1) floats each
};

// Launches one instantiation on a block per cell, and with Vals the second
// pass.  Returns 0, a CUDA error of the shared-memory request, or
// cell_stage::kSmemTooLarge when cap does not fit a block's shared memory.
template <bool WithLJ, bool Vals, bool Grad, bool Valid, int Kinds, int L,
          int Lanes, bool Mono = false, bool Split = false>
int launch_staged(const StagedArgs& a, cudaStream_t st) {
  size_t smem = staged_smem<Mono, Vals, Grad, L>(a.p.g.cap);
  if constexpr (Lanes == kLanesWide) {
    // WideSmem's arrays from the next 16-byte boundary
    smem = (smem + 15) / 16 * 16 +
           sizeof(float) * WideSmem(a.desc_len, a.n_aux, a.n_bvec,
                                    a.n_terms, Mono, Grad, Vals, WithLJ,
                                    a.p.g.cap)
                               .words;
  }
  auto kernel = order_staged_kernel<WithLJ, Vals, Grad, Valid, Kinds, L,
                                    Lanes, Mono, Split>;
  const int rc =
      cell_stage::request_smem(kernel, smem, static_smem<Mono, Lanes>());
  if (rc != 0) return rc;
  const cudaError_t copied = cudaMemcpyToSymbolAsync(
      c_geo, a.p.g.box, sizeof(cell_geom::BoxRow), 0,
      cudaMemcpyDeviceToDevice, st);
  if (copied != cudaSuccess) return static_cast<int>(copied);
  const int n_cells = a.p.g.cx * a.p.g.cy * a.p.g.cz;
  kernel<<<n_cells, kStageThreads, smem, st>>>(
      a.r, a.pid, a.desc, a.desc_len, a.n_cvs, a.n_terms, a.aux, a.n_aux,
      a.p, a.f, a.g, a.partials, a.cell_mask, a.n_bvec);
  if constexpr (Vals && Mono) {
    reduce_mono_kernel<<<1, kMonoReduceThreads, 0, st>>>(
        a.partials, n_cells, a.n_terms, a.desc, a.n_cvs, a.out);
  } else if constexpr (Vals) {
    reduce_terms_kernel<<<1, kReduceThreads, 0, st>>>(a.partials, n_cells,
                                                      a.n_terms, a.out);
  }
  return 0;
}

// Picks the instantiation of a CV list: cv_set (kSet*), l_fixed (6 if every
// Q_l has l = 6, in the monomial mode if the list has one Q_l and its l is
// 6; else 0), lanes (kLanes*; with Vals only, else ignored).  A plan past
// the narrow arrays (kMaxDesc, kMaxTerms, kMaxAux), and the monomial mode
// (Mono) with l_fixed = 0, run the wide layout, the kinds read per CV:
// any list within kMaxLanes value and aux lanes (check_args).  Returns
// launch_staged's code, or cudaErrorInvalidValue for a combination without
// an instantiation.
template <bool WithLJ, bool Vals, bool Grad, bool Valid, bool Mono = false,
          bool Split = false>
int launch_staged_set(int cv_set, int l_fixed, int lanes,
                      const StagedArgs& a, cudaStream_t st) {
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  if (l_fixed != 0 && l_fixed != 6) return bad;
  if ((Mono && l_fixed != 6) || a.desc_len > kMaxDesc ||
      a.n_terms > kMaxTerms || a.n_aux > kMaxAux) {
    if (Vals && lanes != kLanesAny) return bad;
    return launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 0, kLanesWide,
                         Mono, Split>(a, st);
  }
  if (Mono && cv_set == kSetCoord) return bad;
  if constexpr (Vals) {
    if (lanes == kLanesQ6) {
      if (cv_set != kSetQl || l_fixed != 6 || a.n_cvs != 1 ||
          a.n_terms != q6_terms<Mono>()) {
        return bad;
      }
      return launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6, kLanesQ6,
                           Mono, Split>(a, st);
    }
    if (lanes == kLanesQ6Coord) {
      if (cv_set != kSetMixed || l_fixed != 6 || a.n_cvs != 2 ||
          a.n_terms != q6_terms<Mono>() + 1) {
        return bad;
      }
      return launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                           kLanesQ6Coord, Mono, Split>(a, st);
    }
    if (lanes != kLanesAny) return bad;
  }
  if constexpr (Mono && Vals) {
    // one Q_6 alone has the fixed layout kLanesQ6
    return cv_set == kSetMixed
               ? launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                               kLanesAny, true, Split>(a, st)
               : bad;
  } else if constexpr (Mono) {
    return cv_set == kSetQl
               ? launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6,
                               kLanesAny, true, Split>(a, st)
               : launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                               kLanesAny, true, Split>(a, st);
  } else {
    switch (cv_set) {
      case kSetQl:
        return l_fixed
                   ? launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 6,
                                   kLanesAny, false, Split>(a, st)
                   : launch_staged<WithLJ, Vals, Grad, Valid, kSetQl, 0,
                                   kLanesAny, false, Split>(a, st);
      case kSetCoord:
        return launch_staged<WithLJ, Vals, Grad, Valid, kSetCoord, 0,
                             kLanesAny, false, Split>(a, st);
      case kSetMixed:
        return l_fixed
                   ? launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 6,
                                   kLanesAny, false, Split>(a, st)
                   : launch_staged<WithLJ, Vals, Grad, Valid, kSetMixed, 0,
                                   kLanesAny, false, Split>(a, st);
      default: return bad;
    }
  }
}

}  // namespace order_cv
