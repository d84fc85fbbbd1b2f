// Pair and bond terms shared by the two pair-force kernels
// (packed_lj_force.cu, packed_lj_force_v1.cu), and their deterministic
// energy/virial reduction.
//
// Each term returns the force coefficient c of the pair, f_i = c (r_i - r_j),
// and with energy writes the pair energy.  They follow the plain PyTorch
// version term for term (ops/packed.py: packed_lj_force, _fene_wca_pair).

#pragma once

#include <cuda_runtime.h>

namespace pair_terms {

constexpr float kVacantThr = 1.0e6f;  // ops/packed.py VACANT_THR
constexpr int kBondNone = 0;
constexpr int kBondFene = 1;
constexpr int kBondHarmonic = 2;
// Bond slots whose partner pids an i row keeps in registers; the others
// (any number) it reads from shared memory.
constexpr int kRegBondSlots = 4;

// Lennard-Jones 4 eps ((s/r)^12 - (s/r)^6), shifted to 0 at r_cut when
// `shift` is set.  eps4 = 4 eps, sig2 = sigma^2.
template <bool WithEnergy>
__device__ __forceinline__ float lj_term(float r2, float eps4, float sig2,
                                         float rc2, bool shift, float* e) {
  const float inv = 1.0f / r2;
  const float s2 = sig2 * inv;
  const float s6 = s2 * s2 * s2;
  const float s12 = s6 * s6;
  if (WithEnergy) {
    float ee = eps4 * (s12 - s6);
    if (shift) {
      const float sc2 = sig2 / rc2;
      const float sc6 = sc2 * sc2 * sc2;
      ee -= eps4 * (sc6 * sc6 - sc6);
    }
    *e = ee;
  }
  return eps4 * (12.0f * s12 - 6.0f * s6) * inv;
}

// The soft (DPD-conservative) push-off pair u = a rc/2 (1 - r/rc)^2 inside
// rc, a = eps_ij: a finite force at r -> 0, so overlapping beads separate.
template <bool WithEnergy>
__device__ __forceinline__ float soft_term(float r2, float a, float rc,
                                           float* e) {
  const float r = sqrtf(r2);
  const float x = 1.0f - r / rc;
  if (WithEnergy) *e = 0.5f * a * rc * x * x;
  return a * x / r;
}

// The bond term that replaces the pair term of a bonded pair, at any
// distance: FENE -k r0^2/2 ln(1 - r^2/r0^2) (the argument clipped at 0.99)
// plus WCA at the pair's eps and sigma (Kremer-Grest), or the harmonic
// spring k (r - r0)^2 / 2.
template <int Bond, bool WithEnergy>
__device__ __forceinline__ float bond_term(float r2, float eps, float sig2,
                                           float k, float r0, float* e) {
  if (Bond == kBondHarmonic) {
    const float r = sqrtf(r2);
    if (WithEnergy) *e = 0.5f * k * (r - r0) * (r - r0);
    return -k * (r - r0) / r;
  }
  const float r02 = r0 * r0;
  const float x = fminf(r2 / r02, 0.99f);
  float coef = -k / (1.0f - x);
  float ee = 0.0f;
  if (WithEnergy) ee = -0.5f * k * r02 * log1pf(-x);
  if (r2 < 1.2599210498948732f * sig2) {  // r < 2^(1/6) sigma
    const float s2 = sig2 / r2;
    const float s6 = s2 * s2 * s2;
    const float s12 = s6 * s6;
    coef += 4.0f * eps * (12.0f * s12 - 6.0f * s6) / r2;
    if (WithEnergy) ee += 4.0f * eps * (s12 - s6) + eps;
  }
  if (WithEnergy) *e = ee;
  return coef;
}

// Sums q = 0..3 of v over the block into partials[blockIdx.x * 4 + q]:
// a shuffle tree in each warp, then warp 0 adds the warps in order.  Every
// block writes its row in full.  blockDim.x is a multiple of 32, at most
// 1024.
__device__ __forceinline__ void block_partials(float v[4], float* partials) {
  __shared__ float sh[4][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < 4; ++q) {
    for (int off = 16; off > 0; off >>= 1) {
      v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
    }
    if (lane == 0) sh[q][warp] = v[q];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int n_warps = blockDim.x >> 5;
    float acc = 0.0f;
    for (int w = 0; w < n_warps; ++w) acc += sh[threadIdx.x][w];
    partials[blockIdx.x * 4 + threadIdx.x] = acc;
  }
}

constexpr int kReduceThreads = 128;

// One block per walker (gridDim.x walkers, each with n_blocks rows):
// out[w, q] = 1/2 * sum_b partials[w, b, q], q = (PE, Wxx, Wyy, Wzz).
// Thread t sums rows t, t + 128, ... in order, then a tree in shared
// memory: the same order on every call.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ out) {
  partials += static_cast<size_t>(blockIdx.x) * n_blocks * 4;
  out += blockIdx.x * 4;
  __shared__ double sh[4][kReduceThreads];
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads) {
    for (int q = 0; q < 4; ++q) acc[q] += partials[b * 4 + q];
  }
  for (int q = 0; q < 4; ++q) sh[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int q = 0; q < 4; ++q) {
        sh[q][threadIdx.x] += sh[q][threadIdx.x + half];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 4) {
    out[threadIdx.x] = static_cast<float>(0.5 * sh[threadIdx.x][0]);
  }
}

// Bond-partner attrs (partner pid + 1 as f32, 0 = none): the columns of
// the first n_reg <= kRegBondSlots slots, bp0..bp3, and the other n_more
// slots as one (n_more, walkers, n_pad) array `more` (null without them).
struct BondSlots {
  const float* bp[kRegBondSlots];
  const float* more;
  int n_reg;
  int n_more;
};

// BondSlots of bond_slots slots, the first four columns bp0..bp3 and the
// rest in `more`; false for a negative count or a missing array.
inline bool bond_slots_of(int bond_slots, const float* bp0, const float* bp1,
                          const float* bp2, const float* bp3,
                          const float* more, BondSlots* out) {
  if (bond_slots < 0) return false;
  out->n_reg = bond_slots < kRegBondSlots ? bond_slots : kRegBondSlots;
  out->n_more = bond_slots - out->n_reg;
  const float* cols[kRegBondSlots] = {bp0, bp1, bp2, bp3};
  for (int b = 0; b < kRegBondSlots; ++b) out->bp[b] = cols[b];
  out->more = more;
  return out->n_more == 0 || more != nullptr;
}

}  // namespace pair_terms
