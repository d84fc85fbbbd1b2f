// Pair force over the cell-major slot layout, version 1: Lennard-Jones over
// per-slot Lorentz-Berthelot parameters with optional bonds, energy and
// diagonal virial always.
//
// Replaces the TPU kernel `packed_lj_force_pallas` in
// metadyn_tpu/ops/packed_pallas.py (the full 27-offset sweep without Newton
// halving, kept as the cross-check of `packed_lj_force_pallas2`): eps_ij =
// se_i se_j, sigma_ij = hs_i + hs_j, energy shift per pair when the spec asks
// for it, bonded pairs (partner pid matched through the bp attrs, at any
// distance) get FENE + WCA or a harmonic spring instead of the pair term.
// No per-type tables, as in the reference.  Unlike the reference it applies
// the eps > 0 gate before the power chain: vacant slots (se = 0) drift in
// the per-slot layout, and two of them within r^2 ~ 1e-8 would give
// 0 * inf = NaN in the reference's arithmetic.
//
// What bounds it on Hopper: not device memory (the inputs, 24 bytes per slot
// plus the bond attrs, stay in L2).  The pair arithmetic over 27 * cap
// partners per slot and the shared-memory reads of the staged rows.
//
// Design, deliberately unlike kernel 1 (packed_lj_force.cu), so that the two
// cross-check each other: one block per cell stages the rows of its 27
// neighbour cells in shared memory once (positions with the periodic shift
// already applied, se, hs, pid + 1: 27 * cap * 6 floats, 26 KB at cap 40),
// then each thread walks the staged rows for its own i slot of the cell.
// Orthorhombic or tilted box: the shift of each neighbour cell is h u
// (cell_geom.cuh), formed once per cell and thread while staging.
// Threads are cap rounded up to a warp.  Energy and virial: a fixed-order
// block sum into one partials row per cell and a one-block double-precision
// second pass (pair_terms.cuh).  Every output element is written.

#include <cuda_runtime.h>

#include "cell_geom.cuh"
#include "pair_terms.cuh"

namespace {

using pair_terms::BondSlots;
using pair_terms::kBondFene;
using pair_terms::kBondHarmonic;
using pair_terms::kBondNone;

constexpr int kRows = 6;  // staged per partner: x, y, z, se, hs, pid + 1

struct Params {
  int n_pad;
  int cap;
  int cx, cy, cz;
  int shift_energy;
  const float* box;  // (kBoxRow,) f32 geometry row in device memory
  float rc2;
  float bond_k;
  float bond_r0;
};

template <int Bond>
__global__ void lj_force_v1_kernel(const float* __restrict__ r,
                                   const float* __restrict__ se,
                                   const float* __restrict__ hs,
                                   const int* __restrict__ pid, BondSlots bp,
                                   float* __restrict__ f,
                                   float* __restrict__ partials, Params p) {
  extern __shared__ float stage[];  // (kRows, 27 * cap)
  const int C = p.cx * p.cy * p.cz;
  const int n_pad = p.n_pad;
  const int cell = blockIdx.x;
  const int n_stage = 27 * p.cap;
  const int iz = cell % p.cz;
  const int iy = (cell / p.cz) % p.cy;
  const int ix = cell / (p.cy * p.cz);
  const cell_geom::HBox h = cell_geom::load_box(p.box, 0);

  for (int o = 0; o < 27; ++o) {
    float3 sh;
    const int jcell = cell_geom::neighbour_cell(
        ix, iy, iz, o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1, p.cx, p.cy, p.cz,
        h, &sh);
    for (int k = threadIdx.x; k < p.cap; k += blockDim.x) {
      const int q = o * p.cap + k;
      const int j = k * C + jcell;
      stage[q] = r[j] + sh.x;
      stage[n_stage + q] = r[n_pad + j] + sh.y;
      stage[2 * n_stage + q] = r[2 * n_pad + j] + sh.z;
      stage[3 * n_stage + q] = se[j];
      stage[4 * n_stage + q] = hs[j];
      stage[5 * n_stage + q] =
          Bond != kBondNone ? static_cast<float>(pid[j] + 1) : 0.0f;
    }
  }
  __syncthreads();

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // PE, Wxx, Wyy, Wzz
  if (threadIdx.x < p.cap) {
    const int s = threadIdx.x * C + cell;
    const float xi = r[s];
    const float yi = r[n_pad + s];
    const float zi = r[2 * n_pad + s];
    const float se_i = se[s];
    const float hs_i = hs[s];
    float bp_i[pair_terms::kMaxBondSlots];
    for (int b = 0; b < bp.n; ++b) bp_i[b] = bp.bp[b][s];
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    for (int q = 0; q < n_stage; ++q) {
      const float dx = xi - stage[q];
      const float dy = yi - stage[n_stage + q];
      const float dz = zi - stage[2 * n_stage + q];
      const float r2 = dx * dx + dy * dy + dz * dz;
      bool bonded = false;
      if (Bond != kBondNone) {
        const float pj = stage[5 * n_stage + q];
        for (int b = 0; b < bp.n; ++b) bonded |= bp_i[b] == pj;
        bonded &= r2 > 1.0e-12f;
      }
      const float eps = se_i * stage[3 * n_stage + q];
      const bool inside = r2 < p.rc2 && r2 > 1.0e-12f && eps > 0.0f;
      if (!(inside || bonded)) continue;
      const float sig = hs_i + stage[4 * n_stage + q];
      float e;
      const float coef =
          bonded ? pair_terms::bond_term<Bond, true>(r2, eps, sig * sig,
                                                     p.bond_k, p.bond_r0, &e)
                 : pair_terms::lj_term<true>(r2, 4.0f * eps, sig * sig, p.rc2,
                                             p.shift_energy != 0, &e);
      fx += coef * dx;
      fy += coef * dy;
      fz += coef * dz;
      acc[0] += e;
      acc[1] += coef * dx * dx;
      acc[2] += coef * dy * dy;
      acc[3] += coef * dz * dz;
    }
    f[s] = fx;
    f[n_pad + s] = fy;
    f[2 * n_pad + s] = fz;
  }
  pair_terms::block_partials(acc, partials);
}

template <int Bond>
int launch(const float* r, const float* se, const float* hs, const int* pid,
           BondSlots bp, float* f, float* partials, float* out, Params p,
           cudaStream_t st) {
  const int C = p.cx * p.cy * p.cz;
  const int threads = ((p.cap + 31) / 32) * 32;
  const size_t smem = sizeof(float) * kRows * 27 * p.cap;
  if (threads > 1024) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lj_force_v1_kernel<Bond>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lj_force_v1_kernel<Bond><<<C, threads, smem, st>>>(r, se, hs, pid, bp, f,
                                                     partials, p);
  pair_terms::reduce_partials_kernel<<<1, pair_terms::kReduceThreads, 0,
                                       st>>>(partials, C, out);
  return 0;
}

}  // namespace

extern "C" {

// r: (3, n_pad) f32; se, hs: (n_pad,) f32; pid: (n_pad,) i32 (may be null
// without bonds); bp0..bp3: the first bond_slots bond-partner attrs; f:
// (3, n_pad) f32 out; partials: (C, 4) f32 scratch (one row per cell); out:
// (4,) f32 = (PE, Wxx, Wyy, Wzz).  Launches on `stream` and returns
// cudaGetLastError() (0 on success), -1 for a cap above 1024 or an unknown
// bond kind.  box: (kBoxRow,) f32 in device memory, the box's geometry row
// (cell_geom.cuh BoxRow; zero tilt for an orthorhombic box).
int packed_lj_force_v1(const float* r, const float* se, const float* hs,
                       const int* pid, const float* bp0, const float* bp1,
                       const float* bp2, const float* bp3, float* f,
                       float* partials, float* out, int n_pad, int cap,
                       int cx, int cy, int cz, int bond_kind, int bond_slots,
                       int shift_energy, const float* box, float rc2,
                       float bond_k, float bond_r0, void* stream) {
  if (bond_slots < 0 || bond_slots > pair_terms::kMaxBondSlots) return -1;
  BondSlots bp{{bp0, bp1, bp2, bp3}, bond_slots};
  Params p{n_pad, cap, cx, cy, cz, shift_energy, box, rc2, bond_k, bond_r0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (bond_kind) {
    case kBondNone:
      rc = launch<kBondNone>(r, se, hs, pid, bp, f, partials, out, p, st);
      break;
    case kBondFene:
      rc = launch<kBondFene>(r, se, hs, pid, bp, f, partials, out, p, st);
      break;
    case kBondHarmonic:
      rc = launch<kBondHarmonic>(r, se, hs, pid, bp, f, partials, out, p,
                                 st);
      break;
    default:
      return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
