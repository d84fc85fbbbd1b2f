// Pair force over the cell-major slot layout: Lennard-Jones with optional
// per-slot parameters, per-type-pair scale tables and bonds.
//
// Replaces the TPU kernel `packed_lj_force_pallas2` in
// metadyn_tpu/ops/packed_pallas2.py in these variants, each in an
// orthorhombic or a tilted (triclinic) box:
//   (a) the sentinel layout: uniform sigma and epsilon, vacant slots parked
//       at the coordinate sentinel VACANT_X (1e7) and culled by the r^2
//       tests alone;
//   (b) per-slot Lorentz-Berthelot parameters, eps_ij = se_i se_j (se =
//       sqrt(eps)) and sigma_ij = hs_i + hs_j (hs = sigma / 2) or a uniform
//       sigma; vacant slots have se = 0 and are not pinned, so they drift,
//       and the eps > 0 gate runs before the power chain (0 * inf = NaN);
//   (c) per-type-pair scale tables on (b): eps_ij and sigma_ij times
//       k(t_i, t_j), read from a small device table indexed by the integer
//       types (the TPU kernel's bilinear FMA form evaluated once on the host,
//       so the values are the plain version's);
//   (d) bonds on (b) or (c): partners matched by pid through the bp attrs
//       (partner pid + 1, 0 = none), at any distance, not gated on r_cut;
//       a bonded pair gets FENE + WCA at the pair's (table-scaled) eps and
//       sigma, or a harmonic spring, instead of the pair term.
//
// Layout (ops/packed.py): positions are a (3, Npad) f32 array, slot =
// rank * C + cell, cell = (ix * cy + iy) * cz + iz, cells binned in fractional
// coordinates.  A cell's partners are the `cap` rows of each of the 27
// neighbour cells; a neighbour that wraps past a box face is seen at x_j + h u
// with u in {-1, 0, 1}^3 (cell_geom.cuh: one shift per neighbour cell).
//
// What bounds it on Hopper: not device memory.  The inputs (positions, the
// per-slot attrs, types, pids: 24-40 bytes per slot) stay resident in the
// 50 MB L2.  The cost is the partner reads from L1/L2 (27 * cap rows of 12
// bytes, plus 4 bytes for each per-slot attr the layout reads) and the pair
// arithmetic: every layout beyond (a) adds loads per partner, (d) a pid
// compare per partner and bond slot.
//
// Design: one thread per i slot sweeps all 27 * cap partners.  No Newton
// halving, so no thread writes another slot's force: no atomics, no rollback
// buffer, and a deterministic result, at twice the pair evaluations of the
// halved TPU kernel.  The threads of a warp hold consecutive cells of one
// rank, so for a given (offset, row) their partner reads are consecutive
// addresses and coalesce.  The layout is a set of template flags, so each
// variant compiles only the loads and tests it needs.
//
// Energy and diagonal virial are 1/2 of the sums over ordered pairs: per-
// thread sums, a fixed-order block sum into one row of a (n_blocks, 4)
// partials buffer that every block writes in full, and a one-block second
// pass in double (pair_terms.cuh).  With WithEnergy = false none of this is
// compiled in.
//
// Every output element is written: vacant slots get f = 0.

#include <cuda_runtime.h>

#include "cell_geom.cuh"
#include "pair_terms.cuh"

namespace {

using pair_terms::BondSlots;
using pair_terms::kBondFene;
using pair_terms::kBondHarmonic;
using pair_terms::kBondNone;

constexpr int kThreads = 128;

struct Params {
  int n_pad;
  int cap;
  int cx, cy, cz;
  int n_types;       // table side (the table is n_types x n_types)
  int shift_energy;  // shift the LJ energy to 0 at r_cut
  cell_geom::HBox h;
  float rc2;   // r_cut^2
  float sig2;  // uniform sigma^2 (layouts without hs)
  float eps;   // uniform epsilon (the sentinel layout)
  float bond_k;
  float bond_r0;
};

// SeEps: eps from se (else uniform, vacancy by the coordinate sentinel);
// HsSig: sigma from hs (else uniform); Table: scale tables; Bond: kBond*.
template <bool SeEps, bool HsSig, bool Table, int Bond, bool WithEnergy>
__global__ void __launch_bounds__(kThreads)
lj_force_kernel(const float* __restrict__ r, const float* __restrict__ se,
                const float* __restrict__ hs, const int* __restrict__ typ,
                const int* __restrict__ pid, BondSlots bp,
                const float* __restrict__ table, float* __restrict__ f,
                float* __restrict__ partials, Params p) {
  const int C = p.cx * p.cy * p.cz;
  const int n_pad = p.n_pad;
  const float* __restrict__ rx = r;
  const float* __restrict__ ry = r + n_pad;
  const float* __restrict__ rz = r + 2 * n_pad;
  const int s = blockIdx.x * kThreads + threadIdx.x;

  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // PE, Wxx, Wyy, Wzz
  if (s < n_pad) {
    const float xi = rx[s];
    const float yi = ry[s];
    const float zi = rz[s];
    const float se_i = SeEps ? se[s] : 0.0f;
    const float hs_i = HsSig ? hs[s] : 0.0f;
    const int ti = Table ? min(typ[s], p.n_types - 1) : 0;
    float bp_i[pair_terms::kMaxBondSlots];
    bool has_partner = false;
    if (Bond != kBondNone) {
      for (int b = 0; b < bp.n; ++b) {
        bp_i[b] = bp.bp[b][s];
        has_partner |= bp_i[b] > 0.0f;
      }
    }
    // A vacant i slot has no force: in the sentinel layout it sits at
    // VACANT_X, in the per-slot layouts it has se = 0 and no partner.
    const bool active = SeEps ? (se_i > 0.0f || has_partner)
                              : (xi < pair_terms::kVacantThr);
    if (active) {
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
              const float dx = xi - (rx[j] + sh.x);
              const float dy = yi - (ry[j] + sh.y);
              const float dz = zi - (rz[j] + sh.z);
              const float r2 = dx * dx + dy * dy + dz * dz;
              bool bonded = false;
              if (Bond != kBondNone && has_partner) {
                const float pj = static_cast<float>(pid[j] + 1);
                for (int b = 0; b < bp.n; ++b) bonded |= bp_i[b] == pj;
                bonded &= r2 > 1.0e-12f;
              }
              // r2 > 1e-12 drops the slot itself (r2 == 0 exactly)
              bool inside = r2 < p.rc2 && r2 > 1.0e-12f;
              float eps = p.eps;
              if (SeEps) {
                eps = se_i * se[j];
                inside &= eps > 0.0f;  // the gate, before the power chain
              }
              if (!(inside || bonded)) continue;
              float sig2 = p.sig2;
              if (HsSig) {
                float sig = hs_i + hs[j];
                if (Table) {
                  const int t = ti * p.n_types + min(typ[j], p.n_types - 1);
                  eps *= table[t];
                  sig *= table[p.n_types * p.n_types + t];
                }
                sig2 = sig * sig;
              }
              float e = 0.0f;
              const float coef =
                  bonded ? pair_terms::bond_term<Bond, WithEnergy>(
                               r2, eps, sig2, p.bond_k, p.bond_r0, &e)
                         : pair_terms::lj_term<WithEnergy>(
                               r2, 4.0f * eps, sig2, p.rc2,
                               p.shift_energy != 0, &e);
              fx += coef * dx;
              fy += coef * dy;
              fz += coef * dz;
              if (WithEnergy) {
                acc[0] += e;
                acc[1] += coef * dx * dx;
                acc[2] += coef * dy * dy;
                acc[3] += coef * dz * dz;
              }
            }
          }
        }
      }
    }
    f[s] = fx;
    f[n_pad + s] = fy;
    f[2 * n_pad + s] = fz;
  }
  if (WithEnergy) pair_terms::block_partials(acc, partials);
}

struct Args {
  const float* r;
  const float* se;
  const float* hs;
  const int* typ;
  const int* pid;
  BondSlots bp;
  const float* table;
  float* f;
  float* partials;
  float* out;
  Params p;
};

template <bool SeEps, bool HsSig, bool Table, int Bond>
void launch(const Args& a, bool with_energy, cudaStream_t st) {
  const int n_blocks = (a.p.n_pad + kThreads - 1) / kThreads;
  if (with_energy) {
    lj_force_kernel<SeEps, HsSig, Table, Bond, true>
        <<<n_blocks, kThreads, 0, st>>>(a.r, a.se, a.hs, a.typ, a.pid, a.bp,
                                        a.table, a.f, a.partials, a.p);
    pair_terms::reduce_partials_kernel<<<1, pair_terms::kReduceThreads, 0,
                                         st>>>(a.partials, n_blocks, a.out);
  } else {
    lj_force_kernel<SeEps, HsSig, Table, Bond, false>
        <<<n_blocks, kThreads, 0, st>>>(a.r, a.se, a.hs, a.typ, a.pid, a.bp,
                                        a.table, a.f, nullptr, a.p);
  }
}

template <bool SeEps, bool HsSig, bool Table>
bool launch_bond(int bond_kind, const Args& a, bool we, cudaStream_t st) {
  switch (bond_kind) {
    case kBondNone: launch<SeEps, HsSig, Table, kBondNone>(a, we, st); break;
    case kBondFene: launch<SeEps, HsSig, Table, kBondFene>(a, we, st); break;
    case kBondHarmonic:
      launch<SeEps, HsSig, Table, kBondHarmonic>(a, we, st);
      break;
    default: return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Threads per block of the force kernel: the partials buffer has
// ceil(n_pad / threads) rows.
int packed_lj_force_threads() { return kThreads; }

// r: (3, n_pad) f32; f: (3, n_pad) f32 out.  se, hs: (n_pad,) f32 or null
// where the layout does not read them (se_eps, hs_sig = 0); typ, pid:
// (n_pad,) i32 or null (table = null, bond_kind = 0); bp0..bp3: the first
// bond_slots bond-partner attrs; table: (2, n_types, n_types) f32 = (k_eps,
// k_sig) or null.  With with_energy != 0, partials: (ceil(n_pad / threads),
// 4) f32 scratch and out: (4,) f32 = (PE, Wxx, Wyy, Wzz); otherwise both may
// be null.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or -1 for a layout without an instantiation: the sentinel
// layout has no table and no bonds, a table needs se and hs.  Lx..Lz and
// xyLy, xzLz, yzLz: the cell matrix (cell_geom.cuh HBox; zero tilt for an
// orthorhombic box).
int packed_lj_force(const float* r, const float* se, const float* hs,
                    const int* typ, const int* pid, const float* bp0,
                    const float* bp1, const float* bp2, const float* bp3,
                    const float* table, float* f, float* partials, float* out,
                    int n_pad, int cap, int cx, int cy, int cz, int se_eps,
                    int hs_sig, int n_types, int bond_kind, int bond_slots,
                    int shift_energy, int with_energy, float Lx, float Ly,
                    float Lz, float xyLy, float xzLz, float yzLz, float rc2,
                    float sig2, float eps, float bond_k, float bond_r0,
                    void* stream) {
  if (bond_slots < 0 || bond_slots > pair_terms::kMaxBondSlots) return -1;
  Args a{r, se, hs, typ, pid, {{bp0, bp1, bp2, bp3}, bond_slots}, table, f,
         partials, out,
         Params{n_pad, cap, cx, cy, cz, n_types, shift_energy,
                {Lx, Ly, Lz, xyLy, xzLz, yzLz}, rc2, sig2, eps, bond_k,
                bond_r0}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool we = with_energy != 0;
  const bool has_table = table != nullptr;
  bool ok;
  if (!se_eps) {
    ok = !hs_sig && !has_table && bond_kind == kBondNone;
    if (ok) launch<false, false, false, kBondNone>(a, we, st);
  } else if (!hs_sig) {
    ok = !has_table && launch_bond<true, false, false>(bond_kind, a, we, st);
  } else if (has_table) {
    ok = launch_bond<true, true, true>(bond_kind, a, we, st);
  } else {
    ok = launch_bond<true, true, false>(bond_kind, a, we, st);
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
