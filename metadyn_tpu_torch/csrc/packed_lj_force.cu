// Pair force over the cell-major slot layout: Lennard-Jones with optional
// per-slot parameters, per-type-pair scale tables and bonds, or the soft
// push-off pair.
//
// Replaces the TPU kernel `packed_lj_force_pallas2` in
// metadyn_tpu/ops/packed_pallas2.py in these variants, each in an
// orthorhombic or a tilted (triclinic) box:
//   (a) the sentinel layout: uniform sigma and epsilon, vacant slots parked
//       at the coordinate sentinel VACANT_X (1e7);
//   (b) per-slot Lorentz-Berthelot parameters, eps_ij = se_i se_j (se =
//       sqrt(eps)) and sigma_ij = hs_i + hs_j (hs = sigma / 2) or a uniform
//       sigma; vacant slots have se = 0 and are not pinned, so they drift,
//       and the eps > 0 gate runs before the power chain (0 * inf = NaN);
//   (c) per-type-pair scale tables on (b): eps_ij and sigma_ij times
//       k(t_i, t_j), read from a small table indexed by the integer types
//       (the TPU kernel's bilinear FMA form evaluated once on the host, so
//       the values are the plain version's);
//   (d) bonds on (b) or (c): partners matched by pid through the bp attrs
//       (partner pid + 1, 0 = none), at any distance, not gated on r_cut;
//       a bonded pair gets FENE + WCA at the pair's (table-scaled) eps and
//       sigma, or a harmonic spring, instead of the pair term;
//   (s) the soft (DPD-conservative) pair on (b) with per-slot hs, with or
//       without FENE bonds: u = A rc/2 (1 - r/rc)^2, A = se_i se_j, the
//       push-off that relaxes a random-walk melt's overlaps.  The JAX
//       package has no Pallas kernel for it: it runs the XLA roll sweep
//       (metadyn_tpu/ops/packed.py:830, packed_lj_force with pair_kind
//       "soft"), whose port is the plain sweep of ops/packed.py.  Bonded
//       pairs keep the bond term of (d).
//
// Layout (ops/packed.py): positions are a (3, Npad) f32 array, slot =
// rank * C + cell, cell = (ix * cy + iy) * cz + iz, cells binned in fractional
// coordinates.  A cell's partners are the `cap` rows of each of the 27
// neighbour cells; a neighbour that wraps past a box face is seen at x_j + h u
// with u in {-1, 0, 1}^3 (cell_geom.cuh: one shift per neighbour cell).
//
// What bounds it on Hopper: not device memory.  The inputs (positions, the
// per-slot attrs, types, pids: 24-40 bytes per slot) stay resident in the
// 50 MB L2.  The cost is the candidate tests (r^2 of every staged partner)
// and the pair arithmetic of the ~5% of candidates inside r_cut.
//
// Design (cell_stage.cuh): one block per cell stages the rows of its 27
// neighbour cells in shared memory once, with the shift h u applied and
// compacted to the real rows, plus only the per-slot fields the layout
// reads: float4 (x, y, z, se), then hs, the type and pid + 1 where used.
// The vacancy rule of the compaction is per layout: (a) x < VACANT_THR;
// (b), (c) se > 0; (d) pid < n_real, every real row, since a bonded
// partner counts at any distance and an i row is live with se = 0 if it
// has a partner; (s) as (b), or as (d) with bonds.  One warp takes one
// real i row of the cell at a time; its lanes split the staged rows, queue
// those inside r_cut (or bonded) and run the pair math on the queue 32 at
// a time.  The warp's three force sums meet in a shuffle tree and lane 0
// writes the i slot.  No Newton halving, so no thread writes another
// slot's force: no atomics and a deterministic result, at twice the pair
// evaluations of the halved TPU kernel.  The layout is a set of template flags, so each variant compiles
// only the loads and tests it needs.
//
// Energy and diagonal virial are 1/2 of the sums over ordered pairs: per-
// lane sums, a fixed-order block sum into one row of a (cells, 4) partials
// buffer that every block writes in full, and a one-block second pass in
// double (pair_terms.cuh).  With WithEnergy = false none of this is
// compiled in.
//
// Every output element is written: slots the compaction dropped (vacant)
// get f = 0.

#include <cuda_runtime.h>

#include "cell_geom.cuh"
#include "cell_stage.cuh"
#include "pair_terms.cuh"

namespace {

using pair_terms::BondSlots;
using pair_terms::kBondFene;
using pair_terms::kBondHarmonic;
using pair_terms::kBondNone;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  cell_stage::Grid g;
  int n_real;        // the bonded layout's vacancy bound on pid
  int n_types;       // table side (the table is n_types x n_types)
  int shift_energy;  // shift the LJ energy to 0 at r_cut
  float rc2;   // r_cut^2
  float rc;    // r_cut (the soft pair)
  float sig2;  // uniform sigma^2 (layouts without hs)
  float eps;   // uniform epsilon (the sentinel layout)
  float bond_k;
  float bond_r0;
};

// Staged fields per row beyond the float4 (x, y, z, se).
template <bool HsSig, bool Table, int Bond>
constexpr int extra_fields() {
  return (HsSig ? 1 : 0) + (Table ? 1 : 0) + (Bond != kBondNone ? 1 : 0);
}

template <bool HsSig, bool Table, int Bond>
size_t smem_bytes(int cap, int n_types) {
  const size_t rows = static_cast<size_t>(cell_stage::kOffsets) * cap;
  return rows * (sizeof(float4) +
                 sizeof(float) * extra_fields<HsSig, Table, Bond>()) +
         (Table ? sizeof(float) * 2 * n_types * n_types : 0) +
         cell_stage::scratch_bytes(cap, kWarps);
}

// SeEps: eps from se (else uniform, vacancy by the coordinate sentinel);
// HsSig: sigma from hs (else uniform); Table: scale tables; Bond: kBond*;
// Soft: the soft pair in place of LJ (with SeEps and HsSig only).
template <bool SeEps, bool HsSig, bool Table, int Bond, bool Soft,
          bool WithEnergy>
__global__ void __launch_bounds__(kThreads)
lj_force_kernel(const float* __restrict__ r, const float* __restrict__ se,
                const float* __restrict__ hs, const int* __restrict__ typ,
                const int* __restrict__ pid, BondSlots bp,
                const float* __restrict__ table, float* __restrict__ f,
                float* __restrict__ partials, Params p) {
  extern __shared__ float4 s_pos[];  // (27 cap): x, y, z with the shift, se
  const int cap = p.g.cap;
  const int n_pad = p.g.n_pad;
  const int n_stage = cell_stage::kOffsets * cap;
  float* s_next = reinterpret_cast<float*>(s_pos + n_stage);
  float* s_hs = s_next;
  if (HsSig) s_next += n_stage;
  int* s_typ = reinterpret_cast<int*>(s_next);
  if (Table) s_next += n_stage;
  float* s_pid1 = s_next;
  if (Bond != kBondNone) s_next += n_stage;
  const int nt = p.n_types;
  float* s_tab = s_next;
  if (Table) s_next += 2 * nt * nt;
  const cell_stage::Scratch sc = cell_stage::scratch_at(s_next, cap);

  if (Table) {
    for (int t = threadIdx.x; t < 2 * nt * nt; t += kThreads) {
      s_tab[t] = table[t];
    }
  }
  const int cell = blockIdx.x;
  const int C = p.g.cx * p.g.cy * p.g.cz;
  auto keep = [&](int, int j, float3) -> bool {
    if (Bond != kBondNone) return pid[j] < p.n_real;
    if (SeEps) return se[j] > 0.0f;
    return r[j] < pair_terms::kVacantThr;
  };
  auto store = [&](int q, int j, float3 x) {
    s_pos[q] = make_float4(x.x, x.y, x.z, SeEps ? se[j] : 0.0f);
    if (HsSig) s_hs[q] = hs[j];
    if (Table) s_typ[q] = min(typ[j], nt - 1);
    if (Bond != kBondNone) s_pid1[q] = static_cast<float>(pid[j] + 1);
  };
  const int n_rows = cell_stage::stage_neighbours(r, p.g, cell, sc, keep,
                                                  store);
  for (int k = threadIdx.x; k < cap; k += kThreads) {
    if (cell_stage::own_dropped(sc, cap, k)) {
      const int s = k * C + cell;
      f[s] = 0.0f;
      f[n_pad + s] = 0.0f;
      f[2 * n_pad + s] = 0.0f;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = sc.off[cell_stage::kSelf];
  const int n_i = sc.off[cell_stage::kSelf + 1] - i0;
  int* queue = sc.queue + warp * cell_stage::kQueue;
  float pe = 0.0f, wxx = 0.0f, wyy = 0.0f, wzz = 0.0f;
  for (int ii = warp; ii < n_i; ii += kWarps) {
    const float4 xi = s_pos[i0 + ii];
    const int s = sc.islot[ii];
    const float hs_i = HsSig ? s_hs[i0 + ii] : 0.0f;
    const int ti = Table ? s_typ[i0 + ii] : 0;
    float bp_i[pair_terms::kMaxBondSlots];
    bool has_partner = false;
    if (Bond != kBondNone) {
      for (int b = 0; b < bp.n; ++b) {
        bp_i[b] = bp.bp[b][s];
        has_partner |= bp_i[b] > 0.0f;
      }
    }
    // the pair's geometry and its class: inside r_cut (with eps > 0),
    // bonded, or neither
    auto classify = [&](int q, float* dx, float* dy, float* dz, float* r2,
                        float* eps, bool* bonded) -> bool {
      const float4 xj = s_pos[q];
      *dx = xi.x - xj.x;
      *dy = xi.y - xj.y;
      *dz = xi.z - xj.z;
      *r2 = *dx * *dx + *dy * *dy + *dz * *dz;
      *bonded = false;
      if (Bond != kBondNone && has_partner) {
        const float pj = s_pid1[q];
        for (int b = 0; b < bp.n; ++b) *bonded |= bp_i[b] == pj;
        *bonded &= *r2 > 1.0e-12f;
      }
      // r2 > 1e-12 drops the slot itself (r2 == 0 exactly)
      bool inside = *r2 < p.rc2 && *r2 > 1.0e-12f;
      *eps = p.eps;
      if (SeEps) {
        *eps = xi.w * xj.w;
        inside &= *eps > 0.0f;  // the gate, before the power chain
      }
      return inside || *bonded;
    };
    float fx = 0.0f, fy = 0.0f, fz = 0.0f;
    cell_stage::warp_sweep(
        n_rows, queue,
        [&](int q) {
          float dx, dy, dz, r2, eps;
          bool bonded;
          return classify(q, &dx, &dy, &dz, &r2, &eps, &bonded);
        },
        [&](int q) {
          float dx, dy, dz, r2, eps;
          bool bonded;
          classify(q, &dx, &dy, &dz, &r2, &eps, &bonded);
          float sig2 = p.sig2;
          if (HsSig) {
            float sig = hs_i + s_hs[q];
            if (Table) {
              const int t = ti * nt + s_typ[q];
              eps *= s_tab[t];
              sig *= s_tab[nt * nt + t];
            }
            sig2 = sig * sig;
          }
          float e = 0.0f;
          float coef;
          if (bonded) {
            coef = pair_terms::bond_term<Bond, WithEnergy>(
                r2, eps, sig2, p.bond_k, p.bond_r0, &e);
          } else if (Soft) {
            coef = pair_terms::soft_term<WithEnergy>(r2, eps, p.rc, &e);
          } else {
            coef = pair_terms::lj_term<WithEnergy>(
                r2, 4.0f * eps, sig2, p.rc2, p.shift_energy != 0, &e);
          }
          fx += coef * dx;
          fy += coef * dy;
          fz += coef * dz;
          if (WithEnergy) {
            pe += e;
            wxx += coef * dx * dx;
            wyy += coef * dy * dy;
            wzz += coef * dz * dz;
          }
        });
    fx = cell_stage::warp_sum(fx);
    fy = cell_stage::warp_sum(fy);
    fz = cell_stage::warp_sum(fz);
    if (lane == 0) {
      f[s] = fx;
      f[n_pad + s] = fy;
      f[2 * n_pad + s] = fz;
    }
  }
  if (WithEnergy) {
    float acc[4] = {pe, wxx, wyy, wzz};  // PE, Wxx, Wyy, Wzz
    pair_terms::block_partials(acc, partials);
  }
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

// Launches one variant: 0, a CUDA error of the shared-memory request or
// the launch, or cell_stage::kSmemTooLarge when cap does not fit a block's
// shared memory.
template <bool SeEps, bool HsSig, bool Table, int Bond, bool Soft,
          bool WithEnergy>
int launch_one(const Args& a, cudaStream_t st) {
  const int n_blocks = a.p.g.cx * a.p.g.cy * a.p.g.cz;
  const size_t smem = smem_bytes<HsSig, Table, Bond>(a.p.g.cap, a.p.n_types);
  auto kernel = lj_force_kernel<SeEps, HsSig, Table, Bond, Soft, WithEnergy>;
  // beside the static array of pair_terms::block_partials
  const int rc = cell_stage::request_smem(kernel, smem, sizeof(float) * 128);
  if (rc != 0) return rc;
  kernel<<<n_blocks, kThreads, smem, st>>>(a.r, a.se, a.hs, a.typ, a.pid,
                                           a.bp, a.table, a.f, a.partials,
                                           a.p);
  if (WithEnergy) {
    pair_terms::reduce_partials_kernel<<<1, pair_terms::kReduceThreads, 0,
                                         st>>>(a.partials, n_blocks, a.out);
  }
  return 0;
}

template <bool SeEps, bool HsSig, bool Table, int Bond, bool Soft = false>
int launch(const Args& a, bool with_energy, cudaStream_t st) {
  return with_energy
             ? launch_one<SeEps, HsSig, Table, Bond, Soft, true>(a, st)
             : launch_one<SeEps, HsSig, Table, Bond, Soft, false>(a, st);
}

constexpr int kNoLayout = -1;

template <bool SeEps, bool HsSig, bool Table>
int launch_bond(int bond_kind, const Args& a, bool we, cudaStream_t st) {
  switch (bond_kind) {
    case kBondNone: return launch<SeEps, HsSig, Table, kBondNone>(a, we, st);
    case kBondFene: return launch<SeEps, HsSig, Table, kBondFene>(a, we, st);
    case kBondHarmonic:
      return launch<SeEps, HsSig, Table, kBondHarmonic>(a, we, st);
    default: return kNoLayout;
  }
}

// The soft pair: per-slot se and hs, no table, no bonds or FENE bonds.
int launch_soft(int bond_kind, const Args& a, bool we, cudaStream_t st) {
  switch (bond_kind) {
    case kBondNone:
      return launch<true, true, false, kBondNone, true>(a, we, st);
    case kBondFene:
      return launch<true, true, false, kBondFene, true>(a, we, st);
    default: return kNoLayout;
  }
}

}  // namespace

extern "C" {

// Rows of the energy partials buffer: one per block, one block per cell.
int packed_lj_force_blocks(int cx, int cy, int cz) { return cx * cy * cz; }

// r: (3, n_pad) f32; f: (3, n_pad) f32 out.  se, hs: (n_pad,) f32 or null
// where the layout does not read them (se_eps, hs_sig = 0); typ, pid:
// (n_pad,) i32 or null (table = null, bond_kind = 0); n_real: the bonded
// layout's vacancy bound (pid < n_real is real); bp0..bp3: the first
// bond_slots bond-partner attrs; table: (2, n_types, n_types) f32 = (k_eps,
// k_sig) or null.  With with_energy != 0, partials: (cx cy cz, 4) f32
// scratch and out: (4,) f32 = (PE, Wxx, Wyy, Wzz); otherwise both may be
// null.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), a CUDA error of the shared-memory request, -1 for a layout
// without an instantiation (the sentinel layout has no table and no bonds,
// a table needs se and hs, the soft pair needs se and hs, no table and no
// bond or a FENE one), or -2 when cap does not fit a block's shared
// memory.  soft != 0 selects the soft pair (cut at r_cut) in place of LJ.
// Lx..Lz and xyLy, xzLz, yzLz: the cell matrix (cell_geom.cuh HBox; zero
// tilt for an orthorhombic box).
int packed_lj_force(const float* r, const float* se, const float* hs,
                    const int* typ, const int* pid, const float* bp0,
                    const float* bp1, const float* bp2, const float* bp3,
                    const float* table, float* f, float* partials, float* out,
                    int n_pad, int cap, int cx, int cy, int cz, int n_real,
                    int se_eps, int hs_sig, int n_types, int bond_kind,
                    int bond_slots, int shift_energy, int with_energy,
                    int soft, float Lx, float Ly, float Lz, float xyLy,
                    float xzLz, float yzLz, float rc2, float r_cut,
                    float sig2, float eps, float bond_k, float bond_r0,
                    void* stream) {
  if (bond_slots < 0 || bond_slots > pair_terms::kMaxBondSlots) {
    return kNoLayout;
  }
  Args a{r, se, hs, typ, pid, {{bp0, bp1, bp2, bp3}, bond_slots}, table, f,
         partials, out,
         Params{{n_pad, cap, cx, cy, cz, {Lx, Ly, Lz, xyLy, xzLz, yzLz}},
                n_real, n_types, shift_energy, rc2, r_cut, sig2, eps, bond_k,
                bond_r0}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool we = with_energy != 0;
  const bool has_table = table != nullptr;
  int rc;
  if (soft) {
    rc = (se_eps && hs_sig && !has_table) ? launch_soft(bond_kind, a, we, st)
                                          : kNoLayout;
  } else if (!se_eps) {
    rc = (!hs_sig && !has_table && bond_kind == kBondNone)
             ? launch<false, false, false, kBondNone>(a, we, st)
             : kNoLayout;
  } else if (!hs_sig) {
    rc = has_table ? kNoLayout
                   : launch_bond<true, false, false>(bond_kind, a, we, st);
  } else if (has_table) {
    rc = launch_bond<true, true, true>(bond_kind, a, we, st);
  } else {
    rc = launch_bond<true, true, false>(bond_kind, a, we, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
