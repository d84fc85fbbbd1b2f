"""The hand-written Hopper pair kernels in the per-slot, table and bonded
layouts against the port's plain PyTorch pair force, on a card.

- Kernel 1 (``csrc/packed_lj_force.cu``) in each layout it is built for,
  forces only and with energy and virial.
- Kernel 5 (``csrc/packed_lj_force_v1.cu``, the v1 cross-check) against the
  plain force and against kernel 1.
- The ε > 0 gate: vacant slots drifted to within r² ~ 1e-8 of each other
  give no NaN.
- Both kernels at 6 bond slots (:func:`star_melt`, 6-arm stars): kernel 1
  in every bonded layout and the soft push-off layout, under a cell mask
  and as a walker batch; v1; repeat calls to the bit.  Kernel 1 at 10
  slots (10-arm stars: the slots past eight reach it in one stacked
  array), alone and as a walker batch; and kernel 1's instantiations past
  four slots (each row's partners resolved into a bitmask over the staged
  rows) give the bits of its 4-slot ones where both apply (chains, whose
  partners fill two slots, packed with six).

The inputs are bead-spring chains laid straight along x on a lattice with
noise, so no push-off is needed (:func:`lattice_melt`, shared with the CPU
parity tests).  Tolerances as ``chip_smoke.py`` phase 13: max|Δf| ≤
1e-4·max|f| + 1e-3, PE and virial rtol 1e-5 (f32 sums in another order).

This file imports no jax, so it runs where the JAX package's dependencies
are missing; ``--noconftest`` skips tests/conftest.py, which imports them:

    python -m pytest --noconftest -m cuda tests/test_torch_bond_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, PackedCoordination, PackedEngine, PackedSpec, bond_partner_attrs,
    pair_scale_tables,
)
from metadyn_tpu_torch.ops.packed import packed_lj_force
from metadyn_tpu_torch.ops.packed_cuda import check_spec, packed_lj_force_cuda
from metadyn_tpu_torch.ops.packed_fused_cuda import fused_lj_order_force_cuda
from metadyn_tpu_torch.ops.packed_v1_cuda import (
    check_spec_v1, packed_lj_force_v1_cuda,
)

EPS_T = [[1.0, 0.6], [0.6, 1.0]]           # Config 2's demixing table
WCA_RC = 2.0 ** (1.0 / 6.0)

# kernel 1's layouts: name -> (PackedSpec.create keywords, eps table)
LAYOUTS = {
    "se_hs_table_fene": (dict(r_cut=2.5, skin=0.3, cap=32,
                              shift_energy=False, fene_k=30.0,
                              fene_r0=1.5), EPS_T),
    "se_hs_fene_wca": (dict(r_cut=WCA_RC, skin=0.4, cap=16,
                            shift_energy=True, fene_k=30.0, fene_r0=1.5),
                       None),
    "se_usig_fene_wca": (dict(r_cut=WCA_RC, skin=0.4, cap=16,
                              shift_energy=True, fene_k=30.0, fene_r0=1.5,
                              uniform_sigma=1.0), None),
    "se_hs": (dict(r_cut=2.5, skin=0.3, cap=32, shift_energy=True), None),
    "se_hs_table": (dict(r_cut=2.5, skin=0.3, cap=32, shift_energy=False),
                    EPS_T),
    "se_hs_harmonic": (dict(r_cut=WCA_RC, skin=0.4, cap=16,
                            shift_energy=True, fene_k=80.0, fene_r0=1.0,
                            bond_kind="harmonic"), None),
}


def lattice_melt(chain_len: int = 8, m: int = 8, rho: float = 0.85,
                 noise: float = 0.05, seed: int = 0):
    """m² diblock chains of ``chain_len`` beads laid straight along x on a
    (chain_len, m, m) lattice in a cubic box at density ``rho``, plus
    Gaussian noise.  Returns (pos, vel, bonds, types, L)."""
    n_chains = m * m
    n = n_chains * chain_len
    L = float((n / rho) ** (1.0 / 3.0))
    ix, iy, iz = np.meshgrid(np.arange(chain_len), np.arange(m),
                             np.arange(m), indexing="ij")
    # particle id = chain * chain_len + bead, chain = iy * m + iz
    site = np.stack([(ix + 0.5) * L / chain_len, (iy + 0.5) * L / m,
                     (iz + 0.5) * L / m], axis=-1) - L / 2
    pos = site.transpose(1, 2, 0, 3).reshape(n, 3)
    rng = np.random.default_rng(seed)
    pos = (pos + rng.normal(0.0, noise, pos.shape)).astype(np.float32)
    vel = rng.normal(0.0, 1.0, pos.shape).astype(np.float32)
    vel -= vel.mean(axis=0)
    idx = np.arange(n).reshape(n_chains, chain_len)
    bonds = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()],
                     axis=1).astype(np.int32)
    t = np.zeros((n_chains, chain_len), np.int32)
    t[:, chain_len // 2:] = 1
    return pos, vel, bonds, t.reshape(-1), L


def layout_inputs(spec_kw: dict, eps_table, chain_len: int = 8, m: int = 8):
    """(spec, pack_state arguments) of a layout on the lattice melt."""
    pos, vel, bonds, types, L = lattice_melt(chain_len, m)
    n = pos.shape[0]
    eps_scale, eps_i = None, np.ones(n, np.float32)
    if eps_table is not None:
        eps_scale, _, eps_diag, _ = pair_scale_tables(eps_table)
        eps_i = eps_diag[types]
    spec = PackedSpec.create(L, n, eps_scale=eps_scale, **spec_kw)
    extra = bond_partner_attrs(bonds, n) if spec.has_bonds else {}
    return spec, dict(pos=pos, types=types, eps_i=eps_i,
                      sigma_i=np.ones(n, np.float32), vel=vel,
                      extra_attrs=extra, L=L)


def star_melt(n_stars: int, arms: int = 6, arm_len: int = 5,
              rho: float = 0.3, seed: int = 0):
    """``n_stars`` stars of a centre bead and ``arms`` arms of ``arm_len``
    beads, each arm a persistent random walk (bond 0.97) from its centre,
    the centres on a jittered cubic grid at density ``rho``.  Returns
    (pos, bonds, L); bead ids star by star, the centre first."""
    per = 1 + arms * arm_len
    n = n_stars * per
    L = float((n / rho) ** (1.0 / 3.0))
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n_stars ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n_stars]
    centres = (grid + 0.5) * (L / m) - L / 2 + rng.normal(0, 0.1, (n_stars, 3))
    pos = np.zeros((n_stars, per, 3))
    pos[:, 0] = centres
    bonds = []
    for s in range(n_stars):
        base = s * per
        for a in range(arms):
            step = rng.normal(size=3)
            prev = 0
            for k in range(arm_len):
                step = 0.9 * step / np.linalg.norm(step) + rng.normal(
                    0, 0.5, 3)
                idx = 1 + a * arm_len + k
                pos[s, idx] = pos[s, prev] + 0.97 * step / np.linalg.norm(
                    step)
                bonds.append((base + prev, base + idx))
                prev = idx
    pos = (pos.reshape(n, 3) + L / 2) % L - L / 2
    return pos.astype(np.float32), np.asarray(bonds, np.int32), L


STAR_SLOTS = 6


def star_layout(device, name: str, n_stars: int = 8, seed: int = 0,
                arms: int = STAR_SLOTS):
    """(state, spec): :func:`star_melt` (``arms`` arms of 5 beads, ρ 0.3,
    numpy seed ``seed``) in a bonded layout of LAYOUTS with ``arms`` bond
    slots, or the soft push-off layout with FENE bonds (``"soft_fene"``);
    types A on the centre and the first two beads of each arm, B
    outwards."""
    pos, bonds, L = star_melt(n_stars, arms=arms, seed=seed)
    n = pos.shape[0]
    per = 1 + 5 * arms
    types = np.tile((np.arange(per) % 5 >= 3).astype(np.int32), n_stars)
    eps_i = np.ones(n, np.float32)
    if name == "soft_fene":
        spec_kw, table = dict(r_cut=1.0, skin=0.5, cap=24, pair_kind="soft",
                              fene_k=30.0, fene_r0=1.5), None
        eps_i = np.full(n, 100.0, np.float32)
    else:
        spec_kw, table = LAYOUTS[name]
    eps_scale = None
    if table is not None:
        eps_scale, _, eps_diag, _ = pair_scale_tables(table)
        eps_i = eps_diag[types]
    spec = PackedSpec.create(L, n, eps_scale=eps_scale,
                             **{**spec_kw, "cap": 24}, bond_slots=arms)
    engine = PackedEngine(spec, device, rebuild_every=5)
    state, ovf = engine.pack_state(
        pos, Box.cubic(L, device), types, eps_i, np.ones(n, np.float32),
        extra_attrs=bond_partner_attrs(bonds, n, slots=arms))
    assert not ovf
    return state, spec


def packed_layout(device, name: str):
    spec_kw, table = LAYOUTS[name]
    spec, a = layout_inputs(spec_kw, table)
    engine = PackedEngine(spec, device, rebuild_every=5)
    state, ovf = engine.pack_state(
        a["pos"], Box.cubic(a["L"], device), a["types"], a["eps_i"],
        a["sigma_i"], vel=a["vel"], extra_attrs=a["extra_attrs"])
    assert not ovf
    return state, spec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA device)")
    return torch.device("cuda", 0)


def assert_force_close(a, b, with_energy=True):
    fmax = float(b.f.abs().max())
    df = float((a.f - b.f).abs().max())
    assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (df, fmax)
    if with_energy:
        torch.testing.assert_close(a.potential_energy, b.potential_energy,
                                   rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a.virial, b.virial, rtol=1e-5, atol=0.0)


def test_kernels_take_the_layouts():
    """The spec checks accept every layout listed (no card needed); both
    kernels refuse the soft pair, v1 also tables (as the reference's v1
    does), kernel 1 a uniform ε without a uniform σ."""
    for name in LAYOUTS:
        spec_kw, table = LAYOUTS[name]
        spec, _ = layout_inputs(spec_kw, table)
        check_spec(spec)
        if not spec.has_pair_table:
            check_spec_v1(spec)
    spec, _ = layout_inputs(LAYOUTS["se_hs_table_fene"][0], EPS_T)
    for bad in (dataclasses.replace(spec, pair_kind="soft"), spec):
        with pytest.raises(NotImplementedError):
            check_spec_v1(bad)
    with pytest.raises(NotImplementedError):
        check_spec(dataclasses.replace(spec, pair_kind="soft"))
    with pytest.raises(NotImplementedError):
        check_spec(dataclasses.replace(spec, eps_scale=None,
                                       uniform_eps=1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_kernel_matches_plain(cuda_device, name, with_energy):
    st, spec = packed_layout(cuda_device, name)
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 1
    assert_force_close(a, b, with_energy)
    assert torch.all(a.f[:, st.pid >= spec.n_real] == 0.0)
    if not with_energy:
        assert torch.equal(a.potential_energy, st.potential_energy)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["se_hs_table_fene", "se_usig_fene_wca"])
def test_vacant_drift_gives_no_nan(cuda_device, name):
    """Vacant slots are not pinned in the per-slot layout: put two of them
    1e-4 apart.  The ε > 0 gate keeps 0·inf out of the power chain."""
    st, spec = packed_layout(cuda_device, name)
    vac = [(spec.cap - 1) * spec.n_cells, (spec.cap - 2) * spec.n_cells]
    assert bool((st.pid[vac] >= spec.n_real).all())   # one cell, both vacant
    r = st.r.clone()
    r[:, vac[0]] = torch.tensor([0.3, 0.2, 0.1], device=cuda_device)
    r[:, vac[1]] = torch.tensor([0.3001, 0.2, 0.1], device=cuda_device)
    st = st.replace(r=r)
    a = packed_lj_force_cuda(st, spec, with_energy=True)
    b = packed_lj_force(st, spec, with_energy=True)
    torch.cuda.synchronize()
    assert torch.isfinite(a.f).all() and torch.isfinite(a.potential_energy)
    assert_force_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["se_hs", "se_hs_fene_wca",
                                  "se_hs_harmonic"])
def test_v1_kernel_matches_plain_and_kernel1(cuda_device, name):
    st, spec = packed_layout(cuda_device, name)
    before = packed_lj_force_v1_cuda.launches
    v1 = packed_lj_force_v1_cuda(st, spec)
    plain = packed_lj_force(st, spec, with_energy=True)
    k1 = packed_lj_force_cuda(st, spec, with_energy=True)
    torch.cuda.synchronize()
    assert packed_lj_force_v1_cuda.launches == before + 1
    assert_force_close(v1, plain)
    assert_force_close(v1, k1)


@pytest.mark.cuda
def test_kernels_refuse_a_tilted_box(cuda_device):
    """Tilted boxes reach every kernel now, each held against its plain
    version (tests/test_torch_triclinic_kernels.py).  What stays refused: a
    tilt without its host floats (the box is not built), and on a tilted
    box the fused kernel's per-slot layouts, a cell_mask without the
    monomial mode (the reference's rule) and the unported parts subsets,
    with or without the monomial mode."""
    st, spec = packed_layout(cuda_device, "se_hs_fene_wca")
    with pytest.raises(ValueError, match="tilt_host"):
        dataclasses.replace(
            st.box, tilt=torch.tensor([0.1, 0.0, 0.0], device=cuda_device))
    tilted = st.replace(box=Box.triclinic(*st.box.L_host, cuda_device, 0.1))
    cvs = [PackedCoordination(spec, r0=1.0)]
    auxs = [torch.tensor(-0.1, device=cuda_device)]
    with pytest.raises(ValueError, match="sentinel"):
        fused_lj_order_force_cuda(tilted, spec, cvs, auxs)
    lean = dataclasses.replace(spec, uniform_sigma=1.0, uniform_eps=1.0,
                               fene_k=None, fene_r0=None)
    with pytest.raises(NotImplementedError):
        fused_lj_order_force_cuda(
            tilted, lean, cvs, auxs,
            cell_mask=torch.ones(spec.n_cells, device=cuda_device))


STAR_BONDED = ["se_hs_table_fene", "se_hs_fene_wca", "se_usig_fene_wca",
               "se_hs_harmonic", "soft_fene"]


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("name", STAR_BONDED)
def test_six_slot_kernel_matches_plain(cuda_device, name, with_energy):
    """Kernel 1 at 6 bond slots (a 6-arm star melt: every centre has six
    partners, each row's partners resolved into its warp's bitmask over
    the staged rows) in every bonded layout and the soft push-off layout,
    against the plain force; two calls give the same bits."""
    st, spec = star_layout(cuda_device, name)
    check_spec(spec)
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 1
    assert_force_close(a, b, with_energy)
    assert float(b.f.abs().max()) > 1.0
    again = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    assert torch.equal(a.f, again.f)
    if with_energy:
        assert torch.equal(a.potential_energy, again.potential_energy)
        # the star's FENE bonds are in the sum: a 2-slot spec over the
        # same state misses the centres' four other arms
        two = dataclasses.replace(spec, bond_slots=2)
        assert float((packed_lj_force(st, two).f - b.f).abs().max()) > 1.0


@pytest.mark.cuda
def test_six_slot_kernel_masked_and_walkers(cuda_device):
    """Kernel 1 at 6 slots under a cell mask (energy and virial weighted
    by each pair's i cell) and as a walker batch of 3 stars melts (the
    stacked slots per walker), each against the plain version; the batch
    equals single launches to the bit."""
    from metadyn_tpu_torch.core.batch import stack_walkers
    st, spec = star_layout(cuda_device, "se_hs_fene_wca")
    mask = (torch.arange(spec.n_cells, device=cuda_device) % 2).float()
    a = packed_lj_force_cuda(st, spec, cell_mask=mask)
    b = packed_lj_force(st, spec, cell_mask=mask)
    assert_force_close(a, b)
    states = [star_layout(cuda_device, "se_hs_fene_wca", seed=w)[0]
              for w in range(3)]
    batch = stack_walkers(states)
    out = packed_lj_force_cuda(batch, spec, with_energy=True)
    ref = packed_lj_force(batch, spec, with_energy=True)
    for w, s1 in enumerate(states):
        one = packed_lj_force_cuda(s1, spec, with_energy=True)
        assert torch.equal(out.f[w], one.f)
        assert torch.equal(out.potential_energy[w], one.potential_energy)
        fmax = float(ref.f[w].abs().max())
        assert float((out.f[w] - ref.f[w]).abs().max()) <= 1e-4 * fmax + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["se_usig_fene_wca", "soft_fene"])
def test_ten_slot_kernel_stacked_columns(cuda_device, name):
    """Kernel 1 at 10 bond slots (10-arm stars: the first eight columns by
    pointer, the ninth and tenth from the wrapper's stacked array), with
    energy, against the plain force, twice to the bit; as a walker batch
    of 2 (the stacked slots per walker), equal to single launches."""
    from metadyn_tpu_torch.core.batch import stack_walkers
    states = [star_layout(cuda_device, name, n_stars=4, seed=w, arms=10)
              for w in range(2)]
    spec = states[0][1]
    for st, _ in states:
        a = packed_lj_force_cuda(st, spec, with_energy=True)
        b = packed_lj_force(st, spec, with_energy=True)
        assert_force_close(a, b)
        assert float(b.f.abs().max()) > 1.0
        assert torch.equal(a.f, packed_lj_force_cuda(st, spec).f)
    out = packed_lj_force_cuda(stack_walkers([s for s, _ in states]), spec,
                               with_energy=True)
    for w, (s1, _) in enumerate(states):
        one = packed_lj_force_cuda(s1, spec, with_energy=True)
        assert torch.equal(out.f[w], one.f)
        assert torch.equal(out.virial[w], one.virial)


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("name", ["se_hs_table_fene", "se_usig_fene_wca",
                                  "se_hs_harmonic"])
def test_more_slots_give_the_four_slot_bits(cuda_device, name, with_energy):
    """Chains, whose partners fill two bond slots, packed with six: the
    instantiation past four slots (the bitmask) and the 2-slot one (the
    partner pids in registers) give the same bits, since both bond the
    same staged rows and sum in the same queue order."""
    spec_kw, table = LAYOUTS[name]
    spec, a = layout_inputs(spec_kw, table)
    _, _, bonds, _, _ = lattice_melt()
    spec = dataclasses.replace(spec, bond_slots=6)
    state, ovf = PackedEngine(spec, cuda_device).pack_state(
        a["pos"], Box.cubic(a["L"], cuda_device), a["types"], a["eps_i"],
        a["sigma_i"], vel=a["vel"],
        extra_attrs=bond_partner_attrs(bonds, a["pos"].shape[0], slots=6))
    assert not ovf
    assert float(state.attrs["bp2"].abs().max()) == 0.0
    six = packed_lj_force_cuda(state, spec, with_energy=with_energy)
    two = packed_lj_force_cuda(state, dataclasses.replace(spec, bond_slots=2),
                               with_energy=with_energy)
    assert torch.equal(six.f, two.f)
    if with_energy:
        assert torch.equal(six.potential_energy, two.potential_energy)
        assert torch.equal(six.virial, two.virial)
    assert_force_close(six, packed_lj_force(state, spec,
                                            with_energy=with_energy),
                       with_energy)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["se_hs_fene_wca", "se_hs_harmonic"])
def test_six_slot_v1_matches_plain_and_kernel1(cuda_device, name):
    st, spec = star_layout(cuda_device, name)
    check_spec_v1(spec)
    before = packed_lj_force_v1_cuda.launches
    v1 = packed_lj_force_v1_cuda(st, spec)
    plain = packed_lj_force(st, spec, with_energy=True)
    k1 = packed_lj_force_cuda(st, spec, with_energy=True)
    torch.cuda.synchronize()
    assert packed_lj_force_v1_cuda.launches == before + 1
    assert_force_close(v1, plain)
    assert_force_close(v1, k1)
    assert torch.equal(v1.f, packed_lj_force_v1_cuda(st, spec).f)
