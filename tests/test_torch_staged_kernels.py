"""The block-per-cell kernels over staged neighbour rows: the pair kernel
(``csrc/packed_lj_force.cu``, every layout), the order-CV values and force
kernels (``csrc/packed_order.cu``) and the fused LJ + order-CV kernel
(``csrc/packed_fused_lj_order.cu``), with the staging of
``csrc/cell_stage.cuh``.

On the CPU: the order kernels' staging prefilter (its plain mirror,
``ops.packed_order_cuda.prefilter_keep``) drops no pair inside the cut-off,
in orthorhombic and tilted boxes (hypothesis over boxes, tilts and
positions), also at the fused kernel's radius (``ops.packed_fused_cuda.
fused_reach``: no pair inside the LJ or the CV cut-off), and does drop rows
out of reach.

On a card (``cuda`` tests, skipped elsewhere), against the plain versions
(``ops.packed.packed_lj_force``, ``cv.packed_order.order_values_plain``
and ``order_force_plain``, ``ops.packed_fused_cuda.
fused_lj_order_force_plain``): every pair-kernel layout, (a) sentinel, (b)
per-slot ``se``/``hs`` or ``se`` with a uniform σ, (c) tables, (d) FENE or
harmonic bonds, forces only and with energy, orthorhombic and tilted; the
values and force kernels in the sentinel and validity layouts,
orthorhombic and tilted, for each CV-kind set; the fused kernel (sentinel
layout) orthorhombic and tilted for Q6, coordination and both; and the
traps of the staging: a cell filled to a cap that is not a multiple of 32,
empty cells, a vacant slot moved next to a real particle, two vacant slots
1e-4 apart, a bond across a box face, a CV without a cut-off (prefilter
off), a cap whose rows do not fit shared memory.  Two calls on one input
give the same bits.

Inputs: ``fcc_lattice(6, 1.68)`` plus Gaussian noise from numpy seeds (864
particles, 3³ cells, r_cut 2.5, skin 0.4).  Tolerances as chip_smoke.py:
pair forces max|Δf| ≤ 1e-4·max|f| + 1e-3, PE and virial rtol 1e-5; CV
values max|Δlane| ≤ 2e-5·max|lane| of each CV; bias forces rtol 2e-3 and
atol 2e-4·max (f32 sums in another order); the fused kernel's LJ force
atol 1e-3·max, its value lanes 2e-4·max|lane| of each CV.

This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_staged_kernels.py
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from metadyn_tpu_torch import (
    Box, PackedCoordination, PackedSpec, PackedSteinhardtQl,
    bond_partner_attrs, fcc_lattice, pair_scale_tables,
)
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc
from metadyn_tpu_torch.ops import packed_order_cuda as poc
from metadyn_tpu_torch.ops.packed import pack_host, packed_lj_force
from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

A_LAT = 1.68
N_CELLS = 6
L = N_CELLS * A_LAT
TILT = (0.2, -0.12, 0.1)
EPS_T = [[1.0, 0.6], [0.6, 1.0]]
DV = (0.9, -1.3)

# kernel 1's layouts: name -> PackedSpec.create keywords (bonds between the
# pairs of fcc basis atoms 2k, 2k + 1, types by pid parity)
LAYOUTS = {
    "a_sentinel": dict(uniform_sigma=1.0, uniform_eps=1.0),
    "a_sentinel_shift": dict(uniform_sigma=1.0, uniform_eps=1.0,
                             shift_energy=True),
    "b_se_hs": dict(),
    "b_se_usig": dict(uniform_sigma=1.0, shift_energy=True),
    "c_table": dict(eps_table=EPS_T),
    "d_table_fene": dict(eps_table=EPS_T, fene_k=30.0, fene_r0=1.5),
    "d_usig_harmonic": dict(uniform_sigma=1.0, fene_k=80.0, fene_r0=1.2,
                            bond_kind="harmonic"),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA device)")
    return torch.device("cuda", 0)


def fcc_positions(noise: float = 0.05, seed: int = 7) -> np.ndarray:
    pos = fcc_lattice(N_CELLS, A_LAT)
    return (pos + np.random.default_rng(seed).normal(0.0, noise, pos.shape)
            ).astype(np.float32)


def pack(device, pos, layout: str = "b_se_hs", tilt=None, cap: int = 40):
    """(state, spec) of ``pos`` in a layout of LAYOUTS."""
    kw = dict(LAYOUTS[layout])
    kw.setdefault("shift_energy", False)
    n = pos.shape[0]
    types = (np.arange(n) % 2).astype(np.int32)
    eps_i = np.ones(n, np.float32)
    table = kw.pop("eps_table", None)
    if table is not None:
        eps_scale, _, eps_diag, _ = pair_scale_tables(table)
        kw["eps_scale"] = eps_scale
        eps_i = eps_diag[types]
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=cap, tilt=tilt,
                             **kw)
    extra = None
    if spec.has_bonds:
        m = n // 2 * 2
        bonds = np.stack([np.arange(0, m, 2), np.arange(1, m, 2)], axis=1)
        extra = bond_partner_attrs(bonds, n)
    box = (Box.cubic(L, device) if tilt is None
           else Box.triclinic(L, L, L, device, *tilt))
    st, ovf = pack_host(pos, box, spec, types, eps_i, np.ones(n, np.float32),
                        device, extra_attrs=extra)
    assert not ovf
    return st, spec


def occupancy(st, spec) -> np.ndarray:
    return (st.pid < spec.n_real).reshape(spec.cap, -1).sum(0).cpu().numpy()


def assert_pair_close(a, b, with_energy):
    fmax = float(b.f.abs().max())
    df = float((a.f - b.f).abs().max())
    assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (df, fmax)
    if with_energy:
        torch.testing.assert_close(a.potential_energy, b.potential_energy,
                                   rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a.virial, b.virial, rtol=1e-5, atol=0.0)


def check_pair(st, spec, with_energy=True):
    """Kernel 1 against the plain force; vacant slots get zero force; a
    second call gives the same bits."""
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    a2 = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 2
    assert_pair_close(a, b, with_energy)
    assert torch.all(a.f[:, st.pid >= spec.n_real] == 0.0)
    assert torch.equal(a.f, a2.f)
    if with_energy:
        assert torch.equal(a.potential_energy, a2.potential_energy)
        assert torch.equal(a.virial, a2.virial)
    return a


def check_order_force(st, spec, cvs):
    """Kernel 3 against the plain sweep; zero force on vacant slots; a
    second call gives the same bits."""
    ref = tpo.order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=st.r.device))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    before = poc.order_force_cuda.launches
    g = poc.order_force_cuda(st, spec, cvs, auxs)
    g2 = poc.order_force_cuda(st, spec, cvs, auxs)
    g_ref = tpo.order_force_plain(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    assert poc.order_force_cuda.launches == before + 2
    gmax = float(g_ref.abs().max())
    assert gmax > 1e-4
    d = (g - g_ref).abs()
    assert float((d - 2e-3 * g_ref.abs()).max()) <= 2e-4 * gmax, (
        float(d.max()), gmax)
    assert torch.all(g[:, st.pid >= spec.n_real] == 0.0)
    assert torch.equal(g, g2)
    return g


def assert_lanes_close(cvs, terms, ref, rtol):
    """max|Δlane| ≤ rtol·max|lane| within each CV's value lanes."""
    for cv, t, r in zip(cvs, terms, ref):
        a = torch.cat([x.reshape(-1) for x in t])
        b = torch.cat([x.reshape(-1) for x in r])
        scale = float(b.abs().max())
        d = float((a - b).abs().max())
        assert scale > 0 and np.isfinite(d) and d <= rtol * scale, (
            cv.name, d, scale)


def check_order_values(st, spec, cvs):
    """Kernel 2 against the plain sweep; a second call gives the same
    bits."""
    before = poc.order_values_cuda.launches
    terms = poc.order_values_cuda(st, spec, cvs)
    terms2 = poc.order_values_cuda(st, spec, cvs)
    ref = tpo.order_values_plain(st, spec, cvs)
    torch.cuda.synchronize()
    assert poc.order_values_cuda.launches == before + 2
    assert_lanes_close(cvs, terms, ref, 2e-5)
    for t, t2 in zip(terms, terms2):
        for x, x2 in zip(t, t2):
            assert torch.equal(x, x2)
    return terms


def check_fused(st, spec, cvs):
    """Kernel 4 against its plain chain (f, g and the value lanes); zero
    forces on vacant slots; a second call gives the same bits."""
    ref = tpo.order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=st.r.device))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    before = pfc.fused_lj_order_force_cuda.launches
    f, g, terms = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    f2, g2, terms2 = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    f_ref, g_ref, terms_ref = pfc.fused_lj_order_force_plain(st, spec, cvs,
                                                             auxs)
    torch.cuda.synchronize()
    assert pfc.fused_lj_order_force_cuda.launches == before + 2
    fmax = float(f_ref.abs().max())
    df = float((f - f_ref).abs().max())
    assert np.isfinite(df) and df <= 1e-3 * fmax, (df, fmax)
    gmax = float(g_ref.abs().max())
    assert gmax > 1e-4
    d = (g - g_ref).abs()
    assert float((d - 2e-3 * g_ref.abs()).max()) <= 2e-4 * gmax, (
        float(d.max()), gmax)
    assert_lanes_close(cvs, terms, terms_ref, 2e-4)
    vac = st.pid >= spec.n_real
    assert torch.all(f[:, vac] == 0.0) and torch.all(g[:, vac] == 0.0)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    for t, t2 in zip(terms, terms2):
        for x, x2 in zip(t, t2):
            assert torch.equal(x, x2)


def cv_set(name: str, spec):
    return {"q6": [PackedSteinhardtQl(spec, r_cut=1.49, l=6)],
            "q4": [PackedSteinhardtQl(spec, r_cut=1.49, l=4)],
            "coord": [PackedCoordination(spec, r0=1.6, r_cut=2.4)],
            "q6_coord": [PackedSteinhardtQl(spec, r_cut=1.49, l=6),
                         PackedCoordination(spec, r0=1.6, r_cut=2.4)],
            "coord_no_cut": [PackedCoordination(spec, r0=1.6)]}[name]


def vacant_near_real(st, spec, gap: float = 0.9):
    """``st`` with the last vacant slot of every cell moved ``gap`` from the
    first real particle of its cell (the validity layout's trap: the pack
    leaves vacant slots at 0, the integrator moves them).  Returns (state,
    moved slots)."""
    r = st.r.clone()
    pid = st.pid.cpu().numpy()
    cap, C = spec.cap, spec.n_cells
    moved = []
    for cell in range(C):
        slots = np.arange(cap) * C + cell
        real = slots[pid[slots] < spec.n_real]
        vac = slots[pid[slots] >= spec.n_real]
        if len(real) and len(vac):
            r[:, int(vac[-1])] = r[:, int(real[0])] + torch.tensor(
                [gap, 0.0, 0.0], device=r.device)
            moved.append(int(vac[-1]))
    return st.replace(r=r), moved


def vacant_pair(st, spec):
    """``st`` with two vacant slots of cell 0 put 1e-4 apart, 0.9 from a
    real particle (the NaN trap: 0 * inf in a power chain)."""
    r = st.r.clone()
    pid = st.pid.cpu().numpy()
    slots = np.arange(spec.cap) * spec.n_cells
    real = slots[pid[slots] < spec.n_real]
    vac = slots[pid[slots] >= spec.n_real]
    assert len(vac) >= 2
    x0 = r[:, int(real[0])] + torch.tensor([0.0, 0.9, 0.0], device=r.device)
    r[:, int(vac[0])] = x0
    r[:, int(vac[1])] = x0 + torch.tensor([1e-4, 0.0, 0.0], device=r.device)
    return st.replace(r=r)


# --- the prefilter's geometry, on the CPU ----------------------------------

def _box(Ls, tilt):
    if tilt is None:
        return Box.from_lengths(*Ls, "cpu")
    return Box.triclinic(*Ls, "cpu", *tilt)


def _cart(f: torch.Tensor, box) -> torch.Tensor:
    """(3, M) fractional → Cartesian rows, in float64."""
    Lx, Ly, Lz, xyLy, xzLz, yzLz = box.h_host()
    f = f.double()
    return torch.stack([Lx * f[0] + xyLy * f[1] + xzLz * f[2],
                        Ly * f[1] + yzLz * f[2], Lz * f[2]])


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
@settings(max_examples=40, deadline=None)
@given(data=hst.data())
def test_prefilter_drops_no_pair_within_cut(tilted, data):
    """Random boxes, cells and rows: every candidate within r_cut of some i
    row of the cell is kept."""
    Ls = data.draw(hst.tuples(*[hst.floats(8.0, 30.0)] * 3), label="L")
    tilt = (data.draw(hst.tuples(*[hst.floats(-0.5, 0.5)] * 3),
                      label="tilt") if tilted else None)
    rc = data.draw(hst.floats(0.3, 2.6), label="r_cut")
    seed = data.draw(hst.integers(0, 2**31 - 1), label="seed")
    box = _box(Ls, tilt)
    rng = np.random.default_rng(seed)
    cpd = rng.integers(3, 6, size=3)
    cell = rng.integers(0, cpd)
    # i rows in one cell's bin of fractional coordinates, drifted by up to
    # half a bin; candidates near them and across the 27-cell stencil,
    # their fractional coordinates shifted by whole box periods at random
    lo = (cell / cpd - 0.5)[:, None]
    fi = lo + rng.uniform(-0.25, 1.25, (3, 24)) / cpd[:, None]
    xi = _cart(torch.as_tensor(fi), box)
    near = xi[:, rng.integers(0, 24, 200)] + torch.as_tensor(
        rng.normal(0.0, 1.0, (3, 200)) * rc)
    wide = _cart(torch.as_tensor(lo + rng.uniform(-1.0, 2.0, (3, 200))
                                 / cpd[:, None]), box)
    xj = torch.cat([near, wide], dim=1)
    radius = poc.prefilter_radius(rc * rc, box.perpendicular_widths_host())
    keep = poc.prefilter_keep(xi.float(), xj.float(), box, radius)
    d2 = ((xi[:, :, None] - xj[:, None, :]) ** 2).sum(0)
    within = (d2 < rc * rc).any(dim=0)
    assert bool(within.any())
    assert not bool((within & ~keep).any()), int((within & ~keep).sum())


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
@settings(max_examples=40, deadline=None)
@given(data=hst.data())
def test_fused_prefilter_drops_no_pair_within_cut(tilted, data):
    """The fused kernel stages once for the LJ and the CV math: at its
    radius (``fused_reach``) every candidate within the LJ cut-off or the
    CV cut-off of some i row of the cell is kept; a CV without a cut-off
    keeps every row."""
    Ls = data.draw(hst.tuples(*[hst.floats(8.0, 30.0)] * 3), label="L")
    tilt = (data.draw(hst.tuples(*[hst.floats(-0.5, 0.5)] * 3),
                      label="tilt") if tilted else None)
    rc_lj = data.draw(hst.floats(0.3, 2.6), label="r_cut")
    rc_cv = data.draw(hst.one_of(hst.floats(0.3, 2.6), hst.none()),
                      label="cv r_cut")
    seed = data.draw(hst.integers(0, 2**31 - 1), label="seed")
    box = _box(Ls, tilt)
    rng = np.random.default_rng(seed)
    cpd = rng.integers(3, 6, size=3)
    cell = rng.integers(0, cpd)
    lo = (cell / cpd - 0.5)[:, None]
    fi = lo + rng.uniform(-0.25, 1.25, (3, 24)) / cpd[:, None]
    xi = _cart(torch.as_tensor(fi), box)
    # candidates near the i rows at the scale of each cut-off
    scale = np.repeat([rc_lj, rc_cv or rc_lj], 100)
    near = xi[:, rng.integers(0, 24, 200)] + torch.as_tensor(
        rng.normal(0.0, 1.0, (3, 200)) * scale)
    wide = _cart(torch.as_tensor(lo + rng.uniform(-1.0, 2.0, (3, 200))
                                 / cpd[:, None]), box)
    xj = torch.cat([near, wide], dim=1)
    rc2_cv = math.inf if rc_cv is None else rc_cv * rc_cv
    rc2_hit, radius = pfc.fused_reach(rc_lj, rc2_cv,
                                      box.perpendicular_widths_host())
    assert rc2_hit == max(rc_lj * rc_lj, rc2_cv)
    keep = poc.prefilter_keep(xi.float(), xj.float(), box, radius)
    if rc_cv is None:
        assert bool(keep.all())
        return
    d2 = ((xi[:, :, None] - xj[:, None, :]) ** 2).sum(0)
    for rc in (rc_lj, rc_cv):
        within = (d2 < rc * rc).any(dim=0)
        assert bool(within.any())
        assert not bool((within & ~keep).any()), (rc, int((within
                                                           & ~keep).sum()))


@pytest.mark.parametrize("tilted", [False, True], ids=["ortho", "tilted"])
def test_prefilter_drops_rows_out_of_reach(tilted):
    """Rows farther than the radius from the i rows' box along a face
    normal are dropped, rows inside the box kept; no cut-off keeps all."""
    box = _box((12.0, 13.0, 14.0), TILT if tilted else None)
    w = box.perpendicular_widths_host()
    rng = np.random.default_rng(3)
    fi = torch.as_tensor(rng.uniform(-0.1, 0.1, (3, 16)))
    xi = _cart(fi, box).float()
    radius = poc.prefilter_radius(1.5 ** 2, w)
    f_far = torch.zeros((3, 3), dtype=torch.float64)
    for d in range(3):
        f_far[d, d] = float(fi[d].max()) + 1.01 * radius / w[d]
    xj = torch.cat([xi, _cart(f_far, box).float()], dim=1)
    keep = poc.prefilter_keep(xi, xj, box, radius)
    assert keep.tolist() == [True] * 16 + [False] * 3
    assert bool(poc.prefilter_keep(
        xi, xj, box, poc.prefilter_radius(math.inf, w)).all())


# --- the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["ortho", "tilted"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pair_kernel_layouts_match_plain(cuda_device, layout, tilt,
                                         with_energy):
    st, spec = pack(cuda_device, fcc_positions(), layout, tilt)
    check_pair(st, spec, with_energy)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs", "d_table_fene"])
def test_pair_kernel_cell_filled_to_cap(cuda_device, layout):
    """Three particles added at octahedral sites of one cell: that cell
    holds exactly cap rows, and cap is not a multiple of 32."""
    pos = fcc_positions()
    extra = pos[:3] + np.float32(A_LAT / 2) * np.eye(3, dtype=np.float32)
    pos = np.concatenate([pos, extra])
    st, spec = pack(cuda_device, pos, layout, cap=64)
    cap = int(occupancy(st, spec).max())
    assert cap % 32 != 0
    st, spec = pack(cuda_device, pos, layout, cap=cap)
    assert int(occupancy(st, spec).max()) == spec.cap
    check_pair(st, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs", "c_table",
                                    "d_table_fene"])
def test_pair_kernel_empty_cells(cuda_device, layout):
    """Only the particles with x < 0: the cells of the other half are
    empty (in the per-slot layouts their vacant slots all sit at 0)."""
    pos = fcc_positions()
    pos = pos[pos[:, 0] < 0.0]
    pos = pos[: pos.shape[0] // 2 * 2]          # whole bonded pairs
    st, spec = pack(cuda_device, pos, layout, cap=37)
    assert (occupancy(st, spec) == 0).any()
    check_pair(st, spec)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["b_se_hs", "c_table", "d_table_fene"])
def test_pair_kernel_vacant_traps(cuda_device, layout):
    """Vacant slots moved next to real particles, and two of them 1e-4
    apart: they get no force and give none."""
    st, spec = pack(cuda_device, fcc_positions(), layout, tilt=TILT)
    st, _ = vacant_near_real(st, spec)
    a = check_pair(vacant_pair(st, spec), spec)
    assert bool(torch.isfinite(a.f).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["d_table_fene", "d_usig_harmonic"])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["ortho", "tilted"])
def test_pair_kernel_bond_across_face(cuda_device, layout, tilt):
    """The lattice shifted by a quarter cell: the pack wraps the beads past
    the faces, so bonded pairs straddle the box faces."""
    pos = fcc_positions() + np.float32(A_LAT / 4)
    st, spec = pack(cuda_device, pos, layout, tilt)
    slot_of = st.slot_of.long()
    d = st.r[:, slot_of[0::2]] - st.r[:, slot_of[1::2]]
    assert bool((d.abs().max(dim=0).values > L / 2).any())
    check_pair(st, spec)


@pytest.mark.cuda
def test_pair_kernel_cap_too_large_raises(cuda_device):
    """27 × cap staged rows past a block's shared memory: the wrapper
    raises, with no plain fallback and no launch counted."""
    st, spec = pack(cuda_device, fcc_positions(), "a_sentinel", cap=2048)
    before = packed_lj_force_cuda.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        packed_lj_force_cuda(st, spec, with_energy=True)
    cvs = cv_set("q6", spec)
    auxs = [cv.grad_aux(t, torch.tensor(1.0, device=cuda_device))
            for cv, t in zip(cvs, tpo.order_values_plain(st, spec, cvs))]
    with pytest.raises(RuntimeError, match="shared memory"):
        poc.order_force_cuda(st, spec, cvs, auxs)
    assert packed_lj_force_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cvs", ["q6", "q4", "coord", "q6_coord",
                                 "coord_no_cut"])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["ortho", "tilted"])
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs"],
                         ids=["sentinel", "validity"])
def test_order_force_kernel_matches_plain(cuda_device, layout, tilt, cvs):
    st, spec = pack(cuda_device, fcc_positions(), layout, tilt)
    moved = []
    if not spec.sentinel:
        st, moved = vacant_near_real(st, spec)
        st = vacant_pair(st, spec)
    g = check_order_force(st, spec, cv_set(cvs, spec))
    assert torch.all(g[:, moved] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_cap", "empty_cells"])
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs"],
                         ids=["sentinel", "validity"])
def test_order_force_kernel_edge_cells(cuda_device, layout, case):
    pos = fcc_positions()
    if case == "full_cap":
        extra = pos[:3] + np.float32(A_LAT / 2) * np.eye(3, dtype=np.float32)
        pos = np.concatenate([pos, extra])
        st, spec = pack(cuda_device, pos, layout, cap=64)
        cap = int(occupancy(st, spec).max())
        assert cap % 32 != 0
    else:
        pos = pos[pos[:, 0] < 0.0]
        cap = 37
    st, spec = pack(cuda_device, pos, layout, tilt=TILT, cap=cap)
    if case == "empty_cells":
        assert (occupancy(st, spec) == 0).any()
    check_order_force(st, spec, cv_set("q6_coord", spec))


@pytest.mark.cuda
@pytest.mark.parametrize("cvs", ["q6", "q4", "coord", "q6_coord",
                                 "coord_no_cut"])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["ortho", "tilted"])
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs"],
                         ids=["sentinel", "validity"])
def test_order_values_kernel_matches_plain(cuda_device, layout, tilt, cvs):
    """Kernel 2 for each CV-kind set (the fixed value lanes of [Q6] and
    [Q6, coordination], and the lanes read from the descriptor); in the
    validity layout with vacant slots next to real ones and two vacant
    slots 1e-4 apart."""
    st, spec = pack(cuda_device, fcc_positions(), layout, tilt)
    if not spec.sentinel:
        st, moved = vacant_near_real(st, spec)
        assert moved
        st = vacant_pair(st, spec)
    check_order_values(st, spec, cv_set(cvs, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_cap", "empty_cells"])
@pytest.mark.parametrize("layout", ["a_sentinel", "b_se_hs"],
                         ids=["sentinel", "validity"])
def test_order_values_kernel_edge_cells(cuda_device, layout, case):
    pos = fcc_positions()
    if case == "full_cap":
        extra = pos[:3] + np.float32(A_LAT / 2) * np.eye(3, dtype=np.float32)
        pos = np.concatenate([pos, extra])
        st, spec = pack(cuda_device, pos, layout, cap=64)
        cap = int(occupancy(st, spec).max())
        assert cap % 32 != 0
    else:
        pos = pos[pos[:, 0] < 0.0]
        cap = 37
    st, spec = pack(cuda_device, pos, layout, tilt=TILT, cap=cap)
    if case == "full_cap":
        assert int(occupancy(st, spec).max()) == spec.cap
    else:
        assert (occupancy(st, spec) == 0).any()
    for name in ("q6", "q6_coord", "coord_no_cut"):
        check_order_values(st, spec, cv_set(name, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("cvs", ["q6", "coord", "q6_coord"])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["ortho", "tilted"])
def test_fused_kernel_matches_plain(cuda_device, tilt, cvs):
    st, spec = pack(cuda_device, fcc_positions(), "a_sentinel", tilt)
    check_fused(st, spec, cv_set(cvs, spec))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["full_cap", "empty_cells"])
def test_fused_kernel_edge_cells(cuda_device, case):
    pos = fcc_positions()
    if case == "full_cap":
        extra = pos[:3] + np.float32(A_LAT / 2) * np.eye(3, dtype=np.float32)
        pos = np.concatenate([pos, extra])
        st, spec = pack(cuda_device, pos, "a_sentinel", cap=64)
        cap = int(occupancy(st, spec).max())
        assert cap % 32 != 0
    else:
        pos = pos[pos[:, 0] < 0.0]
        cap = 37
    st, spec = pack(cuda_device, pos, "a_sentinel", tilt=TILT, cap=cap)
    if case == "empty_cells":
        assert (occupancy(st, spec) == 0).any()
    check_fused(st, spec, cv_set("q6_coord", spec))


@pytest.mark.cuda
def test_values_and_fused_cap_too_large_raise(cuda_device):
    """27 × cap staged rows past a block's shared memory: kernels 2 and 4
    raise, with no plain fallback and no launch counted."""
    st, spec = pack(cuda_device, fcc_positions(), "a_sentinel", cap=2048)
    cvs = cv_set("q6_coord", spec)
    auxs = [cv.grad_aux(t, torch.tensor(1.0, device=cuda_device))
            for cv, t in zip(cvs, tpo.order_values_plain(st, spec, cvs))]
    before = (poc.order_values_cuda.launches,
              pfc.fused_lj_order_force_cuda.launches)
    with pytest.raises(RuntimeError, match="shared memory"):
        poc.order_values_cuda(st, spec, cvs)
    with pytest.raises(RuntimeError, match="shared memory"):
        pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    assert (poc.order_values_cuda.launches,
            pfc.fused_lj_order_force_cuda.launches) == before
