"""Kernel 4's monomial mode: its tables on the CPU, the kernel on the card.

On the CPU: the Q_6's table as the wrapper hands it to the kernel in the
descriptor (``packed_order_cuda.mono_tables``: C, and each row of D_x,
D_y, D_z as its one nonzero's column and value) against the JAX package's
``ylm_mono_matrix(6)`` and ``diff_matrices(6)``, and the kernel's
conversion of a Q_6's ``grad_aux`` into its force vectors from that table
in plain numpy (``_mono_force_vecs_mirror``) against the reference's
``mono_force_vecs`` and the port's (rtol 1e-5 of the largest component);
the monomial descriptor of a Q_4 and of two Q_6 (the general mode), the
refusals past the reference's lane row, and its lane layout.

On a card (``cuda`` tests, skipped elsewhere): every monomial
instantiation of kernel 4 and of its parts subsets against the plain
monomial path (``fused_lj_order_force_plain``), in a cubic and a tilted
box, for [Q6], [Q6, coordination] and [coordination, Q6] (the two fixed
lane layouts and one read from the descriptor) and, in the general
monomial mode, [Q4], [Q8], [Q6, Q4], [Q6, Q6] and [Q6, Q4, coordination]
(each Q_l with its own cut-off; the parts subsets on [Q6, Q4] too),
without and with a cell
mask of weights 0, 0.5 and 1, on 2,048 fcc particles with noise 0.05 and a
hole: the cells of the first x-plane empty, cells filled to a cap that is
not a multiple of 32, vacant slots beside real ones; two calls give the
same bits.  This part imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_mono_kernel.py

Tolerances (``chip_smoke.py``'s §2 gates for kernel 4): LJ forces atol
1e-3 of the largest; bias forces rtol 2e-3 and atol 2e-4 of the largest
component; value lanes rtol 2e-4 of each CV's largest.
"""
import itertools

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, PackedCoordination, PackedEngine, PackedSpec, PackedSteinhardtQl,
    fcc_lattice,
)
from metadyn_tpu_torch.cv.packed_order import order_values_plain
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc
from metadyn_tpu_torch.ops import packed_order_cuda as poc

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)
DV = (0.9, -1.3)
TILT = (0.2, -0.1, 0.1)


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


def _mono_force_vecs_mirror(table, gre, gim) -> tuple:
    """The fused kernel's conversion of a Q_6's ``grad_aux`` (re, im) into
    its three degree-5 coefficient vectors (``csrc/order_cv.cuh``, the
    prologue of ``order_staged_kernel``), in plain numpy f32 in the
    kernel's order, from the Q_6's ``table`` in the descriptor (C, the
    columns, the values): a_t = Σ_m C[m, t]·(re, im)_m for m = 0..13 in
    order, then b_α,j = value_αj · a[column_αj]."""
    C = table[:14 * 28].reshape(14, 28)
    cols = table[14 * 28:14 * 28 + 63].astype(np.int64)
    vals = table[14 * 28 + 63:14 * 28 + 126]
    re_im = np.concatenate([gre, gim]).astype(np.float32)
    a = np.zeros(28, np.float32)
    for m in range(14):
        a = a + C[m] * re_im[m]
    return tuple((vals * a[cols]).reshape(3, -1))


def test_tables_and_aux_conversion_match_reference():
    from metadyn_tpu.cv import packed_order as jpo
    from metadyn_tpu.cv import ylm_mono as jym
    from metadyn_tpu.ops.packed import PackedSpec as JSpec

    spec = PackedSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8)
    cv = PackedSteinhardtQl(spec, r_cut=1.5)
    co = PackedCoordination(spec, r0=1.0, r_cut=1.5)
    # the Q_6's table as the wrapper hands it to the kernel: in the
    # descriptor at its header's table offset
    desc = poc.cv_descriptor([co, cv], mono=True)
    off = int(desc[poc.HDR + 4])
    table = desc[off:]
    assert table.size == 14 * 28 + 2 * 63
    np.testing.assert_array_equal(
        table[:14 * 28].reshape(14, 28),
        jym.ylm_mono_matrix(6).astype(np.float32))
    dense = np.zeros((3, 21, 28), np.float32)
    dense[np.repeat(np.arange(3), 21), np.tile(np.arange(21), 3),
          table[14 * 28:14 * 28 + 63].astype(int)] = table[14 * 28 + 63:]
    for a, b in zip(dense, jym.diff_matrices(6)):
        np.testing.assert_array_equal(a, b.astype(np.float32))

    jcv = jpo.PackedSteinhardtQl(
        spec=JSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8), r_cut=1.5,
        l=6, name="q6")
    rng = np.random.default_rng(7)
    for _ in range(3):
        gre = rng.normal(size=7).astype(np.float32)
        gim = rng.normal(size=7).astype(np.float32)
        gim[0] = 0.0
        mirror = _mono_force_vecs_mirror(table, gre, gim)
        ref = jcv.mono_force_vecs((list(gre), list(gim)))
        port = cv.mono_force_vecs((torch.as_tensor(gre),
                                   torch.as_tensor(gim)))
        for x, y, z in zip(mirror, ref, port):
            scale = float(np.abs(np.asarray(y)).max())
            assert x.shape == (21,) and scale > 0.0
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5,
                                       atol=1e-5 * scale)
            np.testing.assert_allclose(x, z.numpy(), rtol=1e-5,
                                       atol=1e-5 * scale)


def test_monomial_descriptor_refusals():
    spec = PackedSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8,
                             uniform_sigma=1.0, uniform_eps=1.0)
    q6 = PackedSteinhardtQl(spec, r_cut=1.4, l=6, name="a")
    co = PackedCoordination(spec, r0=1.0, r_cut=1.5)
    # any Q_l and several: a Q_4 alone, two Q_6 (each with its tables and
    # its force vectors' offset in header slot 6); refused only past the
    # reference's lane row: Q_10 (165 aux lanes), [Q8, Q4] (138)
    q4 = PackedSteinhardtQl(spec, r_cut=1.4, l=4)
    q6b = PackedSteinhardtQl(spec, r_cut=1.2, l=6, name="b")
    poc.check_lanes([q4], True, True, True)
    desc = poc.cv_descriptor([q6, q6b], mono=True)
    assert [desc[6], desc[poc.HDR + 6]] == [0, 4 * 21]
    assert [desc[2], desc[poc.HDR + 2]] == [0, 29]
    for bad in ([PackedSteinhardtQl(spec, r_cut=1.4, l=10)],
                [PackedSteinhardtQl(spec, r_cut=1.4, l=8), q4]):
        with pytest.raises(ValueError, match="aux lanes exceed"):
            poc.check_lanes(bad, True, True, True)
    # the lanes of the reference's row: 3 n_mono(5) = 63 aux lanes and 29
    # summed value lanes for the Q_6 (the sweeps take its 14 recurrence
    # aux lanes; the second pass writes its 15 value lanes)
    assert poc.lane_layout([q6, co], mono=True) == ([0, 63], [0, 29], 64, 30)
    assert poc.lane_layout([co, q6], mono=True) == ([0, 1], [0, 1], 64, 30)
    desc = poc.cv_descriptor([co, q6], mono=True)
    assert list(desc[poc.HDR:poc.HDR + 4]) == [0, 6, 1, 1]
    np.testing.assert_array_equal(
        desc[int(desc[poc.HDR + 4]):],
        np.concatenate([t.reshape(-1).astype(np.float32)
                        for t in poc.mono_tables(6)]))


def _pack(pos, L, tilt, cap, device):
    spec = PackedSpec.create(L, pos.shape[0], r_cut=2.5, skin=0.5, cap=cap,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0, tilt=tilt)
    bx = (Box.triclinic(L, L, L, device, *tilt) if tilt
          else Box.cubic(L, device))
    n = pos.shape[0]
    st, ovf = PackedEngine(spec, device).pack_state(
        pos, bx, np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32))
    assert not ovf and spec.sentinel and spec.cells_per_dim == (4, 4, 4)
    # real rows per cell (slot = rank * C + cell; vacant rows at the
    # sentinel)
    occ = (st.r[0] < 1e6).reshape(cap, spec.n_cells).sum(0).cpu().numpy()
    return st, spec, occ


def _case(device, box: str, cvs_kind: str):
    """2,048 fcc particles (a = 1.62, shifted by a / 4) with noise 0.05,
    less those of the first x-plane of cells (a hole of 16 empty cells), at
    the cap of the fullest cell; the CVs of ``cvs_kind``."""
    pos = fcc_lattice(8, A_LAT)
    L = 8 * A_LAT
    rng = np.random.default_rng(3)
    # a quarter lattice constant puts atom planes on the cell faces: the
    # noise spreads the occupancy
    pos = (pos + A_LAT / 4 + rng.normal(0.0, 0.05, pos.shape)).astype(
        np.float32)
    tilt = TILT if box == "tilted" else None
    st, spec, occ = _pack(pos, L, tilt, 64, device)
    # the cell x index of each particle: its first-plane slots out
    cx = (torch.arange(spec.n_pad, device=device) % spec.n_cells
          ) // (spec.n_cells // 4)
    keep = (st.r[0] < 1e6) & (cx > 0)
    pos = st.r[:, keep].T.cpu().numpy()
    _, _, occ = _pack(pos, L, tilt, 64, device)
    st, spec, occ = _pack(pos, L, tilt, int(occ.max()), device)
    q6 = PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6")
    co = PackedCoordination(spec, r0=NN * 1.35, r_cut=NN * 1.35 * 1.5,
                            name="co")

    def ql(l, f=1.2, name=None):
        return PackedSteinhardtQl(spec, r_cut=NN * f, l=l,
                                  name=name or f"q{l}")

    cvs = {"q6": [q6], "q6_coord": [q6, co], "coord_q6": [co, q6],
           # the general monomial mode (GENERAL_LISTS)
           "q4": [ql(4)], "q8": [ql(8)], "q6_q4": [q6, ql(4, 1.1)],
           "q6_q6": [q6, ql(6, 1.05, "q6b")],
           "q6_q4_coord": [q6, ql(4, 1.1), co]}[cvs_kind]
    dV = torch.tensor([0.9, -1.3, 0.6][:len(cvs)], device=device)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in
            enumerate(zip(cvs, order_values_plain(st, spec, cvs)))]
    return st, spec, cvs, auxs, spec.cap, occ


def _mask(spec, device):
    """Weights 0, 0.5 and 1 in turn over the cells."""
    w = torch.tensor([0.0, 0.5, 1.0], device=device)
    return w[torch.arange(spec.n_cells, device=device) % 3].contiguous()


def _lanes(terms):
    return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])


def _close(a, b, rtol, atol_frac, what):
    scale = float(b.abs().max())
    worst = float(((a - b).abs() - rtol * b.abs()).max())
    assert np.isfinite(scale) and worst <= atol_frac * scale, (what, worst,
                                                                scale)


def _check(out, ref, cvs, parts=pfc.ALL_PARTS):
    (f, g, t), (fp, gp, tp) = out, ref
    if "lj" in parts:
        _close(f, fp, 0.0, 1e-3, "LJ force")
    else:
        assert int(torch.count_nonzero(f)) == 0
    if "force" in parts:
        assert float(gp.abs().max()) > 0.0
        _close(g, gp, 2e-3, 2e-4, "bias force")
    else:
        assert int(torch.count_nonzero(g)) == 0
    if "vals" in parts:
        for cv, x, y in zip(cvs, t, tp):
            d = float((_lanes([x]) - _lanes([y])).abs().max())
            assert d <= 2e-4 * float(_lanes([y]).abs().max()), (cv.name, d)
    else:
        assert int(torch.count_nonzero(_lanes(t))) == 0


def _same_bits(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(_lanes(a[2]), _lanes(b[2]))


# the CV lists of the general monomial mode (any Q_l list but one Q_6)
GENERAL_LISTS = ["q4", "q8", "q6_q4", "q6_q6", "q6_q4_coord"]


@pytest.mark.cuda
@pytest.mark.parametrize("box", ["cubic", "tilted"])
@pytest.mark.parametrize("cvs_kind",
                         ["q6", "q6_coord", "coord_q6"] + GENERAL_LISTS)
@pytest.mark.parametrize("masked", [False, True], ids=["whole", "masked"])
def test_mono_kernel_matches_plain(cuda_device, box, cvs_kind, masked):
    st, spec, cvs, auxs, cap, occ = _case(cuda_device, box, cvs_kind)
    assert cap % 32 and (occ == 0).sum() == 16 and (occ == cap).any()
    assert (occ[occ > 0] < cap).any()
    mask = _mask(spec, cuda_device) if masked else None
    counts = (pfc.fused_lj_order_force_cuda.mono_launches,
              pfc.fused_lj_order_force_cuda.masked_launches)
    out = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs, mono=True,
                                        cell_mask=mask)
    assert (pfc.fused_lj_order_force_cuda.mono_launches - counts[0],
            pfc.fused_lj_order_force_cuda.masked_launches - counts[1]) == \
        ((0, 1) if masked else (1, 0))
    ref = pfc.fused_lj_order_force_plain(st, spec, cvs, auxs, mono=True,
                                         cell_mask=mask)
    _check(out, ref, cvs)
    _same_bits(out, pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                                  mono=True, cell_mask=mask))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [
    frozenset(c) for k in range(3)
    for c in itertools.combinations(sorted(pfc.ALL_PARTS), k)],
    ids=lambda p: "-".join(sorted(p)) or "none")
@pytest.mark.parametrize("cvs_kind", ["q6_coord", "q6_q4"])
def test_mono_parts_match_plain(cuda_device, parts, cvs_kind):
    st, spec, cvs, auxs, _, _ = _case(cuda_device, "cubic", cvs_kind)
    mask = _mask(spec, cuda_device)
    for m in (None, mask):
        out = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs, parts=parts,
                                            mono=True, cell_mask=m)
        ref = pfc.fused_lj_order_force_plain(st, spec, cvs, auxs, mono=True,
                                             cell_mask=m, parts=parts)
        _check(out, ref, cvs, parts)
        _same_bits(out, pfc.fused_lj_order_force_cuda(
            st, spec, cvs, auxs, parts=parts, mono=True, cell_mask=m))
