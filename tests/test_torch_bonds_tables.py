"""The port's plain pair force in its per-slot, table, bonded and soft
layouts against the JAX package's ``packed_lj_force``, on the same packed
state (packed by the reference, carried across by interop).

Inputs: the lattice melt of tests/test_torch_bond_kernels.py (64 diblock
chains of 8 beads at ρ 0.85, L = 8.44, noise 0.05), numpy-seeded.
Tolerances: forces max|Δf| ≤ 1e-5·max|f| + 1e-5 (f32 sums over the same
pairs in another order), PE rtol 1e-5, virial rtol 1e-4 (a sum of terms of
both signs).
"""
import numpy as np
import pytest
import torch

import jax

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.ops import packed as tp

from tests.test_torch_bond_kernels import WCA_RC, lattice_melt

EPS2 = [[1.0, 0.6], [0.6, 1.0]]
EPS3 = [[1.0, 0.5, 0.2], [0.5, 0.8, 0.6], [0.2, 0.6, 1.1]]
SIG3 = [[1.0, 1.05, 0.95], [1.05, 1.2, 1.1], [0.95, 1.1, 0.9]]

# name -> (PackedSpec.create keywords, eps table, sigma table, A of soft)
CASES = {
    "se_hs_table2_fene": (dict(r_cut=2.5, skin=0.3, cap=32,
                               shift_energy=False, fene_k=30.0,
                               fene_r0=1.5), EPS2, None, None),
    "table3_onehot": (dict(r_cut=2.5, skin=0.3, cap=32, shift_energy=True),
                      EPS3, SIG3, None),
    "se_usig_fene": (dict(r_cut=WCA_RC, skin=0.4, cap=16, shift_energy=True,
                          fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0),
                     None, None, None),
    "harmonic": (dict(r_cut=WCA_RC, skin=0.4, cap=16, shift_energy=True,
                      fene_k=80.0, fene_r0=1.0, bond_kind="harmonic"),
                 None, None, None),
    "soft_fene": (dict(r_cut=1.0, skin=1.0, cap=24, pair_kind="soft",
                       fene_k=30.0, fene_r0=1.5), None, None, 100.0),
}

_jforce = jax.jit(jp.packed_lj_force, static_argnums=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _types3(types):
    """A third type on every fourth bead, for the one-hot table path."""
    t = types.copy()
    t[::4] = 2
    return t


def _case(name):
    """(reference state, reference spec, port state, port spec)."""
    kw, eps_t, sig_t, soft_a = CASES[name]
    pos, vel, bonds, types, L = lattice_melt()
    n = pos.shape[0]
    if eps_t is not None and len(eps_t) == 3:
        types = _types3(types)
    eps_i = np.full(n, soft_a or 1.0, np.float32)
    sigma_i = np.ones(n, np.float32)
    es = ss = None
    if eps_t is not None:
        es, ss, ed, sd = jp.pair_scale_tables(eps_t, sig_t)
        eps_i = ed[types]
        if sd is not None:
            sigma_i = sd[types]
    jspec = jp.PackedSpec.create(L, n, eps_scale=es, sigma_scale=ss, **kw)
    extra = (jp.bond_partner_attrs(bonds, n) if jspec.has_bonds else {})
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, types, eps_i,
                            sigma_i, vel=vel, extra_attrs=extra)
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


def _close(out, ref, with_energy=True):
    f, jf = out.f.numpy(), np.asarray(ref.f)
    fmax = np.abs(jf).max()
    assert np.isfinite(f).all()
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5 * fmax + 1e-5)
    if with_energy:
        np.testing.assert_allclose(float(out.potential_energy),
                                   float(ref.potential_energy), rtol=1e-5)
        np.testing.assert_allclose(out.virial.numpy(),
                                   np.asarray(ref.virial), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(
                                       ref.virial)).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_force_matches_reference(name):
    jst, jspec, st, spec = _case(name)
    assert interop.packed_spec_fields(spec) == {
        k: getattr(jspec, k) for k in interop.packed_spec_fields(spec)}
    ref = _jforce(jst, jspec)
    out = tp.packed_lj_force(st, spec)
    _close(out, ref)
    # the forces-only mode gives the same forces and keeps PE and virial
    fo = tp.packed_lj_force(st, spec, with_energy=False)
    assert torch.equal(fo.f, out.f)
    assert torch.equal(fo.potential_energy, st.potential_energy)
    if spec.has_bonds:
        # bonded forces are there: the chain pulls on every bead
        assert float(out.f.abs().max()) > 1.0


@pytest.mark.parametrize("name", ["se_hs_table2_fene", "table3_onehot"])
def test_pack_host_and_repack_carry_types_and_bonds(name):
    """pack_host and the incremental repack carry ``typ`` and the ``bp*``
    attrs with the slots, array for array as the reference does."""
    kw, eps_t, sig_t, _ = CASES[name]
    pos, vel, bonds, types, L = lattice_melt()
    n = pos.shape[0]
    if len(eps_t) == 3:
        types = _types3(types)
    jst, jspec, _, spec = _case(name)
    es, ss, ed, sd = tp.pair_scale_tables(eps_t, sig_t)
    eps_i = ed[types]
    sigma_i = np.ones(n, np.float32) if sd is None else sd[types]
    extra = tp.bond_partner_attrs(bonds, n) if spec.has_bonds else {}
    st, ovf = tp.pack_host(pos, Box.cubic(L, "cpu"), spec, types, eps_i,
                           sigma_i, "cpu", vel=vel, extra_attrs=extra)
    assert not ovf
    a = interop.packed_state_arrays(st)
    for k in ("pid", "typ", "slot_of"):
        np.testing.assert_array_equal(a[k], np.asarray(getattr(jst, k)), k)
    assert sorted(a["attrs"]) == sorted(jst.attrs)
    for k, v in a["attrs"].items():
        np.testing.assert_array_equal(v, np.asarray(jst.attrs[k]), k)
    # drift every real slot and repack in both packages
    rng = np.random.default_rng(4)
    real = np.asarray(jst.pid) < n
    dr = (rng.normal(0.0, 0.3, jst.r.shape) * real).astype(np.float32)
    jst = jst.replace(r=jst.r + dr)
    jout, jbad = jax.jit(jp.repack_incremental, static_argnums=1)(jst, jspec)
    out, bad = tp.repack_incremental(st.replace(r=st.r + torch.as_tensor(dr)),
                                     spec)
    assert bool(bad) == bool(jbad) is False
    assert not np.array_equal(out.slot_of.numpy(), st.slot_of.numpy())
    for k in ("pid", "typ", "slot_of"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(jout, k)), k)
    for k in out.attrs:
        np.testing.assert_array_equal(out.attrs[k].numpy(),
                                      np.asarray(jout.attrs[k]), k)


def test_bond_past_rcut_keeps_fene():
    """A bond stretched past the WCA r_cut keeps FENE + WCA (the
    reference's tests/test_packed_bonds.py setup): the port and the
    reference agree and the stretched bond pulls inward."""
    L = 6.0
    pos = np.array([[-0.65, 0.0, 0.0], [0.65, 0.0, 0.0],
                    [-0.485, 2.0, 0.0], [0.485, 2.0, 0.0]], np.float32)
    bonds = np.array([[0, 1], [2, 3]], np.int32)
    n = 4
    jspec = jp.PackedSpec.create(L, n, r_cut=WCA_RC, skin=0.4, cap=8,
                                 fene_k=30.0, fene_r0=1.5)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            extra_attrs=jp.bond_partner_attrs(bonds, n))
    assert not ovf
    ref = _jforce(jst, jspec)
    out = tp.packed_lj_force(interop.packed_state_from(jst, "cpu"),
                             interop.packed_spec_from(jspec))
    _close(out, ref)
    f = out.f[:, out.slot_of.long()].T.numpy()
    assert f[0, 0] > 10.0 and f[1, 0] < -10.0


@pytest.mark.parametrize("name", ["se_hs_table2_fene", "se_usig_fene"])
def test_vacant_slots_close_together_give_no_nan(name):
    """Vacant slots drift in the per-slot layout; two of one cell 1e-4
    apart (r² = 1e-8) give no NaN, and the force matches the reference."""
    jst, jspec, st, spec = _case(name)
    vac = [(spec.cap - 1) * spec.n_cells, (spec.cap - 2) * spec.n_cells]
    assert bool((st.pid[vac] >= spec.n_real).all())
    r = np.asarray(jst.r).copy()
    r[:, vac[0]] = (0.3, 0.2, 0.1)
    r[:, vac[1]] = (0.3001, 0.2, 0.1)
    jst = jst.replace(r=jax.numpy.asarray(r))
    out = tp.packed_lj_force(interop.packed_state_from(jst, "cpu"), spec)
    assert torch.isfinite(out.f).all()
    assert torch.isfinite(out.potential_energy)
    _close(out, _jforce(jst, jspec))


def test_tables_and_bond_attrs_equal_reference():
    for eps_t, sig_t in ((EPS2, None), (EPS3, SIG3)):
        for a, b in zip(tp.pair_scale_tables(eps_t, sig_t),
                        jp.pair_scale_tables(eps_t, sig_t)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    _, _, bonds, _, _ = lattice_melt()
    n = int(bonds.max()) + 1
    for slots in (2, 3):
        a = tp.bond_partner_attrs(bonds, n, slots)
        b = jp.bond_partner_attrs(bonds, n, slots)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        tp.bond_partner_attrs(np.array([[0, 1], [0, 2], [0, 3]]), 4, 2)
    # the scale functions agree with the reference's at every type pair
    for tab in (EPS2, EPS3):
        kt, kj = tp._scale_fn(tab), jp._scale_fn(tab)
        for i in range(len(tab) + 1):           # the vacant type included
            for j in range(len(tab) + 1):
                got = float(kt(torch.tensor(float(i)), torch.tensor(float(j))))
                want = float(kj(np.float32(i), np.float32(j)))
                assert got == pytest.approx(want, abs=1e-6), (tab, i, j)
