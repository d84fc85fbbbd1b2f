"""The card's kernels take every CV list and bond-slot count that the JAX
package's kernels take, and refuse only what those refuse; on the CPU.

- Lane layouts: ``packed_order_cuda.lane_layout`` in the monomial mode
  against the reference's ``packed_fused_pallas._lane_layout`` (a sphere
  CV of each l = 1..8, [Q6, Q4], [Q6, Q6], [Q6, Q4, coordination]), equal
  exactly; the lists the reference's lane asserts refuse (monomial Q_9,
  135 aux lanes; monomial [Q8, Q4], 138; a recurrence list of 136 value
  and 132 aux lanes) raise, and a list of 132 value and 128 aux lanes is
  refused by the values and fused kernels and taken by the force kernel,
  as the reference's asserts split them.
- The monomial mode for any l: the port's plain path (``pair_mono_sums``,
  ``mono_value_decode``, ``mono_force_vecs``, ``pair_mono_grad_terms``)
  for Q4 and Q8 against the reference's ``build_monomials``,
  ``mono_value_decode`` and ``mono_force_vecs`` (rtol 1e-5 of the
  largest), and against the recurrence (atol 2e-5 of the largest term or
  force); the descriptor's per-Q_l tables against the reference's
  matrices, exactly; and the general monomial mode of
  ``csrc/order_cv.cuh`` mirrored in numpy f32 from the descriptor as the
  kernel reads it (the conversion a = Cᵀ·aux, b = D·a, the power table,
  each monomial's exponents, the per-CV cut-offs) against the port's plain
  mono path for [Q6, Q4, coordination] with two cut-offs (values rtol
  2e-5 and forces 2e-5 of the largest).
- Wide lists: the descriptor and lanes of [Q8, Q10, Q12] (69 value, 66
  aux lanes); the port's plain values at l = 16 against the reference's
  XLA sweep (1e-4 of the largest term: the f32 p_lm tables of degree 16
  round the two sums' orders apart by ~3e-5).
- Bond slots: a 6-arm star melt (8 stars of 31 beads) on the port's plain
  pair force against the JAX package's ``packed_lj_force`` (forces
  1e-5·max|f| + 1e-5, PE rtol 1e-5); the wrappers' spec checks take 6
  slots and hand the kernel the first four columns and the other two
  stacked.

Inputs from numpy seeds; torch pinned to 2 threads.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.cv import ylm_mono as jym
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.ops.packed_fused_pallas import _lane_layout

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.cv import ylm_mono as tym
from metadyn_tpu_torch.ops import packed as tp
from metadyn_tpu_torch.ops import packed_cuda as pc
from metadyn_tpu_torch.ops import packed_order_cuda as poc
from metadyn_tpu_torch.ops import packed_v1_cuda as pv1

from tests.test_torch_bond_kernels import star_melt


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SPEC = tp.PackedSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8,
                            uniform_sigma=1.0, uniform_eps=1.0)


def _sphere(l: int):
    """A sphere-polynomial CV of degree ``l`` as the lane layouts read it
    (the packed Q_l takes even l only)."""
    return types.SimpleNamespace(l=l, sphere_poly=True, aux_size=2 * (l + 1),
                                 n_value_terms=2 * (l + 1) + 1, name=f"s{l}")


def _q(l: int, r_cut: float = 1.4, name: str = None):
    return tpo.PackedSteinhardtQl(SPEC, r_cut=r_cut, l=l,
                                  name=name or f"q{l}")


def _coord():
    return tpo.PackedCoordination(SPEC, r0=1.0, r_cut=1.5, name="co")


MONO_LISTS = {
    **{f"l{l}": (lambda l=l: [_sphere(l)]) for l in range(1, 9)},
    "q6_q4": lambda: [_q(6), _q(4)],
    "q6_q6": lambda: [_q(6, name="a"), _q(6, r_cut=1.2, name="b")],
    "q6_q4_coord": lambda: [_q(6), _q(4), _coord()],
}


@pytest.mark.parametrize("name", sorted(MONO_LISTS))
def test_mono_lane_layout_matches_reference(name):
    cvs = MONO_LISTS[name]()
    port = poc.lane_layout(cvs, mono=True)
    assert port == _lane_layout(cvs, True)
    assert poc.lane_layout(cvs) == _lane_layout(cvs, False)
    for values, aux in ((True, True), (True, False), (False, True)):
        poc.check_lanes(cvs, True, values, aux)


# name -> (CV list, mono, refused by (values, aux))
REFUSED = {
    "mono_l9": (lambda: [_sphere(9)], True, (False, True)),
    "mono_q8_q4": (lambda: [_q(8), _q(4)], True, (False, True)),
    "values_136_aux_132": (lambda: [_q(20, name=f"q{k}") for k in range(3)]
                           + [_q(2)], False, (True, True)),
    "values_132_aux_128": (lambda: [_q(14, name="a"), _q(14, name="b"),
                                    _q(16, name="c"), _q(16, name="d")],
                           False, (True, False)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_lane_refusals_match_reference(name):
    make, mono, (by_values, by_aux) = REFUSED[name]
    cvs = make()
    # the reference: one assert over both lanes in the fused kernel, the
    # value lanes in kernel 2 (packed_order_pallas.py:271), the aux lanes
    # in kernel 3 (:323)
    _, _, n_aux, n_vals = poc.lane_layout(cvs, mono)
    assert (n_vals > 128, n_aux > 128) == (by_values, by_aux)
    with pytest.raises(AssertionError):
        _lane_layout(cvs, mono)
    with pytest.raises(ValueError, match="exceed"):
        poc.check_lanes(cvs, mono, True, True)
    for values, aux in ((True, False), (False, True)):
        if (values and by_values) or (aux and by_aux):
            with pytest.raises(ValueError, match="exceed"):
                poc.check_lanes(cvs, mono, values, aux)
        else:
            poc.check_lanes(cvs, mono, values, aux)
    if not mono and not by_aux:
        # the force kernel's plan is made; the values kernel's refused
        poc._plan(tuple(cvs), torch.device("cpu"), values=False)
        with pytest.raises(ValueError):
            poc._plan(tuple(cvs), torch.device("cpu"), aux=False)


def _bonds(n=300, seed=0):
    """Random bond vectors, r in [0.9, 1.6], (3, n) f32."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d *= (rng.uniform(0.9, 1.6, n) / np.linalg.norm(d, axis=0)).astype(
        np.float32)
    return d


def _jq(l, r_cut=1.5):
    jspec = jp.PackedSpec.create(12.0, 100, r_cut=2.5, skin=0.5, cap=8)
    return jpo.PackedSteinhardtQl(spec=jspec, r_cut=r_cut, l=l, name=f"q{l}")


def _aux(l, seed):
    rng = np.random.default_rng(seed)
    gre = rng.normal(size=l + 1).astype(np.float32)
    gim = rng.normal(size=l + 1).astype(np.float32)
    gim[0] = 0.0
    return gre, gim


@pytest.mark.parametrize("l", [4, 8])
def test_plain_mono_matches_reference(l):
    jcv = _jq(l)
    cv = interop.steinhardt_from(jcv)
    d = _bonds(seed=l)
    u = d / np.linalg.norm(d, axis=0)
    for deg in (l - 1, l):
        ref = jym.build_monomials(deg, *u)
        out = tym.build_monomials(deg, *torch.as_tensor(u))
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), b)
    dt = torch.as_tensor(d)
    r2 = (dt * dt).sum(0)
    w = torch.ones_like(r2)
    sums = cv.pair_mono_sums(*dt, r2, w)
    assert sums.shape == (tym.n_mono(l) + 1,)
    re, im, nb = cv.mono_value_decode(sums[:-1], sums[-1])
    jre, jim, _ = jcv.mono_value_decode(jnp.asarray(sums[:-1].numpy()),
                                        jnp.asarray(sums[-1].numpy()))
    re_r, im_r, nb_r = cv.pair_value_terms(*dt, r2, w)
    scale = float(torch.cat([re_r, im_r]).abs().max())
    for a, b, c in ((re, jre, re_r), (im, jim, im_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0,
                                   atol=2e-5 * scale)
    assert float(nb) == float(nb_r) == float((r2 < 1.5 ** 2).sum())
    gre, gim = _aux(l, 7)
    aux = (torch.as_tensor(gre), torch.as_tensor(gim))
    b = cv.mono_force_vecs(aux)
    jb = jcv.mono_force_vecs((list(jnp.asarray(gre)), list(jnp.asarray(gim))))
    for x, y in zip(b, jb):
        assert x.shape == (tym.n_mono(l - 1),)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(y).max()))
    g = torch.stack(cv.pair_mono_grad_terms(*dt, r2, b))
    g_r = torch.stack(cv.pair_grad_terms(*dt, r2, aux))
    gs = float(g_r.abs().max())
    assert gs > 1e-3
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=0,
                               atol=2e-5 * gs)


def _mono_exps(d, t):
    """csrc/order_cv.cuh mono_exps: (i, j) of monomial t of degree d."""
    s = 0
    while (s + 1) * (s + 2) // 2 <= t:
        s += 1
    return d - s, s - (t - s * (s + 1) // 2)


def _general_mono_mirror(desc, n_cvs, aux, d):
    """The general monomial mode of ``csrc/order_cv.cuh`` in numpy f32, read
    from the descriptor as the kernel reads it, for bond vectors d (3, n):
    the prologue (per Q_l a_t = Σ_m C[m, t]·aux[aux_off + m] in m order
    into the scratch at its value lanes, then b[h6 + 4t + α] =
    value_αt · a[column_αt]), then per pair the powers of u up to the
    largest l (a pair on the queue: inside the largest Q_l cut-off), the
    force of each Q_l inside its own cut-off (degree-(l − 1) monomials in
    the kernel's loop order, the projection) and each Q_l's monomial sums
    over the pairs (monomial t from mono_exps).  Returns (g (3, n), the
    value lanes' sums)."""
    f32 = np.float32
    hdr = desc[:9 * n_cvs].reshape(n_cvs, 9)
    ql = [c for c in range(n_cvs) if int(hdr[c, 0]) == poc.KIND_QL]
    n_terms = max(int(hdr[c, 2]) + tym.n_mono(int(hdr[c, 1])) + 1
                  for c in ql)
    conv = np.zeros(n_terms, f32)
    bvec = np.zeros(sum(4 * tym.n_mono(int(hdr[c, 1]) - 1) for c in ql), f32)
    for c in ql:
        l, vo, ao, to = (int(hdr[c, k]) for k in (1, 2, 3, 4))
        nm = tym.n_mono(l)
        for t in range(nm):
            a = f32(0.0)
            for m in range(2 * (l + 1)):
                a = f32(a + f32(desc[to + m * nm + t] * aux[ao + m]))
            conv[vo + t] = a
    for c in ql:
        l, vo, to, bo = (int(hdr[c, k]) for k in (1, 2, 4, 6))
        nb = tym.n_mono(l - 1)
        cols = desc[to + 2 * (l + 1) * tym.n_mono(l):]
        for j in range(4 * nb):
            t, ax = j >> 2, j & 3
            bvec[bo + j] = (cols[3 * nb + ax * nb + t]
                            * conv[vo + int(cols[ax * nb + t])]
                            if ax < 3 else 0.0)
    r2 = (d * d).sum(0).astype(f32)
    live = r2 < max(hdr[c, 5] for c in ql)
    inv_r = np.where(live, 1.0 / np.sqrt(r2), 0.0).astype(f32)
    u = (d * inv_r).astype(f32)
    l_max = max(int(hdr[c, 1]) for c in ql)
    pw = np.ones((3, l_max + 1, d.shape[1]), f32)
    for n in range(1, l_max + 1):
        pw[:, n] = pw[:, n - 1] * u
    g = np.zeros_like(d)
    sums = np.zeros(n_terms, f32)
    for c in ql:
        l, vo, bo = int(hdr[c, 1]), int(hdr[c, 2]), int(hdr[c, 6])
        on = live & (r2 < hdr[c, 5])
        dd = l - 1
        gu = np.zeros_like(d)
        t = 0
        for i in range(dd, -1, -1):
            for j in range(dd - i, -1, -1):
                v = pw[0, i] * pw[1, j] * pw[2, dd - i - j]
                gu += bvec[bo + 4 * t:bo + 4 * t + 3, None] * v
                t += 1
        dot = (u * gu).sum(0)
        g += np.where(on, (gu - u * dot) * inv_r, 0.0)
        for t in range(tym.n_mono(l)):
            i, j = _mono_exps(l, t)
            sums[vo + t] = (pw[0, i] * pw[1, j] * pw[2, l - i - j])[on].sum()
        sums[vo + tym.n_mono(l)] = on.sum()
    return g, sums


def test_general_mono_mirror_matches_plain():
    cvs = [_q(6, r_cut=1.5), _q(4, r_cut=1.3), _coord()]
    desc = poc.cv_descriptor(cvs, mono=True)
    hdr = desc[:9 * 3].reshape(3, 9)
    # the force vectors' offsets (header slot 6) and the value lanes
    assert [int(hdr[c, 6]) for c in (0, 1)] == [0, 4 * tym.n_mono(5)]
    assert [int(hdr[c, 2]) for c in range(3)] == [0, 29, 45]
    assert poc._plan(tuple(cvs), torch.device("cpu"), True).n_bvec == \
        4 * (tym.n_mono(5) + tym.n_mono(3))
    for c, cv in enumerate(cvs[:2]):
        tab = desc[int(hdr[c, 4]):]
        ny, nm, nb = 2 * (cv.l + 1), tym.n_mono(cv.l), tym.n_mono(cv.l - 1)
        np.testing.assert_array_equal(
            tab[:ny * nm].reshape(ny, nm),
            jym.ylm_mono_matrix(cv.l).astype(np.float32))
        dense = np.zeros((3, nb, nm), np.float32)
        dense[np.repeat(np.arange(3), nb), np.tile(np.arange(nb), 3),
              tab[ny * nm:ny * nm + 3 * nb].astype(int)] = tab[
                  ny * nm + 3 * nb:ny * nm + 6 * nb]
        for a, b in zip(dense, jym.diff_matrices(cv.l)):
            np.testing.assert_array_equal(a, b.astype(np.float32))
    auxs = [tuple(torch.as_tensor(a) for a in _aux(cv.l, 11 + c))
            for c, cv in enumerate(cvs[:2])] + [torch.tensor(0.7)]
    flat = poc.pack_force_aux(cvs, auxs).numpy()
    d = _bonds(seed=5)
    g, sums = _general_mono_mirror(desc, 3, flat, d)
    dt = torch.as_tensor(d)
    r2 = (dt * dt).sum(0)
    g_ref = torch.zeros_like(dt)
    for cv, aux in zip(cvs[:2], auxs):
        g_ref += torch.stack(cv.pair_mono_grad_terms(
            *dt, r2, cv.mono_force_vecs(aux)))
        vo = int(hdr[cvs.index(cv), 2])
        ref = cv.pair_mono_sums(*dt, r2, torch.ones_like(r2)).numpy()
        got = sums[vo:vo + tym.n_mono(cv.l) + 1]
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())
    gs = float(g_ref.abs().max())
    assert gs > 1e-3
    np.testing.assert_allclose(g, g_ref.numpy(), rtol=0, atol=2e-5 * gs)


def test_wide_list_descriptor_and_lanes():
    cvs = [_q(8, 1.37, "q8"), _q(10, 1.37, "q10"), _q(12, 1.37, "q12")]
    aux_off, val_off, n_aux, n_vals = poc.lane_layout(cvs)
    assert (n_vals, n_aux) == (69, 66)
    assert val_off == [0, 19, 42] and aux_off == [0, 18, 40]
    desc = poc.cv_descriptor(cvs)
    hdr = desc[:27].reshape(3, 9)
    tab = 27
    for c, cv in enumerate(cvs):
        l = cv.l
        assert list(hdr[c, :5]) == [poc.KIND_QL, l, val_off[c], aux_off[c],
                                    tab]
        assert hdr[c, 5] == np.float32(1.37 ** 2)
        tab += (l + 1) + (l + 1) * (l + 2) // 2 + l * (l + 1) // 2 + 1
    assert desc.size == tab > 64
    plan = poc._plan(tuple(cvs), torch.device("cpu"))
    # past the narrow kernels' 64 lanes: the wide layout (order_cv.cuh)
    assert (plan.n_vals, plan.n_aux, plan.l_fixed, plan.lanes) == (
        69, 66, 0, poc.LANES_ANY)


def _fcc_state(l, n_cells=4, a=1.6, noise=0.05):
    """(reference state, spec, port state, spec): fcc with noise."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    g = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                 -1).reshape(-1, 1, 3)
    pos = ((g + base).reshape(-1, 3) * a).astype(np.float32)
    rng = np.random.default_rng(l)
    pos += rng.normal(0.0, noise, pos.shape).astype(np.float32)
    n, L = pos.shape[0], n_cells * a
    jspec = jp.PackedSpec.create(L, n, r_cut=1.6, skin=0.3, cap=24,
                                 uniform_sigma=1.0, uniform_eps=1.0)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


def test_plain_values_high_l_match_reference():
    jst, jspec, st, spec = _fcc_state(16)
    jcv = jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.5, l=16, name="q16")
    cv = interop.steinhardt_from(jcv)
    ref = jax.jit(jcv._sums)(jst)
    (out,) = tpo.order_values_plain(st, spec, [cv])
    scale = float(np.abs(np.concatenate([ref[0], ref[1]])).max())
    assert scale > 1.0
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * scale)
    assert float(out[2]) == float(ref[2])
    poc.check_lanes([cv], False, True, True)


def test_six_arm_star_plain_matches_reference():
    pos, bonds, L = star_melt(8)
    n = pos.shape[0]
    assert n == 8 * 31 and len(bonds) == 8 * 30
    jspec = jp.PackedSpec.create(L, n, r_cut=2.0 ** (1 / 6), skin=0.4,
                                 cap=24, fene_k=30.0, fene_r0=1.5,
                                 bond_slots=6)
    extra = jp.bond_partner_attrs(bonds, n, slots=6)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            extra_attrs=extra)
    assert not ovf
    st, spec = interop.packed_state_from(jst, "cpu"), \
        interop.packed_spec_from(jspec)
    assert spec.bond_slots == 6
    ref = jax.jit(jp.packed_lj_force, static_argnums=1)(jst, jspec)
    out = tp.packed_lj_force(st, spec)
    f, jf = out.f.numpy(), np.asarray(ref.f)
    fmax = np.abs(jf).max()
    assert np.isfinite(f).all() and fmax > 1.0
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5 * fmax + 1e-5)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    # every centre has its six partners in the slots
    centres = st.slot_of[::31].long()
    bp = torch.stack([st.attrs[f"bp{k}"] for k in range(6)])
    assert bool((bp[:, centres] > 0).all())
    # the card's checks take six slots, and the wrapper hands the kernel
    # bp0..bp3 and one (2, Npad) stack of bp4, bp5
    pc.check_spec(spec)
    pv1.check_spec_v1(spec)
    ptrs, more = pc.bond_ptrs(st, spec, "test")
    assert len(ptrs) == pc.REG_BOND_SLOTS + 1
    assert ptrs[:4] == [st.attrs[f"bp{k}"].data_ptr() for k in range(4)]
    assert more.shape == (2, spec.n_pad) and ptrs[4] == more.data_ptr()
    assert torch.equal(more, bp[4:])
    # four slots: no stack
    ptrs4, more4 = pc.bond_ptrs(st, dataclasses.replace(spec, bond_slots=4),
                                "test")
    assert more4 is None and ptrs4 == ptrs[:4] + [None]
