"""The port's packed state, repack and plain pair force against the JAX
package, on the same arrays (carried across by metadyn_tpu_torch.interop).

Shared size: fcc_lattice(6, 1.71) plus noise — 864 particles, r_cut 2.5,
skin 0.55, cap 40: 27 cells, Npad 1080, the bench's sentinel layout."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.ops import packed as tp

SPEC_KW = dict(r_cut=2.5, skin=0.55, cap=40, shift_energy=False,
               uniform_sigma=1.0, uniform_eps=1.0)


# compiled once for every test of the file
_jforce = jax.jit(jp.packed_lj_force, static_argnums=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pos = (fcc_lattice(6, 1.71)
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    amps = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return pos, vel, amps, 6 * 1.71


def _jax_case(seed=0):
    pos, vel, amps, L = _inputs(seed)
    n = pos.shape[0]
    spec = jp.PackedSpec.create(L, n, **SPEC_KW)
    st, ovf = jp.pack_host(pos, JBox.cubic(L), spec, np.zeros(n, np.int32),
                           np.ones(n, np.float32), np.ones(n, np.float32),
                           vel=vel, extra_attrs={"lam_a": amps})
    assert not ovf
    return st, spec


def _assert_state_equal(port, ref, atol=0.0):
    a = interop.packed_state_arrays(port)
    for k in ("pid", "typ", "slot_of", "image"):
        np.testing.assert_array_equal(a[k], np.asarray(getattr(ref, k)), k)
    for k in ("r", "v", "f", "ref_r"):
        np.testing.assert_allclose(a[k], np.asarray(getattr(ref, k)),
                                   rtol=0, atol=atol, err_msg=k)
    assert sorted(a["attrs"]) == sorted(ref.attrs)
    for k, v in a["attrs"].items():
        np.testing.assert_allclose(v, np.asarray(ref.attrs[k]), rtol=0,
                                   atol=atol, err_msg=k)


def test_pack_host_identical():
    """The numpy pack is a copy of the reference's: identical arrays."""
    pos, vel, amps, L = _inputs()
    n = pos.shape[0]
    jst, jspec = _jax_case()
    spec = tp.PackedSpec.create(L, n, **SPEC_KW)
    assert interop.packed_spec_fields(spec) == {
        k: getattr(jspec, k) for k in interop.packed_spec_fields(spec)}
    assert spec.cells_per_dim == (3, 3, 3) and spec.n_pad == 1080
    st, ovf = tp.pack_host(pos, Box.cubic(L, "cpu"), spec,
                           np.zeros(n, np.int32), np.ones(n, np.float32),
                           np.ones(n, np.float32), "cpu", vel=vel,
                           extra_attrs={"lam_a": amps})
    assert not ovf
    _assert_state_equal(st, jst)
    assert (st.r[:, st.pid == n] == tp.VACANT_X).all()
    # interop carries the reference's state across unchanged
    _assert_state_equal(interop.packed_state_from(jst, "cpu"), jst)
    cid = tp._cell_id_packed(st.r, st.box, spec).numpy()
    np.testing.assert_array_equal(
        cid, np.asarray(jp._cell_id_packed(jst.r, jst.box, jspec)))


def _drifted(scale, seed=1):
    """The packed case with every real slot displaced by N(0, scale) and
    random forces, in both packages."""
    jst, jspec = _jax_case()
    rng = np.random.default_rng(seed)
    real = np.asarray(jst.pid) < jspec.n_real
    dr = (rng.normal(0.0, scale, jst.r.shape) * real).astype(np.float32)
    f = rng.normal(0.0, 1.0, jst.r.shape).astype(np.float32)
    jst = jst.replace(r=jnp.asarray(np.asarray(jst.r) + dr), f=jnp.asarray(f))
    return jst, jspec, interop.packed_state_from(jst, "cpu"), \
        interop.packed_spec_from(jspec)


def test_repack_incremental_matches_reference():
    jst, jspec, st, spec = _drifted(0.2)
    jout, jbad = jax.jit(jp.repack_incremental, static_argnums=1)(jst, jspec)
    out, bad = tp.repack_incremental(st, spec)
    assert bool(bad) == bool(jbad) is False
    # the drift moved particles across cells: the test exercises migration
    assert not np.array_equal(out.slot_of.numpy(), st.slot_of.numpy())
    _assert_state_equal(out, jout, atol=1e-6)
    assert (out.r[:, out.pid == spec.n_real] == tp.VACANT_X).all()


@pytest.mark.parametrize("scale", [0.02, 0.2])
def test_needs_repack_agrees(scale):
    jst, jspec, st, spec = _drifted(scale)
    want = bool(jp.needs_repack(jst, jspec))
    assert bool(tp.needs_repack(st, spec)) == want
    assert want == (scale > 0.1)


@pytest.mark.parametrize("with_energy", [True, False])
def test_plain_force_matches_xla_and_pallas(with_energy):
    """Plain packed_lj_force vs the reference's XLA roll sweep and its
    Pallas kernel (interpret mode), at the tolerances of
    tests/test_packed.py's pallas2 check.  Forces-only mode leaves the
    energy and virial at their old values, as the kernel does."""
    from jax.experimental import pallas as pl
    import metadyn_tpu.ops.packed_pallas2 as pp2

    jst, jspec = _jax_case()
    st = interop.packed_state_from(jst, "cpu")
    spec = interop.packed_spec_from(jspec)
    out = tp.packed_lj_force(st, spec, with_energy=with_energy)
    xla = _jforce(jst, jspec)
    orig = pl.pallas_call
    pp2.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        pal = pp2.packed_lj_force_pallas2(jst, jspec, with_energy=with_energy)
    finally:
        pp2.pl.pallas_call = orig
    for ref in (xla, pal):
        np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f),
                                   rtol=1e-3, atol=1e-3)
    if with_energy:
        for ref in (xla, pal):
            np.testing.assert_allclose(float(out.potential_energy),
                                       float(ref.potential_energy), rtol=1e-4)
            np.testing.assert_allclose(out.virial.numpy(),
                                       np.asarray(ref.virial), rtol=1e-3)
    else:
        assert float(out.potential_energy) == float(st.potential_energy)
        np.testing.assert_array_equal(out.virial.numpy(), st.virial.numpy())


def test_plain_force_j_block_chunking_is_exact():
    """Chunking the partner rows changes no result beyond f32 sum order."""
    jst, jspec = _jax_case()
    st = interop.packed_state_from(jst, "cpu")
    spec = interop.packed_spec_from(jspec)
    a = tp.packed_lj_force(st, spec)
    b = tp.packed_lj_force(st, spec, j_block=16)
    np.testing.assert_allclose(b.f.numpy(), a.f.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(b.potential_energy),
                               float(a.potential_energy), rtol=1e-6)


@pytest.mark.parametrize("tilt", [None, (0.3, -0.2, 0.1)])
def test_box_transforms_and_tilted_pack_match_reference(tilt):
    """Box transforms, the tilted cell sizing and the tilted host pack:
    the paths the orthorhombic bench does not reach."""
    from metadyn_tpu.core import box as jb
    from metadyn_tpu_torch.core import box as tb

    pos, vel, amps, L = _inputs()
    n = pos.shape[0]
    dims = (L, 1.1 * L, 0.95 * L)
    if tilt is None:
        jbox, box = JBox.from_lengths(*dims), Box.from_lengths(*dims, "cpu")
    else:
        jbox = JBox.triclinic(*dims, *tilt)
        box = Box.triclinic(*dims, "cpu", *tilt)
    assert box.L_host == tuple(float(x) for x in np.asarray(jbox.L))
    p = (1.7 * pos).astype(np.float32)          # reaches past the box faces
    for name in ("h_matrix", "h_inverse", "reciprocal_matrix"):
        np.testing.assert_allclose(getattr(tb, name)(box).numpy(),
                                   np.asarray(getattr(jb, name)(jbox)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    f = tb.fractional(torch.as_tensor(p), box)
    np.testing.assert_allclose(f.numpy(), np.asarray(jb.fractional(p, jbox)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.from_fractional(f, box).numpy(), p,
                               rtol=1e-5, atol=1e-5)
    w, im = tb.wrap(torch.as_tensor(p), box)
    jw, jim = jb.wrap(p, jbox)
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-5)

    jspec = jp.PackedSpec.create(dims, n, tilt=tilt, **SPEC_KW)
    spec = tp.PackedSpec.create(dims, n, tilt=tilt, **SPEC_KW)
    assert interop.packed_spec_fields(spec) == {
        k: getattr(jspec, k) for k in interop.packed_spec_fields(spec)}
    args = (np.zeros(n, np.int32), np.ones(n, np.float32),
            np.ones(n, np.float32))
    jst, jovf = jp.pack_host(pos, jbox, jspec, *args, vel=vel)
    st, ovf = tp.pack_host(pos, box, spec, *args, "cpu", vel=vel)
    assert ovf == jovf is False
    _assert_state_equal(st, jst)
    np.testing.assert_array_equal(
        tp._cell_id_packed(st.r, st.box, spec).numpy(),
        np.asarray(jp._cell_id_packed(jst.r, jst.box, jspec)))


def test_unpack_positions_and_temperature():
    jst, jspec = _jax_case()
    st = interop.packed_state_from(jst, "cpu")
    spec = interop.packed_spec_from(jspec)
    np.testing.assert_array_equal(tp.unpack_positions(st, spec).numpy(),
                                  np.asarray(jp.unpack_positions(jst, jspec)))
    np.testing.assert_allclose(float(tp.packed_temperature(st, spec)),
                               float(jp.packed_temperature(jst, jspec)),
                               rtol=1e-6)
