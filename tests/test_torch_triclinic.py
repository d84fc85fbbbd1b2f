"""The port's tilted-box (triclinic) and validity-layout paths against the
JAX package, module by module, on the CPU.

Inputs: examples/triclinic_packed.yaml's start cut to ``fcc_lattice(6,
1.68)`` (864 particles, L = 10.08) in the YAML's tilted box (xy, xz, yz) =
(0.2, -0.12, 0.1), with Gaussian noise 0.05 from a numpy seed; r_cut 2.5,
skin 0.4, cap 40: 3³ cells by the perpendicular widths, Npad 1080.  The
per-slot layout (no uniform σ or ε), as the YAML runs it: the Q6 and
coordination sweeps see vacancy through ``pid < n_real`` only.

- The plain pair force, PE and virial against the reference's XLA sweep.
- Q6 and coordination (without a cut-off) values and bias forces in the
  validity layout, with vacant slots moved next to real particles.
- ``PackedEngine.metrics`` in tilted boxes, one of them narrower than the
  cell stencil needs (``cell_width_violation``).
- A tilted box through ``interop`` and back, with its host floats.

Tolerances: both sides are f32 roll sweeps summing in nearly the same
order.  Pair force max|Δf| ≤ 1e-5·max|f|, PE and virial rtol 1e-5; CV
values rtol 2e-5, bias forces atol 1e-5·max|g|.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedAux as JAux
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import Box, PackedAux, PackedEngine, interop
from metadyn_tpu_torch.core import box as tb
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.ops import packed as tp

TILT = (0.2, -0.12, 0.1)
TILT_F32 = np.asarray(TILT, np.float32)
A_LAT = 1.68
N_CELLS = 6
DV = np.array([0.9, -1.3], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs():
    pos = fcc_lattice(N_CELLS, A_LAT)
    rng = np.random.default_rng(7)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    return pos, N_CELLS * A_LAT


@pytest.fixture(scope="module")
def case():
    """(jst, jspec, st, spec): the tilted per-slot pack, both packages."""
    pos, L = _inputs()
    n = pos.shape[0]
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                                 shift_energy=False, tilt=TILT)
    assert jspec.cells_per_dim == (3, 3, 3) and jspec.uniform_eps is None
    vel = np.random.default_rng(8).normal(0.0, 0.8, pos.shape)
    jst, ovf = jp.pack_host(pos, JBox.triclinic(L, L, L, *TILT), jspec,
                            np.zeros(n, np.int32), np.ones(n, np.float32),
                            np.ones(n, np.float32),
                            vel=vel.astype(np.float32))
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


@pytest.mark.parametrize("with_energy", [True, False])
def test_pair_force_matches_reference(case, with_energy):
    jst, jspec, st, spec = case
    out = tp.packed_lj_force(st, spec, with_energy=with_energy)
    ref = jax.jit(jp.packed_lj_force, static_argnums=1)(jst, jspec)
    f_ref = np.asarray(ref.f)
    fmax = np.abs(f_ref).max()
    assert fmax > 10.0                        # the seam's close contacts
    assert np.abs(out.f.numpy() - f_ref).max() <= 1e-5 * fmax
    if with_energy:
        np.testing.assert_allclose(float(out.potential_energy),
                                   float(ref.potential_energy), rtol=1e-5)
        np.testing.assert_allclose(out.virial.numpy(),
                                   np.asarray(ref.virial), rtol=1e-5)


def _vacant_near_real(jst, jspec):
    """The state with the last rank's vacant slot of 8 cells moved to
    0.9 from a real particle of its cell (inside the Q6 cut-off 1.49):
    counted as neighbours unless the validity weight drops them."""
    r = np.array(jst.r)
    pid = np.asarray(jst.pid)
    cap, C = jspec.cap, jspec.n_cells
    moved = []
    for cell in range(0, C, 3)[:8]:
        slots = np.arange(cap) * C + cell
        real, vac = slots[pid[slots] < jspec.n_real], slots[
            pid[slots] >= jspec.n_real]
        r[:, vac[-1]] = r[:, real[0]] + np.float32([0.9, 0.0, 0.0])
        moved.append(vac[-1])
    return jst.replace(r=jnp.asarray(r)), np.asarray(moved)


def test_order_cvs_validity_layout_match_reference(case):
    jst, jspec, _, spec = case
    jst, moved = _vacant_near_real(jst, jspec)
    st = interop.packed_state_from(jst, "cpu")
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.49, l=6, name="q6"),
            jpo.PackedCoordination(spec=jspec, r0=1.6, name="co")]
    cvs = [interop.steinhardt_from(jcvs[0]),
           interop.coordination_from(jcvs[1])]
    jv, jf = jpo.make_fused_order_force(jcvs, jspec, use_pallas=False)
    tv, tf = tpo.make_fused_order_force(cvs, spec)
    js, jctx = jv(jst)
    s, ctx = tv(st)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-5)
    for t, jt in zip(ctx[0], jctx[0]):
        for a, b in zip(t, jt):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-5, atol=1e-6)
    jg = np.asarray(jf(jst, jctx, jnp.asarray(DV)))
    g = tf(st, ctx, torch.as_tensor(DV)).numpy()
    gmax = np.abs(jg).max()
    assert gmax > 1e-3
    np.testing.assert_allclose(g, jg, rtol=0.0, atol=1e-5 * gmax)
    assert np.all(g[:, moved] == 0.0)

    # the weight matters: counted as real, the moved slots change both CVs
    fake = st.replace(pid=st.pid.clone().index_fill_(
        0, torch.as_tensor(moved), 0))
    s_fake, _ = tv(fake)
    assert np.all(np.abs(s_fake.numpy() - s.numpy())
                  > 100 * 2e-5 * np.abs(s.numpy()))


@pytest.mark.parametrize("scale", [1.0, 0.85], ids=["fits", "too_narrow"])
def test_engine_metrics_match_reference(case, scale):
    """The metrics of a tilted box of ``scale`` times the spec's edge: at
    0.85 the perpendicular cell width falls below r_cut + skin."""
    jst, jspec, st, spec = case
    L = scale * N_CELLS * A_LAT
    jst = jst.replace(box=JBox.triclinic(L, L, L, *TILT))
    st = st.replace(box=Box.triclinic(L, L, L, "cpu", *TILT))
    jm = JEngine(jspec, rebuild_every=5).metrics(jst, JAux())
    m = PackedEngine(spec, "cpu", rebuild_every=5).metrics(
        st, PackedAux.create("cpu"))
    assert bool(m["cell_width_violation"]) == bool(
        jm["cell_width_violation"]) == (scale < 1.0)
    for k in ("nlist_overflow", "nlist_stale"):
        assert bool(m[k]) == bool(jm[k]) is False
    np.testing.assert_allclose(float(m["temperature"]),
                               float(jm["temperature"]), rtol=1e-6)
    np.testing.assert_allclose(
        tb.perpendicular_widths(st.box).numpy(),
        1.0 / np.linalg.norm(np.linalg.inv(
            np.asarray(tb.h_matrix(st.box), np.float64)), axis=1),
        rtol=1e-6)


def test_tilted_box_interop_round_trip():
    """Reference box → port → arrays → reference keeps L and the tilt; the
    port's box carries them as host floats too, and refuses a tilt without
    them."""
    L = N_CELLS * A_LAT
    jbox = JBox.triclinic(L, 1.1 * L, 0.9 * L, *TILT)
    box = interop.box_from(jbox, "cpu")
    assert box.tilt_host == tuple(float(x) for x in np.asarray(jbox.tilt))
    assert box.L_host == tuple(float(x) for x in np.asarray(jbox.L))
    a = interop.box_arrays(box)
    back = JBox(L=a["L"], tilt=a["tilt"])
    np.testing.assert_array_equal(np.asarray(back.L), np.asarray(jbox.L))
    np.testing.assert_array_equal(np.asarray(back.tilt), np.asarray(jbox.tilt))
    assert interop.box_from(back, "cpu").tilt_host == box.tilt_host
    # the kernels' cell matrix: the plain sweeps' f32 products
    h = np.asarray(tb.h_matrix(box))
    assert box.h_host() == (h[0, 0], h[1, 1], h[2, 2], h[0, 1], h[0, 2],
                            h[1, 2])
    assert Box.cubic(L, "cpu").h_host()[3:] == (0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="tilt_host"):
        dataclasses.replace(Box.cubic(L, "cpu"), tilt=torch.zeros(3))
    with pytest.raises(ValueError, match="tilt_host"):
        dataclasses.replace(box, tilt_host=None)
    # a tilted packed state survives the round trip with its host floats
    pos, _ = _inputs()
    n = pos.shape[0]
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40, tilt=TILT)
    jst, _ = jp.pack_host(pos, JBox.triclinic(L, L, L, *TILT), jspec,
                          np.zeros(n, np.int32), np.ones(n, np.float32),
                          np.ones(n, np.float32))
    st = interop.packed_state_from(jst, "cpu")
    assert st.box.tilt_host == tuple(float(x) for x in TILT_F32)
    arr = interop.packed_state_arrays(st)
    np.testing.assert_array_equal(arr["box"]["tilt"], TILT_F32)
    np.testing.assert_array_equal(arr["r"], np.asarray(jst.r))
