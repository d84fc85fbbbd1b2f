"""The port's packed mesh S(k) CV against the JAX package's ``PackedMesh``
on the same packed diblock melt: the value with CIC and TSC assignment, its
gradient in the positions (torch autograd against ``jax.grad``), and the
k-space bias virial.

Inputs: the lattice melt of tests/test_torch_bond_kernels.py (64 chains of
8 beads, L = 8.44) in Config 2's per-slot layout, mode +1 for A and −1 for
B, a 16³ mesh, k0 = 2π·2/L, width 0.4.  Tolerances: value rtol 1e-5
(f32 scatter and FFT in another order), gradient max|Δ| ≤ 1e-4·max|g|,
virial rtol 1e-4.  A bead moved exactly onto a mesh plane (CIC weight 0
toward one node, derivative not 0) gets its gradient at the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.mesh import axis_stencil as jaxis_stencil
from metadyn_tpu.cv.packed import PackedMesh as JPackedMesh
from metadyn_tpu.ops import packed as jp

from metadyn_tpu_torch import interop, make_system
from metadyn_tpu_torch.cv.mesh import axis_stencil

from tests.test_torch_bond_kernels import lattice_melt

MESH = (16, 16, 16)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(order):
    pos, vel, bonds, types, L = lattice_melt()
    n = pos.shape[0]
    es, _, ed, _ = jp.pair_scale_tables([[1.0, 0.6], [0.6, 1.0]])
    spec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.3, cap=32,
                                shift_energy=False, fene_k=30.0, fene_r0=1.5,
                                eps_scale=es)
    cv = JPackedMesh.create(MESH, L, n_real=n, k0=2 * np.pi * 2 / L,
                            width=0.4, name="sk", assign_order=order)
    coef = np.asarray([1.0, -1.0], np.float32)[types]
    st, ovf = jp.pack_host(pos, JBox.cubic(L), spec, types, ed[types],
                           np.ones(n, np.float32), vel=vel,
                           extra_attrs={**jp.bond_partner_attrs(bonds, n),
                                        cv.attr_name: coef})
    assert not ovf
    return st, cv, jmake_system(n, types=types), n


@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_mesh_value_grad_and_virial_match_reference(order):
    jst, jcv, jsys, n = _case(order)
    st = interop.packed_state_from(jst, "cpu")
    cv = interop.mesh_from(jcv, "cpu")
    assert interop.mesh_arrays(cv) == {
        "u_k": None, "k0": jcv.k0, "width": jcv.width,
        "mesh_shape": jcv.mesh_shape, "n_real": jcv.n_real,
        "name": jcv.name, "assign_order": jcv.assign_order}
    system = make_system(n, "cpu")

    jval, jgrad = jax.value_and_grad(
        lambda r: jcv.value(jst.replace(r=r), jsys))(jst.r)
    r = st.r.clone().requires_grad_(True)
    val = cv.value(st.replace(r=r), system)
    (grad,) = torch.autograd.grad(val, r)
    assert float(jval) > 1.0          # a real signal at k0
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())
    # vacant slots carry no weight: no gradient there
    vac = st.pid >= n
    assert bool((grad[:, vac] == 0).all())

    dV = 0.7
    jw = np.asarray(jcv.bias_virial(jst, jsys, jnp.float32(dV)))
    w = cv.bias_virial(st, system, torch.tensor(dV))
    np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4,
                               atol=1e-4 * np.abs(jw).max())


def _on_plane(x, L, n):
    """The f32 coordinate nearest ``x`` at which the port's CIC weight
    toward the +1 node is exactly 0: the bead sits on a mesh plane."""
    Lt = torch.tensor(L, dtype=torch.float32)
    m = (x / L + 0.5) * n
    c = np.float32(L * ((np.floor(m - 0.5) + 0.5) / n - 0.5))
    for _ in range(64):
        t = (torch.tensor(c) / Lt + 0.5) * n - 0.5
        t = float(t - torch.floor(t))
        if t == 0.0:
            return c
        c = np.nextafter(c, np.float32(np.inf if t > 0.5 else -np.inf))
    raise AssertionError("no f32 coordinate on the plane")


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_mesh_grad_of_a_bead_on_a_mesh_plane_matches_reference(axis):
    """A real bead exactly on a mesh plane has a CIC entry of value 0 whose
    derivative is not 0; the scatter must keep that entry on its own node,
    or the bead's bias force reads the wrong node's gradient."""
    jst, jcv, jsys, n = _case(2)
    st = interop.packed_state_from(jst, "cpu")
    cv = interop.mesh_from(jcv, "cpu")
    j = int(np.flatnonzero(st.pid.numpy() < n)[5])
    c = _on_plane(float(st.r[axis, j]), float(st.box.L[axis]), MESH[axis])
    r0 = st.r.clone()
    r0[axis, j] = torch.tensor(c)
    _, taps = axis_stencil(
        (r0[axis, j:j + 1] / st.box.L[axis] + 0.5) * MESH[axis], 2)
    assert float(taps[1][1][0]) == 0.0

    jg = np.asarray(jax.jit(jax.grad(
        lambda r: jcv.value(jst.replace(r=r), jsys)))(
        jst.r.at[axis, j].set(jnp.float32(c))))
    r = r0.requires_grad_(True)
    (grad,) = torch.autograd.grad(
        cv.value(st.replace(r=r), make_system(n, "cpu")), r)
    assert abs(jg[axis, j]) > 1e-2 * np.abs(jg).max()
    np.testing.assert_allclose(grad.numpy(), jg, rtol=0,
                               atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("order", [2, 3])
def test_axis_stencil_matches_reference(order):
    f = np.random.default_rng(1).uniform(-3.0, 40.0, 257).astype(np.float32)
    base, taps = axis_stencil(torch.as_tensor(f), order)
    jbase, jtaps = jaxis_stencil(jnp.asarray(f), order)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    assert [o for o, _ in taps] == [o for o, _ in jtaps]
    for (_, w), (_, jw) in zip(taps, jtaps):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(sum(w for _, w in taps).numpy(), 1.0,
                               atol=1e-6)
