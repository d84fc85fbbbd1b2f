"""The port's particle-order CVs against the JAX package's, on the CPU:
``LamellarOP``, ``AxisPosition``, ``SteinhardtQl`` and
``MeshOrderParameter`` (CIC and TSC), orthorhombic and in the tilted box
(0.2, −0.12, 0.1).  Values rtol 1e-5; gradients (``torch.autograd.grad``
against ``jax.grad``) atol 1e-4·max|g|; the bias force of
``cv_values_and_bias_force`` and the mesh CV's bias virial against the
reference's.  Inputs: fcc plus noise at 256 and 500 particles, two types,
from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.base import cv_values_and_bias_force as jcv_force
from metadyn_tpu.cv.lamellar import LamellarOP as JLamellar
from metadyn_tpu.cv.mesh import MeshOrderParameter as JMesh
from metadyn_tpu.cv.simple import AxisPosition as JAxis
from metadyn_tpu.cv.steinhardt import SteinhardtQl as JQl
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.state import make_state, make_system
from metadyn_tpu_torch.cv.base import cv_values_and_bias_force
from metadyn_tpu_torch.cv.simple import AxisPosition

TILT = (0.2, -0.12, 0.1)

from tests.test_torch_cli import torch_threads


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def states(n_cells: int, tilted: bool, seed: int = 0):
    """(jax state, jax system, port state, port system): fcc plus noise,
    positions shifted so that the wrap gives nonzero images."""
    rng = np.random.default_rng(seed)
    a = 1.6
    L = n_cells * a
    pos = (fcc_lattice(n_cells, a) + rng.normal(0.0, 0.08,
                                                (4 * n_cells ** 3, 3))
           + 0.3 * L).astype(np.float32)
    n = pos.shape[0]
    types = rng.integers(0, 2, n).astype(np.int32)
    jbox = (JBox.triclinic(L, L, L, *TILT) if tilted else JBox.cubic(L))
    jst = jmake_state(pos, jbox)
    tst = make_state(pos, interop.box_from(jbox, "cpu"), device="cpu")
    return (jst, jmake_system(n, types=types, n_types=2),
            tst, make_system(n, "cpu", types=types, n_types=2))


def check_value_and_grad(jcv, tcv, n_cells=4, tilted=False):
    jst, jsys, tst, tsys = states(n_cells, tilted)
    np.testing.assert_array_equal(tst.image.numpy(), np.asarray(jst.image))
    v_ref, g_ref = jax.value_and_grad(
        lambda p: jcv.value(jst.replace(pos=p), jsys))(jst.pos)
    pos = tst.pos.detach().requires_grad_(True)
    v = tcv.value(tst.replace(pos=pos), tsys)
    (g,) = torch.autograd.grad(v, pos)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    g_ref = np.asarray(g_ref)
    assert np.abs(g.numpy() - g_ref).max() <= 1e-4 * np.abs(g_ref).max()
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("tilted", [False, True])
def test_lamellar_matches_reference(tilted):
    jcv = JLamellar.create(mode=[1.0, -0.5],
                           lattice_vectors=[[0, 0, 1], [1, 2, 0]],
                           phases=[0.3, -0.2], name="lam")
    check_value_and_grad(jcv, interop.lamellar_op_from(jcv, "cpu"),
                         tilted=tilted)


@pytest.mark.parametrize("tilted", [False, True])
def test_steinhardt_matches_reference(tilted):
    jcv = JQl(r_cut=1.5, l=6, row_block=100, name="q6")
    check_value_and_grad(jcv, interop.steinhardt_ql_from(jcv),
                         tilted=tilted)


@pytest.mark.parametrize("order,tilted", [(2, False), (3, False), (2, True),
                                          (3, True)])
def test_mesh_matches_reference(order, tilted):
    jcv = JMesh.create((12, 12, 12), 6.4, mode=[1.0, -1.0], k0=2.0,
                       width=0.5, name="sk", assign_order=order)
    check_value_and_grad(jcv, interop.mesh_op_from(jcv, "cpu"),
                         tilted=tilted)


def test_mesh_bias_virial_and_explicit_window_match_reference():
    jst, jsys, tst, tsys = states(4, False)
    jcv = JMesh.create((10, 10, 10), 6.4, mode=[1.0, -1.0], k0=2.0,
                       width=0.5, name="sk")
    tcv = interop.mesh_op_from(jcv, "cpu")
    np.testing.assert_allclose(
        tcv.bias_virial(tst, tsys, torch.tensor(0.7)).numpy(),
        np.asarray(jcv.bias_virial(jst, jsys, jnp.float32(0.7))),
        rtol=1e-5, atol=1e-6)
    u_k = np.random.default_rng(9).uniform(0, 1, (8, 8, 8)).astype(
        np.float32)
    jcv = JMesh.create((8, 8, 8), 6.4, mode=[1.0, 0.5], u_k=u_k, name="u")
    check_value_and_grad(jcv, interop.mesh_op_from(jcv, "cpu"))


@pytest.mark.parametrize("tilted", [False, True])
def test_axis_position_and_bias_force_match_reference(tilted):
    """AxisPosition reads the unwrapped coordinate; the stacked bias force
    of three CVs, −Σ_d dV/ds_d ∂s_d/∂r, against the reference's vjp."""
    jst, jsys, tst, tsys = states(4, tilted, seed=1)
    jcvs = [JAxis(5, 2, name="z5"),
            JLamellar.create(mode=[1.0, 1.0], lattice_vectors=[[0, 1, 1]],
                             name="lam"),
            JQl(r_cut=1.5, l=4, row_block=128, name="q4")]
    tcvs = [AxisPosition(5, 2, name="z5"),
            interop.lamellar_op_from(jcvs[1], "cpu"),
            interop.steinhardt_ql_from(jcvs[2])]
    dV = np.asarray([0.4, -1.3, 2.0], np.float32)
    s_ref, f_ref = jcv_force(jcvs, jst, jsys, jnp.asarray(dV))
    s, f = cv_values_and_bias_force(tcvs, tst, tsys, torch.as_tensor(dV))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5)
    f_ref = np.asarray(f_ref)
    assert np.abs(f.numpy() - f_ref).max() <= 1e-4 * np.abs(f_ref).max()
    assert tcvs[0].log_name == jcvs[0].log_name == "cv_z5"
