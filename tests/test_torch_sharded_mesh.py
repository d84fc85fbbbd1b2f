"""The distributed mesh S(k) CV (``parallel/mesh.ShardedPackedMesh``) on 2
x-slab shards of the CPU, CIC and TSC: against the port's single-grid
``PackedMesh`` on the same state, and against the JAX package's
``ShardedPackedMesh`` on a 2-device CPU mesh (the conftest's virtual
devices).  Value rtol 2e-4; the gradient ∂s/∂r (by autograd through the
halo fold, the slab FFT and the transpose; the reference's by its vjp)
rtol 2e-2, atol 1e-5; the k-space bias virial rtol 2e-4, atol 1e-6.

Input: the reference test's (tests/test_spatial.py:723): a 7³ lattice of
spacing 18/7 in L 18 with uniform noise 0.1 (343 particles, r_cut 2.5,
skin 0.5, cap 24: 6³ cells, 3 x planes per shard), an 8³ mesh, k0 the
second harmonic, coefficients ±1 by parity; the real slots then drift by
up to 0.2 along each axis (under half the skin), so some cross the seam
into the halos.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.parallel.mesh import ShardedPackedMesh as JSharded

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.cv.packed import PackedMesh
from metadyn_tpu_torch.parallel.mesh import ShardedPackedMesh

from tests.test_torch_cli import torch_threads

L = 18.0
MESH = (8, 8, 8)
K0 = 2.0 * np.pi * 2 / L


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def start():
    g = 7
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * (L / g) - L / 2 + 0.6
    rng = np.random.default_rng(0)
    pos = (sites + rng.uniform(-0.1, 0.1, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    coef = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=24,
                                 shift_energy=False)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            extra_attrs={"mesh_sk": coef})
    assert not bool(ovf)
    # drift the real slots (not the vacant ones) by up to 0.2 per axis
    drift = rng.uniform(-0.2, 0.2, (3, 1)).astype(np.float32) * np.asarray(
        jst.pid < n, np.float32)[None]
    jst = jst.replace(r=jst.r + jnp.asarray(drift))
    return jst, jspec, n


def _port(cv, st, dVds=0.7):
    r = st.r.clone().requires_grad_(True)
    v = cv.value(st.replace(r=r), None)
    (g,) = torch.autograd.grad(v, r)
    return (float(v.detach()), g,
            cv.bias_virial(st, None, torch.tensor(dVds)))


@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_sharded_mesh_matches_single_grid(order):
    jst, jspec, n = start()
    st = interop.packed_state_from(jst, "cpu")
    spec = interop.packed_spec_from(jspec)
    dd = ShardedPackedMesh.create(MESH, spec, ["cpu", "cpu"], n_real=n,
                                  k0=K0, width=0.5, box_L=L, name="sk",
                                  assign_order=order)
    assert dd.halo == 2
    one = PackedMesh.create(MESH, L, n_real=n, k0=K0, width=0.5, name="sk",
                            assign_order=order)
    v, g, w = _port(dd, st)
    v1, g1, w1 = _port(one, st)
    np.testing.assert_allclose(v, v1, rtol=2e-4)
    np.testing.assert_allclose(g.numpy(), g1.numpy(), rtol=2e-2, atol=1e-5)
    assert float(g.abs().max()) > 1e-3
    np.testing.assert_allclose(w.numpy(), w1.numpy(), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_sharded_mesh_matches_reference(order):
    jst, jspec, n = start()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("space",))
    jcv = JSharded.create(MESH, jspec, mesh, n_real=n, k0=K0, width=0.5,
                          box_L=L, name="sk", assign_order=order)
    spec = interop.packed_spec_from(jspec)
    cv = interop.sharded_mesh_from(jcv, spec, ["cpu", "cpu"])
    assert interop.sharded_mesh_arrays(cv)["halo"] == jcv.halo
    st = interop.packed_state_from(jst, "cpu")
    v, g, w = _port(cv, st)
    np.testing.assert_allclose(v, float(jcv.value(jst, None)), rtol=2e-4)
    g_ref = -np.asarray(jcv.accum_bias_force(jst, None, jnp.float32(1.0),
                                             jnp.zeros_like(jst.r)))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jcv.bias_virial(jst, None, jnp.float32(0.7))),
        rtol=2e-4, atol=1e-6)


def test_sharded_mesh_refuses_what_the_reference_refuses():
    jst, jspec, n = start()
    spec = interop.packed_spec_from(jspec)
    with pytest.raises(ValueError, match="divide"):
        ShardedPackedMesh.create((9, 8, 8), spec, ["cpu"] * 2, n_real=n,
                                 k0=K0)
    with pytest.raises(ValueError, match="halo"):
        ShardedPackedMesh.create((4, 8, 8), spec, ["cpu"] * 2, n_real=n,
                                 k0=K0, box_L=0.4)


def test_fixed_point_scatter_is_order_free():
    """The sharded CV's scatter adds in 64-bit fixed point: any order of
    the entries gives the same bits (a GPU's float atomics would not), and
    its gradient is the node's gradient at each entry."""
    from metadyn_tpu_torch.cv.mesh import (
        FixedPointScatter as _FixedPointScatter,
    )
    rng = np.random.default_rng(2)
    idx = torch.as_tensor(rng.integers(0, 50, 4000))
    val = torch.as_tensor(rng.normal(size=4000).astype(np.float32))
    a = _FixedPointScatter.apply(idx, val, 50)
    perm = torch.as_tensor(rng.permutation(4000))
    assert torch.equal(a, _FixedPointScatter.apply(idx[perm], val[perm], 50))
    ref = torch.zeros(50, dtype=torch.float64).index_add(0, idx, val.double())
    np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    v = val.clone().requires_grad_(True)
    w = torch.as_tensor(rng.normal(size=50).astype(np.float32))
    (g,) = torch.autograd.grad((_FixedPointScatter.apply(idx, v, 50)
                                * w).sum(), v)
    assert torch.equal(g, w[idx])
