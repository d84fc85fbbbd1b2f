"""The port's pencil-FFT mesh CV (``metadyn_tpu_torch/parallel/mesh2d.py``)
against the JAX package's ``ShardedPackedMesh2D`` and the port's single-grid
``PackedMesh``, on the CPU, on a 2×2 mesh (virtual CPU shards here, the
conftest's virtual CPU devices for the reference).

Inputs: a noisy 6³ simple-cubic lattice (216 particles, L 12, from a seed)
with two coefficient values, r_cut 2.5, skin 0.5 (4³ cells, cap 24), an 8³
mesh, k0 2.0, so each shard assigns into a (4 + 2·2)² × 8 pencil with its
halos.  CIC and TSC are the two cases of one test.

Tolerances: the value and the bias virial rtol 1e-5 against the JAX
package (f32 FFTs in another order), the bias force by autograd atol 1e-5 of
its largest component against the JAX package's force back-interpolation;
against ``PackedMesh`` the value rtol 1e-6 and the force atol 1e-6 of the
largest (the same assignment, another FFT split); two calls bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.parallel.mesh2d import ShardedPackedMesh2D as JMesh2D

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.core.packed_engine import PackedEngine
from metadyn_tpu_torch.cv.packed import PackedMesh
from metadyn_tpu_torch.ops.packed import PackedSpec
from metadyn_tpu_torch.parallel.mesh2d import ShardedPackedMesh2D

L_BOX = 12.0
MESH = (8, 8, 8)
K0 = 2.0


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    # module scope, so that it is set before the module-scoped fixture
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    sp = L_BOX / 6
    sites = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L_BOX / 2 + 0.5
    rng = np.random.default_rng(7)
    pos = (sites + rng.uniform(-0.4, 0.4, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    spec = PackedSpec.create(L_BOX, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    coef = np.where(np.arange(n) % 3 == 0, 1.5, 1.0).astype(np.float32)
    st, ovf = PackedEngine(spec, "cpu").pack_state(
        pos, Box.cubic(L_BOX, "cpu"), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32),
        extra_attrs={"mesh_sk": coef})
    assert not ovf
    a = interop.packed_state_arrays(st)
    jst = jp.PackedState(
        **{k: jnp.asarray(a[k]) for k in ("r", "v", "f", "image", "ref_r",
                                          "pid", "typ", "slot_of",
                                          "potential_energy", "virial")},
        attrs={k: jnp.asarray(v) for k, v in a["attrs"].items()},
        box=JBox(L=jnp.asarray(a["box"]["L"])))
    jspec = jp.PackedSpec(**interop.packed_spec_fields(spec))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("spacex", "spacey"))
    return st, spec, jst, jspec, mesh


def _force(cv, st):
    r = st.r.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(cv.value(st.replace(r=r), None), r)
    return -g


@pytest.mark.parametrize("order", [2, 3], ids=["cic", "tsc"])
def test_mesh2d_matches_reference_and_single_grid(case, order):
    st, spec, jst, jspec, mesh = case
    cv = ShardedPackedMesh2D.create(MESH, spec, ["cpu"] * 4, (2, 2),
                                    n_real=spec.n_real, k0=K0, box_L=L_BOX,
                                    name="sk", assign_order=order)
    jcv = JMesh2D.create(MESH, jspec, mesh, n_real=spec.n_real, k0=K0,
                         box_L=L_BOX, name="sk", assign_order=order)
    assert cv.halo == tuple(jcv.halo)
    back = interop.sharded_mesh2d_from(jcv, spec, ["cpu"] * 4, (2, 2))
    assert (back.halo, back.mesh_shape, back.assign_order) == (
        cv.halo, cv.mesh_shape, cv.assign_order)
    dVds = 0.6

    # against the JAX package: value, bias force, bias virial
    v = cv.value(st, None)
    np.testing.assert_allclose(float(v), float(jcv.value(jst, None)),
                               rtol=1e-5)
    f = _force(cv, st) * dVds
    jf = np.asarray(jcv.accum_bias_force(jst, None, jnp.float32(dVds),
                                         jnp.zeros_like(jst.r)))
    np.testing.assert_allclose(f.numpy(), jf, rtol=0,
                               atol=1e-5 * np.abs(jf).max())
    np.testing.assert_allclose(
        cv.bias_virial(st, None, torch.tensor(dVds)).numpy(),
        np.asarray(jcv.bias_virial(jst, None, jnp.float32(dVds))),
        rtol=1e-5)

    # against the port's single grid, and two calls bit for bit
    pm = PackedMesh.create(MESH, None, n_real=spec.n_real, k0=K0, name="sk",
                           assign_order=order)
    np.testing.assert_allclose(float(v), float(pm.value(st, None)),
                               rtol=1e-6)
    fp = _force(pm, st) * dVds
    np.testing.assert_allclose(f.numpy(), fp.numpy(), rtol=0,
                               atol=1e-6 * float(fp.abs().max()))
    np.testing.assert_allclose(
        cv.bias_virial(st, None, torch.tensor(dVds)).numpy(),
        pm.bias_virial(st, None, torch.tensor(dVds)).numpy(), rtol=1e-5)
    assert torch.equal(cv.value(st, None), v)
    assert torch.equal(_force(cv, st) * dVds, f)


def test_assign_is_order_free():
    """``cv/mesh.assign`` (the single-grid mesh CVs' scatter) sums in
    64-bit fixed point: the same entries in another order give the same
    bits, and the density matches a float64 sum to 1e-6 relative."""
    from metadyn_tpu_torch.cv.mesh import assign, axis_stencil
    rng = np.random.default_rng(11)
    n = 3000
    frac = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    w[::7] = 0.0                      # vacant slots, as in the packed layout
    perm = rng.permutation(n)
    for order in (2, 3):
        a = assign(tuple(torch.as_tensor(f) for f in frac),
                   torch.as_tensor(w), MESH, order)
        b = assign(tuple(torch.as_tensor(f[perm]) for f in frac),
                   torch.as_tensor(w[perm]), MESH, order)
        assert torch.equal(a, b)
        # the same stencil summed in float64 by a float index_add
        ax = [axis_stencil((torch.as_tensor(frac[d], dtype=torch.float64)
                            + 0.5) * MESH[d], order) for d in range(3)]
        ref = torch.zeros(int(np.prod(MESH)), dtype=torch.float64)
        w64 = torch.as_tensor(w, dtype=torch.float64)
        for ox, wx in ax[0][1]:
            for oy, wy in ax[1][1]:
                for oz, wz in ax[2][1]:
                    i = [torch.remainder(ax[d][0] + o, MESH[d])
                         for d, o in enumerate((ox, oy, oz))]
                    ref.index_add_(0, (i[0] * MESH[1] + i[1]) * MESH[2]
                                   + i[2], w64 * wx * wy * wz)
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(ref.abs().max()))
