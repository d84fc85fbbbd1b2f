"""The box CVs against the JAX package: the particle-order ``MSD``, the
packed ``PackedMSD`` with its reference positions packed as attrs
(``msd_reference_attrs``), the ``AspectRatio`` and the box-bias function
``box_bias_fn_for`` that couples its metadynamics bias to the barostat.

Inputs: fcc 6³ at a 1.6 (864 particles) plus noise from a numpy seed as
the reference positions, the current positions displaced from them by
more noise and wrapped (their image counters non-zero), in a box of
lengths (9.6, 9.9, 9.3).  Values rtol 1e-5; gradients (the bias force
∂s/∂r, by autograd in the particle-order port and analytic in the packed
one, against ``jax.grad``) and virials rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.bias import grid as jgrid
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv import aspect_ratio as jar
from metadyn_tpu.cv.msd import MSD as JMSD
from metadyn_tpu.cv.packed import PackedMSD as JPackedMSD
from metadyn_tpu.cv.packed import msd_reference_attrs as jmsd_attrs
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.bias.grid import BiasGrid, GridSpec
from metadyn_tpu_torch.bias.metad import BiasState
from metadyn_tpu_torch.core.state import make_system
from metadyn_tpu_torch.cv.aspect_ratio import box_bias_fn_for
from metadyn_tpu_torch.cv.packed import msd_reference_attrs

from tests.test_torch_cli import torch_threads

LS = (9.6, 9.9, 9.3)


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def positions():
    """(reference positions, current positions wrapped, their images)."""
    rng = np.random.default_rng(11)
    ref = (fcc_lattice(6, 1.6) * np.asarray(LS) / 9.6
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    cur = ref + rng.normal(0.0, 0.4, ref.shape).astype(np.float32)
    cur[:10] += np.asarray(LS, np.float32)     # a few one box away
    L = np.asarray(LS, np.float32)
    image = np.floor(cur / L + 0.5).astype(np.int32)
    return ref, (cur - image * L).astype(np.float32), image


def test_msd_matches_reference():
    ref, pos, image = positions()
    n = pos.shape[0]
    jcv = JMSD.create(ref)
    jst = jmake_state(pos, JBox.from_lengths(*LS)).replace(
        image=jnp.asarray(image))
    jsys = jmake_system(n)
    cv = interop.msd_from(jcv, "cpu")
    st = interop.state_from(jst, "cpu")
    sys_ = make_system(n, "cpu")
    v_ref, g_ref = jax.value_and_grad(
        lambda p: jcv.value(jst.replace(pos=p), jsys))(jst.pos)
    p = st.pos.clone().requires_grad_(True)
    v = cv.value(st.replace(pos=p), sys_)
    (g,) = torch.autograd.grad(v, p)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(
        cv.bias_virial(st, sys_, torch.tensor(0.7)).numpy(),
        np.asarray(jcv.bias_virial(jst, jsys, jnp.float32(0.7))),
        rtol=1e-4)
    assert interop.msd_arrays(cv)["name"] == "msd"


def test_packed_msd_matches_reference():
    ref, pos, _ = positions()
    n = pos.shape[0]
    for k, a in msd_reference_attrs(ref).items():
        np.testing.assert_array_equal(a, jmsd_attrs(ref)[k])
    jspec = jp.PackedSpec.create(LS[0], n, r_cut=2.0, skin=0.3, cap=24)
    jbox = JBox.from_lengths(*LS)
    jst, ovf = jp.pack_host(pos, jbox, jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            image=positions()[2], extra_attrs=jmsd_attrs(ref))
    assert not bool(ovf)
    jcv = JPackedMSD(n_real=n)
    jsys = jmake_system(n)
    st = interop.packed_state_from(jst, "cpu")
    cv = interop.packed_msd_from(jcv)
    v = cv.value(st, None)
    np.testing.assert_allclose(float(v), float(jcv.value(jst, jsys)),
                               rtol=1e-5)
    dVds = 0.7
    f = cv.accum_bias_force(st, None, torch.tensor(dVds),
                            torch.zeros_like(st.r))
    f_ref = jcv.accum_bias_force(jst, jsys, jnp.float32(dVds),
                                 jnp.zeros_like(jst.r))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=1e-4,
                               atol=1e-9)
    # the analytic force is −dVds · ∂s/∂r
    r = st.r.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(cv.value(st.replace(r=r), None), r)
    np.testing.assert_allclose(f.numpy(), -dVds * g.numpy(), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(
        cv.bias_virial(st, None, torch.tensor(dVds)).numpy(),
        np.asarray(jcv.bias_virial(jst, jsys, jnp.float32(dVds))),
        rtol=1e-4)


@pytest.mark.parametrize("axes", [(0, 1), (2, 0)])
def test_aspect_ratio_and_box_bias_match_reference(axes):
    jcv = jar.AspectRatio(axis_a=axes[0], axis_b=axes[1])
    cv = interop.aspect_ratio_from(jcv)
    ref, pos, _ = positions()
    jst = jmake_state(pos, JBox.from_lengths(*LS))
    st = interop.state_from(jst, "cpu")
    np.testing.assert_allclose(float(cv.value(st, None)),
                               float(jcv.value(jst, None)), rtol=1e-5)
    np.testing.assert_allclose(cv.dvalue_dL(st).numpy(),
                               np.asarray(jcv.dvalue_dL(jst)), rtol=1e-5)
    # the box-bias: the grid's ∂V/∂s at the current aspect ratio times
    # ∂s/∂L, against the reference on the same grid of hills
    jspec = jgrid.GridSpec.create([0.7], [1.3], [61], [0.03])
    g = jgrid.BiasGrid.zeros(jspec)
    for c, h in ((0.95, 0.4), (1.0, 0.6), (1.05, 0.3)):
        g = jgrid.deposit_hill(g, jnp.asarray([c]), jnp.float32(h))
    grid = BiasGrid(spec=GridSpec.create([0.7], [1.3], [61], [0.03], "cpu"),
                    V=torch.as_tensor(np.array(g.V)),
                    dV=torch.as_tensor(np.array(g.dV)))

    class _JBias:
        pass
    _JBias.grid = g
    got = box_bias_fn_for(cv, BiasState(grid=grid, n_hills=torch.tensor(3))
                          )(st)
    want = jar.box_bias_fn_for(jcv, _JBias)(jst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-7)
    assert float(got.abs().max()) > 0.0
    # no force on the particles: the bias acts on the box alone
    f0 = torch.zeros_like(st.pos)
    assert cv.accum_bias_force(st, None, torch.tensor(1.0), f0) is f0
