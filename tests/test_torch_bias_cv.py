"""The port's grid bias, well-tempered hills, walls, FES and lamellar CV
against the JAX package, at rtol 1e-5 / atol 1e-6 (f32 elementwise math;
the only differences are libm ulps and sum order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metadyn_tpu.bias import grid as jg
from metadyn_tpu.bias import metad as jm
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.packed import PackedLamellar as JLamellar
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.bias import grid as tg
from metadyn_tpu_torch.bias import metad as tm
from metadyn_tpu_torch.core.state import make_system

TOL = dict(rtol=1e-5, atol=1e-6)
# the bench's grid: 64x64 over ±0.06, σ 0.004
GRID = ([-0.06, -0.06], [0.06, 0.06], [64, 64], [0.004, 0.004])


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _specs(periodic=None):
    j = jg.GridSpec.create(*GRID, periodic=periodic)
    t = tg.GridSpec.create(*GRID, "cpu", periodic=periodic)
    for k in ("lo", "hi", "sigma"):
        np.testing.assert_array_equal(interop.grid_spec_arrays(t)[k],
                                      np.asarray(getattr(j, k)))
    return j, t


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **{**TOL, **kw})


@pytest.mark.parametrize("periodic", [None, (True, False)])
def test_hill_field(periodic):
    j, t = _specs(periodic)
    s = np.asarray([0.057, -0.021], np.float32)
    jV, jdV = jg.hill_field(j, jnp.asarray(s), jnp.float32(0.1))
    tV, tdV = tg.hill_field(t, torch.as_tensor(s), torch.tensor(0.1))
    _close(tV, jV)
    _close(tdV, jdV, atol=1e-4)   # dV ~ h/σ ~ 10² in magnitude
    for d in range(2):
        _close(t.axis_coords(d), j.axis_coords(d))


def _deposited(mode):
    """Three hills in each package; returns both bias states."""
    j, t = _specs()
    jh = jm.HillSpec.create(W=0.1, stride=500, mode=mode, deltaT=5.0)
    th = tm.HillSpec.create(W=0.1, stride=500, mode=mode, deltaT=5.0)
    jb, tb = jm.BiasState.zeros(j), tm.BiasState.zeros(t)
    centres = np.asarray([[0.0, 0.0], [0.004, -0.002], [0.001, 0.003]],
                         np.float32)
    for i, c in enumerate(centres):
        jb, jrec = jm.deposit(jh, jb, jnp.asarray(c), jnp.int32(500 * i))
        tb, trec = tm.deposit(th, tb, torch.as_tensor(c), 500 * i)
        _close(trec.height, jrec.height)
    return jh, jb, th, tb


@pytest.mark.parametrize("mode", [jm.WELL_TEMPERED, jm.STANDARD])
def test_deposit_and_free_energy(mode):
    jh, jb, th, tb = _deposited(mode)
    assert tb.n_hills == int(jb.n_hills) == 3
    _close(tb.grid.V, jb.grid.V)
    _close(tb.grid.dV, jb.grid.dV, atol=1e-4)
    _close(tm.free_energy(th, tb, 1.0), jm.free_energy(jh, jb, jnp.float32(1.0)))
    # interop carries the bias state across unchanged
    back = interop.bias_state_from(jb, "cpu")
    np.testing.assert_array_equal(back.grid.V.numpy(), np.asarray(jb.grid.V))
    assert back.n_hills == 3
    if mode == jm.WELL_TEMPERED:
        s = np.asarray([0.002, 0.0], np.float32)
        _close(tm.hill_height(th, tb, torch.as_tensor(s)),
               jm.hill_height(jh, jb, jnp.asarray(s)))


def test_interp_and_value_and_grad():
    jh, jb, th, tb = _deposited(jm.WELL_TEMPERED)
    # inside, on grid points, at the edges and out of range (clamped)
    pts = np.asarray([[0.0013, -0.0027], [0.0, 0.0], [-0.06, 0.06],
                      [0.0599, -0.0599], [0.2, -0.3], [-0.07, 0.01]],
                     np.float32)
    for p in pts:
        jV, jdV = jg.value_and_grad(jb.grid, jnp.asarray(p))
        tV, tdV = tg.value_and_grad(tb.grid, torch.as_tensor(p))
        _close(tV, jV)
        _close(tdV, jdV, atol=1e-5)
        _close(tg.interp(tb.grid.V, tb.grid.spec, torch.as_tensor(p)),
               jg.interp(jb.grid.V, jb.grid.spec, jnp.asarray(p)))


def test_walls():
    j, t = _specs()
    jw = jm.WallSpec.at_grid_edges(j, k=2000.0)
    tw = tm.WallSpec.at_grid_edges(t, k=2000.0)
    for s in ([0.0, 0.0], [0.058, -0.059], [-0.1, 0.2]):
        s = np.asarray(s, np.float32)
        je, jgr = jw.energy_and_grad(jnp.asarray(s))
        te, tgr = tw.energy_and_grad(torch.as_tensor(s))
        _close(te, je)
        _close(tgr, jgr)


def _lamellar_case():
    rng = np.random.default_rng(5)
    pos = (fcc_lattice(6, 1.71)
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    n, L = pos.shape[0], 6 * 1.71
    amps = rng.uniform(0.5, 1.5, n).astype(np.float32)
    spec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                                shift_energy=False, uniform_sigma=1.0,
                                uniform_eps=1.0)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), spec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            extra_attrs={"lam_a": amps})
    assert not ovf
    jcv = JLamellar.create([[0, 0, 3], [1, 2, 0]], n_real=n, name="a",
                           phases=[0.3, -0.7])
    return jst, jcv, n


def test_lamellar_value_and_bias_force():
    jst, jcv, n = _lamellar_case()
    st = interop.packed_state_from(jst, "cpu")
    cv = interop.lamellar_from(jcv, "cpu")
    assert interop.lamellar_arrays(cv)["name"] == "a"
    jsys, sys_ = jmake_system(n), make_system(n, "cpu")
    _close(cv.value(st, sys_), jcv.value(jst, jsys))
    dVds = np.float32(-1.7)
    jf = jcv.accum_bias_force(jst, jsys, jnp.asarray(dVds),
                              jnp.zeros_like(jst.r))
    f = cv.accum_bias_force(st, sys_, torch.tensor(dVds), torch.zeros_like(st.r))
    _close(f, jf)
    # vacant slots carry amp 0: no bias force there
    vac = st.pid.numpy() >= n
    assert np.all(f.numpy()[:, vac] == 0.0)
