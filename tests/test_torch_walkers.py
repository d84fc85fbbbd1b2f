"""Multiple walkers (``parallel/walkers.py``) against the JAX package's
``WalkerSampler``, both on the CPU: the reference on a 4-device mesh of the
conftest's virtual CPU devices, one walker per device; the port with the
4 walkers as one walker batch on one device.

- The double well of tests/test_walkers.py (one particle, the force by
  autograd through the callable engine, so the port steps the walkers one
  after another), γ = 0, 4 strides of 25 from four starts: the shared grid
  (V rtol 1e-5), ``n_hills`` exact, each walker's CV per stride (rtol
  1e-5), the hill log's rows in the reference's order (steps exact,
  centres and heights rtol 1e-5), the per-step visit histogram (exact) and
  the reweighted F̂ (atol 1e-4); with ``add_hills=False`` the frozen
  grid, bit for bit, and heights 0.
- The packed engine (the walker batch: one force call for all 4), 4
  walkers × 500 fcc particles (r_cut 2.0, skin 0.3, cap 32: 3³ cells),
  the lamellar CV, γ = 0, 2 strides of 10, with ``bias_every`` 1 and 5:
  each walker's CV, U and T per stride (rtol 1e-4, as the single sampler's
  test), the grid (rtol 1e-4) and the positions (atol 1e-4).
- The checkpoint resume, bit for bit, on both paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.bias.metad import WELL_TEMPERED
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.forcefield import ForceField as JForceField
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.packed import PackedLamellar as JLamellar
from metadyn_tpu.cv.simple import AxisPosition as JAxisPosition
from metadyn_tpu.integrate.langevin import make_langevin_step as jlangevin
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jplangevin,
)
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import unpack_positions as junpack
from metadyn_tpu.parallel.walkers import WalkerSampler as JWalkerSampler
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import (
    AxisPosition, Box, ForceField, HillSpec, PackedEngine, WalkerSampler,
    make_langevin_step, make_packed_langevin_step, make_state, make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.batch import stack_walkers, walker
from metadyn_tpu_torch.io.hill_log import read_hills
from metadyn_tpu_torch.ops.packed import unpack_positions

from tests.test_torch_cli import torch_threads

W = 4
STARTS = np.asarray([[0.9, 0, 0], [-1.1, 0, 0], [0.7, 0.05, 0],
                     [-0.6, 0, -0.05]], np.float32)
DW_GRID = ([-1.6], [1.6], [161], [0.1])
KT = 0.6


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def _dw_j(pos, state, system):
    x = pos[0, 0]
    return 2.0 * (x * x - 1.0) ** 2 + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2)


def _dw_t(pos, state, system):
    x = pos[0, 0]
    return 2.0 * (x * x - 1.0) ** 2 + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:W]), ("walkers",))


def _jdw(add_hills=True, initial_bias=None, hill_file=None):
    system = jmake_system(1)
    states = jax.vmap(lambda p: jmake_state(p[None, :], JBox.cubic(50.0)))(
        jnp.asarray(STARTS))
    return JWalkerSampler(
        system, states, JForceField(external=_dw_j).bind(system),
        cvs=[JAxisPosition(0, 0, name="x")],
        grid_spec=JGridSpec.create(*DW_GRID),
        hills=JHillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED,
                               deltaT=6.0),
        integrator_factory=lambda f: jlangevin(f, system, dt=0.005, kT=KT,
                                               gamma=0.0),
        mesh=_mesh(), seed=0, hill_file=hill_file, overwrite=True,
        measure_cv_hist=True, add_hills=add_hills,
        initial_bias=initial_bias, chunks_per_block=3)


def _dw(add_hills=True, initial_bias=None, hill_file=None, gamma=0.0):
    from metadyn_tpu_torch import GridSpec
    system = make_system(1, "cpu")
    states = stack_walkers([make_state(p[None, :], Box.cubic(50.0, "cpu"),
                                       device="cpu") for p in STARTS])
    return WalkerSampler(
        system, states, ForceField(external=_dw_t, device="cpu").bind(system),
        [AxisPosition(0, 0, name="x")], GridSpec.create(*DW_GRID, "cpu"),
        HillSpec.create(W=0.1, stride=25, mode=WELL_TEMPERED, deltaT=6.0),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=KT,
                                     gamma=gamma),
        seed=0, hill_file=hill_file, overwrite=True, measure_cv_hist=True,
        add_hills=add_hills, initial_bias=initial_bias, chunks_per_block=2)


@pytest.fixture(scope="module")
def double_well(tmp_path_factory):
    """Both packages' 4 walkers over 4 strides, measuring from the start."""
    d = tmp_path_factory.mktemp("walkers")
    with torch_threads():
        js = _jdw(hill_file=str(d / "jhills.dat"))
        js.begin_measurement()
        jh = js.run(100)
        s = _dw(hill_file=str(d / "hills.dat"))
        assert not s.batched
        s.begin_measurement()
        h = s.run(100)
    return js, jh, s, h, d


def test_double_well_walkers_share_one_grid(double_well):
    js, jh, s, h, _ = double_well
    assert s.n_walkers == W
    assert s.bias.n_hills == int(js.bias.n_hills) == 4 * W
    for m, jm in zip(h, jh):
        assert m["cv"].shape == np.asarray(jm["cv"]).shape == (W, 1)
        for k in ("cv", "hill_height", "bias_V", "potential_energy"):
            np.testing.assert_allclose(m[k], np.asarray(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(js.bias.grid.V), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(s.bias.grid.dV.numpy(),
                               np.asarray(js.bias.grid.dV), rtol=1e-4,
                               atol=1e-5)


def test_double_well_hill_log_rows_in_the_reference_order(double_well):
    _, _, _, _, d = double_well
    a, b = read_hills(str(d / "hills.dat")), read_hills(str(d / "jhills.dat"))
    assert a["cv_names"] == b["cv_names"] == ["cv_x"]
    np.testing.assert_array_equal(a["step"], b["step"])
    assert a["step"].tolist() == [25] * W + [50] * W + [75] * W + [100] * W
    np.testing.assert_allclose(a["center"], b["center"], rtol=1e-5)
    np.testing.assert_allclose(a["height"], b["height"], rtol=1e-5)
    np.testing.assert_array_equal(a["sigma"], b["sigma"])


def test_double_well_reweighted_fes(double_well):
    js, _, s, _, _ = double_well
    assert s._meas_n == js._meas_n == 4
    np.testing.assert_array_equal(s._meas_h, js._meas_h)
    assert s._meas_h.sum() == 100 * W
    np.testing.assert_allclose(s._meas_V, js._meas_V, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.free_energy(KT), js.free_energy(KT),
                               atol=1e-4)


def test_double_well_frozen_bias(double_well):
    """``add_hills=False``: every walker runs under the seeded grid, which
    stays bit for bit; heights 0; the CVs as the reference's."""
    js0, _, s0, _, _ = double_well
    with torch_threads():
        js = _jdw(add_hills=False, initial_bias=js0.bias)
        jh = js.run(50)
        s = _dw(add_hills=False, initial_bias=s0.bias)
        h = s.run(50)
    assert s.hill_log is None
    assert torch.equal(s.bias.grid.V, s0.bias.grid.V)
    assert s.bias.n_hills == s0.bias.n_hills == int(js.bias.n_hills)
    for m, jm in zip(h, jh):
        assert (m["hill_height"] == 0).all()
        np.testing.assert_allclose(m["cv"], np.asarray(jm["cv"]), rtol=1e-5)


def test_double_well_checkpoint_resume_is_bit_for_bit(tmp_path):
    """Noise on (γ 5): kill and resume through the checkpoint repeats the
    straight run, the generator's state and the measurement included."""
    a = _dw(gamma=5.0)
    a.begin_measurement()
    a.run(50)
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    ha = a.run(50)
    b = _dw(gamma=5.0)
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    assert b._meas_n == 2 and b.step == 50
    hb = b.run(50)
    assert torch.equal(a.bias.grid.V, b.bias.grid.V)
    assert torch.equal(a.states.pos, b.states.pos)
    np.testing.assert_array_equal(a._meas_h, b._meas_h)
    for x, y in zip(ha, hb):
        np.testing.assert_array_equal(x["cv"], y["cv"])


def _packed_starts():
    rng = np.random.default_rng(3)
    pos = (fcc_lattice(5, 1.71) + rng.normal(0.0, 0.04, (500, 3))).astype(
        np.float32)
    vels = []
    for w in range(W):
        v = np.random.default_rng(1000 + w).normal(0.0, 1.0, pos.shape)
        vels.append((v - v.mean(axis=0)).astype(np.float32))
    return pos, vels


def _jpacked_states():
    """The reference's packed engine and its walkers' packs (the same
    positions, fresh velocities per walker), the spec and the CV."""
    pos, vels = _packed_starts()
    n, L = pos.shape[0], 5 * 1.71
    spec = JSpec.create(L, n, r_cut=2.0, skin=0.3, cap=32,
                        shift_energy=False)
    engine = JEngine(spec, rebuild_every=5)
    cv = JLamellar.create([[0, 0, 2]], n_real=n, name="a")
    sts = []
    for v in vels:
        st, ovf = engine.pack_state(
            pos, JBox.cubic(L), np.zeros(n, np.int32), np.ones(n, np.float32),
            np.ones(n, np.float32), vel=v,
            extra_attrs={cv.attr_name: np.ones(n, np.float32)})
        assert not bool(ovf)
        sts.append(st)
    return engine, sts, spec, cv


def _jpacked(bias_every):
    engine, sts, spec, cv = _jpacked_states()
    n = spec.n_real
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    ws = JWalkerSampler(
        jmake_system(n), states, engine, cvs=[cv],
        grid_spec=JGridSpec.create([-0.3], [0.3], [61], [0.01]),
        hills=JHillSpec.create(W=0.05, stride=10, mode=WELL_TEMPERED,
                               deltaT=5.0),
        integrator_factory=lambda f: jplangevin(f, dt=0.005, kT=1.0,
                                                gamma=0.0),
        mesh=_mesh(), seed=0, chunks_per_block=2, bias_every=bias_every)
    return ws, sts, spec, cv


def _packed(bias_every, jsts, jspec, jcv):
    spec = interop.packed_spec_from(jspec)
    engine = PackedEngine(spec, "cpu", rebuild_every=5)
    states = stack_walkers([interop.packed_state_from(st, "cpu")
                            for st in jsts])
    ws = WalkerSampler(
        make_system(spec.n_real, "cpu"), states, engine,
        [interop.lamellar_from(jcv, "cpu")],
        interop.grid_spec_from(JGridSpec.create([-0.3], [0.3], [61], [0.01]),
                               "cpu"),
        HillSpec.create(W=0.05, stride=10, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=1.0, gamma=0.0),
        seed=0, chunks_per_block=2, bias_every=bias_every)
    return ws, spec


@pytest.mark.parametrize("bias_every", [1, 5])
def test_packed_walker_batch_matches_reference(bias_every):
    js, jsts, jspec, jcv = _jpacked(bias_every)
    jh = js.run(20)
    s, spec = _packed(bias_every, jsts, jspec, jcv)
    assert s.batched
    h = s.run(20)
    assert s.bias.n_hills == int(js.bias.n_hills) == 2 * W
    for m, jm in zip(h, jh):
        np.testing.assert_allclose(m["cv"], np.asarray(jm["cv"]), rtol=1e-4,
                                   atol=1e-6)
        for k in ("potential_energy", "temperature", "hill_height"):
            np.testing.assert_allclose(m[k], np.asarray(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert not m["nlist_overflow"].any()
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(js.bias.grid.V), rtol=1e-4,
                               atol=1e-6)
    L = 5 * 1.71
    jstates = js.states
    for w in range(W):
        jst = jax.tree.map(lambda x: x[w], jstates)
        d = (unpack_positions(walker(s.states, w), spec).numpy()
             - np.asarray(junpack(jst, jspec)))
        d -= L * np.round(d / L)
        np.testing.assert_allclose(d, 0.0, atol=1e-4)


def test_packed_walker_checkpoint_resume_is_bit_for_bit(tmp_path):
    """The walker batch with noise (γ 1): a resumed run repeats the
    straight one bit for bit, repacks included."""
    pos, vels = _packed_starts()
    n, L = pos.shape[0], 5 * 1.71
    from metadyn_tpu_torch import GridSpec, PackedLamellar, PackedSpec
    spec = PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=32,
                             shift_energy=False)
    cv = PackedLamellar.create([[0, 0, 2]], n, "cpu", name="a")

    def build():
        engine = PackedEngine(spec, "cpu", rebuild_every=5)
        sts = [engine.pack_state(
            pos, Box.cubic(L, "cpu"), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, np.float32), vel=v,
            extra_attrs={cv.attr_name: np.ones(n, np.float32)})[0]
            for v in vels[:2]]
        return WalkerSampler(
            make_system(n, "cpu"), stack_walkers(sts), engine, [cv],
            GridSpec.create([-0.3], [0.3], [61], [0.01], "cpu"),
            HillSpec.create(W=0.05, stride=10, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.005, kT=1.0,
                                                gamma=1.0),
            seed=1, bias_every=5)

    a = build()
    slots0 = a.states.slot_of.clone()
    a.run(20)
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    a.run(20)
    assert (a.states.slot_of != slots0).any()     # the walkers repacked
    b = build()
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    b.run(20)
    for f in dataclasses.fields(a.states):
        x, y = getattr(a.states, f.name), getattr(b.states, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
    assert torch.equal(a.bias.grid.V, b.bias.grid.V)
    assert a.bias.n_hills == b.bias.n_hills == 4 * 2


@pytest.mark.parametrize("kind", ["packed", "particle"])
def test_stacked_walker_states_convert_both_ways(kind):
    """interop.walker_state_from takes the reference's stacked states (its
    walker axis leading) into a walker batch, and walker_state_arrays gives
    them back, field for field, to the bit."""
    if kind == "packed":
        _, jsts, _, _ = _jpacked_states()
    else:
        jsts = [jmake_state(p[None, :], JBox.cubic(50.0)) for p in STARTS]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jsts)
    batch = interop.walker_state_from(jstacked, "cpu")
    assert batch.box.L.shape == (len(jsts), 3)
    back = interop.walker_state_arrays(batch)
    for w, jst in enumerate(jsts):
        one = walker(batch, w)
        pos = one.r if kind == "packed" else one.pos
        np.testing.assert_array_equal(
            pos.numpy(), np.asarray(jst.r if kind == "packed" else jst.pos))
    names = (["r", "v", "f", "image", "ref_r", "pid", "typ", "slot_of",
              "potential_energy", "virial"] if kind == "packed"
             else ["pos", "vel", "force", "image", "potential_energy",
                   "virial", "xi"])
    for k in names:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jstacked,
                                                                  k)), k)
    np.testing.assert_array_equal(back["box"]["L"],
                                  np.asarray(jstacked.box.L))
    if kind == "packed":
        for k, v in jstacked.attrs.items():
            np.testing.assert_array_equal(back["attrs"][k], np.asarray(v))
