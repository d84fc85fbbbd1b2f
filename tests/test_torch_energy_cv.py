"""The well-tempered ensemble's energy CVs (``cv/simple.py``) against the
JAX package's, both on the CPU.

- ``EnergyCV`` (the reference's CollectiveWrapper): the value of
  tests/test_cvs.py:218's wrapper, and its bias force through the
  sampler's autograd path against ``jax.grad`` (rtol 1e-5).
- ``PotentialEnergyCV`` on the packed engine with ``with_energy=True``,
  as tests/test_packed.py:388-416 builds it (864 fcc particles plus noise,
  r_cut 2.5, skin 0.5, cap 40, the per-slot layout), at γ = 0: the
  sampler over 2 strides of 10 (the CV trace, U and the grid V rtol 1e-5,
  positions atol 1e-4), and 20 BAOAB steps of the biased force under a
  fixed grid, the CV and U step by step.  The integrator hands each force
  call the new positions with the last call's force and energy, so the
  CV is U one force call old and its bias force dVds · (F_pair + g) of
  that call: both packages do so.
- The reference's refusal of an energy CV on an engine whose inner force
  calls skip the energy.
- ``bias/grid.grad_fd`` against ``value_and_grad`` and the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.grid import grad_fd as jgrad_fd
from metadyn_tpu.bias.metad import BiasState as JBiasState
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.bias.metad import WELL_TEMPERED
from metadyn_tpu.bias.metad import deposit as jdeposit
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.simple import EnergyCV as JEnergyCV
from metadyn_tpu.cv.simple import PotentialEnergyCV as JPotentialEnergyCV
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import unpack_positions as junpack
from metadyn_tpu.sampler import MetadSampler as JSampler
from metadyn_tpu.sampler import make_biased_force as jbiased_force
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import (
    Box, EnergyCV, GridSpec, HillSpec, MetadSampler, PackedEngine, PotentialEnergyCV,
    make_biased_force, make_packed_langevin_step, make_state, make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.bias.grid import grad_fd, value_and_grad
from metadyn_tpu_torch.bias.metad import BiasState
from metadyn_tpu_torch.ops.packed import unpack_positions
from metadyn_tpu_torch.sampler import make_bias_force_parts

STRIDE = 10
A_LAT = 1.7
L = 6 * A_LAT


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wire(p, state, system):
    return jnp.sum(p[:, 0] ** 2) + 0.5 * jnp.sum(p[:, 1] * p[:, 2])


def _wire_t(p, state, system):
    return torch.sum(p[:, 0] ** 2) + 0.5 * torch.sum(p[:, 1] * p[:, 2])


def test_energy_cv_value_and_bias_force_match_reference():
    """tests/test_cvs.py:218's wrapper, and the bias force −dVds·∂s/∂r by
    the port's autograd against the reference's jax.grad."""
    n = 16
    pos = np.random.default_rng(6).uniform(-4.0, 4.0, (n, 3)).astype(
        np.float32)
    jstate, jsystem = jmake_state(pos, JBox.cubic(8.0)), jmake_system(n)
    state = make_state(pos, Box.cubic(8.0, "cpu"), device="cpu")
    system = make_system(n, "cpu")
    jcv = JEnergyCV(energy_fn=_wire, name="wte")
    cv = EnergyCV(energy_fn=_wire_t, name="wte")
    assert cv.log_name == jcv.log_name == "cv_wte"
    np.testing.assert_allclose(float(cv.value(state, system)),
                               float(jcv.value(jstate, jsystem)), rtol=1e-6)

    class Positions:      # the engine protocol's position leaf
        def positions(self, st):
            return st.pos

        def with_positions(self, st, r):
            return st.replace(pos=r)

    g = GridSpec.create([0.0], [400.0], [41], [5.0], "cpu")
    eval_bias, _ = make_bias_force_parts(Positions(), [cv], system)
    dvds = 0.37
    zero = BiasState.zeros(g)
    bias = BiasState(grid=zero.grid.replace(
        dV=torch.full_like(zero.grid.dV, dvds)), n_hills=0)
    f_bias, dVds, s = eval_bias(state, None, bias)
    jf = -dvds * np.asarray(jax.grad(lambda p: _wire(p, jstate, jsystem))(
        jstate.pos))
    np.testing.assert_allclose(float(dVds[0]), dvds, rtol=1e-6)
    np.testing.assert_allclose(f_bias.numpy(), jf, rtol=1e-5, atol=1e-6)


def _start():
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(6, A_LAT) + rng.normal(0.0, 0.05, (864, 3))).astype(
        np.float32)
    vel = rng.normal(0.0, 1.0, pos.shape).astype(np.float32)
    vel -= vel.mean(axis=0)
    return pos, vel


def _reference_engine():
    """tests/test_packed.py:388-416's engine and start, on the reference's
    XLA path (its energy live at every force call)."""
    pos, vel = _start()
    n = pos.shape[0]
    spec = JSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40)
    engine = JEngine(spec, rebuild_every=5, with_energy=True)
    assert not engine.use_pallas
    st, ovf = engine.pack_state(pos, JBox.cubic(L), jnp.zeros(n, jnp.int32),
                                eps_i=jnp.ones(n), sigma_i=jnp.ones(n),
                                vel=vel)
    assert not bool(ovf)
    return engine, st, spec


def _grid(e0):
    return JGridSpec.create([e0 - 800.0], [e0 + 800.0], [81], [40.0])


def _port_engine(jst, jspec):
    spec = interop.packed_spec_from(jspec)
    return (PackedEngine(spec, "cpu", rebuild_every=5, with_energy=True),
            interop.packed_state_from(jst, "cpu"), spec)


def test_wte_sampler_matches_reference():
    """2 strides of 10 at γ = 0: the CV (U) trace, U, the grid V, the
    hills and the final positions."""
    jengine, jst, jspec = _reference_engine()
    n = jspec.n_real
    e0 = float(jengine.init(jst)[0].potential_energy)
    jg = _grid(e0)
    jhills = JHillSpec.create(W=10.0, stride=STRIDE, mode=WELL_TEMPERED,
                              deltaT=500.0)
    js = JSampler(jmake_system(n), jst, jengine, cvs=[JPotentialEnergyCV()],
                  grid_spec=jg, hills=jhills,
                  integrator_factory=lambda f: jlangevin(f, dt=0.004,
                                                         kT=1.0, gamma=0.0),
                  seed=0, chunks_per_block=2)
    engine, st, spec = _port_engine(jst, jspec)
    s = MetadSampler(make_system(n, "cpu"), st, engine, [PotentialEnergyCV()],
                     interop.grid_spec_from(jg, "cpu"),
                     HillSpec.create(W=10.0, stride=STRIDE,
                                     mode=WELL_TEMPERED, deltaT=500.0),
                     lambda f: make_packed_langevin_step(f, dt=0.004, kT=1.0,
                                                         gamma=0.0),
                     seed=0, chunks_per_block=2)
    jh = js.run(2 * STRIDE)
    h = s.run(2 * STRIDE)
    for m, jm in zip(h, jh):
        np.testing.assert_allclose(m["cv"], jm["cv"], rtol=1e-5)
        np.testing.assert_allclose(m["potential_energy"],
                                   jm["potential_energy"], rtol=1e-5)
        np.testing.assert_allclose(m["hill_height"], jm["hill_height"],
                                   rtol=1e-5)
    assert s.bias.n_hills == int(js.bias.n_hills) == 2
    # the hills sit at U ~ -5,000, where an f32 ulp is 4.9e-4: centres a
    # few ulps apart (rtol ~1e-6) move each node of V by up to its slope
    # times the shift, which no rtol on V alone bounds in the hills' tails
    shift = max(abs(float(m["cv"][0]) - float(jm["cv"][0]))
                for m, jm in zip(h, jh))
    slope = float(np.abs(np.asarray(js.bias.grid.dV)).max())
    V, jV = s.bias.grid.V.numpy(), np.asarray(js.bias.grid.V)
    np.testing.assert_allclose(V, jV, rtol=1e-5,
                               atol=2 * slope * shift + 1e-6 * jV.max())
    d = (unpack_positions(s.state, spec).numpy()
         - np.asarray(junpack(js.state, jspec)))
    d -= L * np.round(d / L)
    np.testing.assert_allclose(d, 0.0, atol=1e-4)


def test_wte_steps_match_reference_step_by_step():
    """20 BAOAB steps of the biased force under a fixed grid (five hills
    around the start's U, so ∂V/∂s is far from 0): the CV and U after each
    step, and the positions.  The CV each force call reads is U of the
    call before, and its bias force dVds · (F_pair + g) of that call."""
    jengine, jst, jspec = _reference_engine()
    n = jspec.n_real
    jsystem = jmake_system(n)
    jst, jaux = jengine.init(jst)
    e0 = float(jst.potential_energy)
    jg = _grid(e0)
    jbias = JBiasState.zeros(jg)
    hills = JHillSpec.create(W=20.0, stride=1)
    for c in (-120.0, -60.0, 0.0, 40.0, 100.0):
        jbias, _ = jdeposit(hills, jbias, jnp.asarray([e0 + c]),
                            jnp.int32(0))
    jforce = jbiased_force(jengine, [JPotentialEnergyCV()], jsystem)
    jstep = jax.jit(jlangevin(lambda st: jforce(st, jaux, jbias), dt=0.004,
                              kT=1.0, gamma=0.0))
    engine, st, spec = _port_engine(jst, jspec)
    system = make_system(n, "cpu")
    st, aux = engine.init(st)
    bias = interop.bias_state_from(jbias, "cpu")
    cv = PotentialEnergyCV()
    force = make_biased_force(engine, [cv], system)
    step = make_packed_langevin_step(lambda s2: force(s2, aux, bias),
                                     dt=0.004, kT=1.0, gamma=0.0)
    _, dVds = value_and_grad(bias.grid, torch.tensor([e0]))
    assert abs(float(dVds[0])) > 0.05
    key = jax.random.PRNGKey(0)
    for _ in range(20):
        jst = jstep(jst, key)
        st = step(st)
        np.testing.assert_allclose(float(cv.value(st, system)),
                                   float(jst.potential_energy), rtol=1e-5)
    d = (unpack_positions(st, spec).numpy()
         - np.asarray(junpack(jst, jspec)))
    d -= L * np.round(d / L)
    np.testing.assert_allclose(d, 0.0, atol=1e-4)


def test_wte_refused_without_live_energy():
    """Both packages refuse PotentialEnergyCV on a packed engine whose inner
    force calls skip the energy."""
    pos, vel = _start()
    n = pos.shape[0]
    jspec = JSpec.create(L, n, r_cut=2.5, skin=0.5, cap=40)
    jengine = JEngine(jspec, rebuild_every=5, use_pallas=True)
    assert not jengine.energy_live
    from metadyn_tpu.sampler import make_bias_force_parts as jparts
    with pytest.raises(AssertionError, match="with_energy=True"):
        jparts(jengine, [JPotentialEnergyCV()], jmake_system(n))
    engine = PackedEngine(interop.packed_spec_from(jspec), "cpu",
                          rebuild_every=5)
    assert not engine.energy_live
    with pytest.raises(AssertionError, match="with_energy=True"):
        make_bias_force_parts(engine, [PotentialEnergyCV()],
                              make_system(n, "cpu"))


@pytest.mark.parametrize("periodic", [False, True])
def test_grad_fd_matches_value_and_grad(periodic):
    """The finite-difference ∂V/∂s of the interpolant against the analytic
    derivative grids (a spacing-limited agreement) and against the
    reference's grad_fd (rtol 1e-5)."""
    jg = JGridSpec.create([-1.0, -2.0], [1.0, 2.0], [81, 101], [0.2, 0.3],
                          periodic=[periodic, False])
    jbias = JBiasState.zeros(jg)
    hills = JHillSpec.create(W=1.0, stride=1)
    for c in ((0.1, 0.3), (-0.4, -0.5), (0.5, 1.1)):
        jbias, _ = jdeposit(hills, jbias, jnp.asarray(c), jnp.int32(0))
    bias = interop.bias_state_from(jbias, "cpu")
    for p in ((0.05, 0.2), (-0.33, -0.61), (0.47, 1.0)):
        s = torch.tensor(p)
        g = grad_fd(bias.grid, s)
        _, dV = value_and_grad(bias.grid, s)
        np.testing.assert_allclose(g.numpy(), dV.numpy(), rtol=0.05,
                                   atol=0.02 * float(dV.abs().max()))
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jgrad_fd(jbias.grid, jnp.asarray(p))),
            rtol=1e-5, atol=1e-6)
