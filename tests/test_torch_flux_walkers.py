"""Flux-tempered metadynamics with multiple walkers and on a plain force
callable (``flux_sampler.py``) against the JAX package's, both on the
CPU, on the double well of tests/test_flux_walkers.py (one particle, the
force by autograd through the sampler's callable adapter).

The reference runs its walkers on a 4-device mesh of the conftest's
virtual CPU devices; the port holds them as one walker batch on one device
and steps them one after another (the callable engine takes no batch).  At
γ = 0 from four starts:

- each walker's CV per stride (rtol 1e-5), the round trips of the pooled
  histograms per period (exact), the pooled visit histogram the updates
  consume (exact) and the bias after two updates (V rtol 1e-5);
- the equilibration gate on the pooled statistics: the deferred and the
  applied updates period by period, as the reference's;
- one walker on the callable engine (no batch): the CV trace and the bias
  (rtol 1e-5);
- a resumed walker run repeats the straight one bit for bit (noise on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.forcefield import ForceField as JForceField
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.simple import AxisPosition as JAxisPosition
from metadyn_tpu.flux_sampler import FluxTemperedSampler as JFlux
from metadyn_tpu.integrate.langevin import make_langevin_step as jlangevin

from metadyn_tpu_torch import (
    AxisPosition, Box, FluxTemperedSampler, ForceField, GridSpec,
    make_langevin_step, make_state, make_system,
)
from metadyn_tpu_torch.core.batch import stack_walkers

from tests.test_torch_cli import torch_threads

A_WELL = 3.0
KT = 0.6
STARTS = np.asarray([[0.95, 0, 0], [-1.05, 0, 0], [0.3, 0.05, 0],
                     [-0.2, 0, -0.05]], np.float32)
STRIDE, PERIOD = 25, 2


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def _dw(pos, state, system):
    x = pos[0, 0]
    return A_WELL * (x * x - 1.0) ** 2 + 5.0 * (pos[0, 1] ** 2
                                                + pos[0, 2] ** 2)


def _reference(n_walkers, gamma=0.0, **kw):
    system = jmake_system(1)
    mesh = None
    if n_walkers:
        state = jax.vmap(lambda p: jmake_state(p[None, :],
                                               JBox.cubic(50.0)))(
            jnp.asarray(STARTS[:n_walkers]))
        mesh = Mesh(np.asarray(jax.devices()[:n_walkers]), ("walkers",))
    else:
        state = jmake_state(STARTS[:1], JBox.cubic(50.0))
    return JFlux(
        system, state, JForceField(external=_dw).bind(system),
        cvs=[JAxisPosition(0, 0, name="x")],
        grid_spec=JGridSpec.create([-1.5], [1.5], [61], [0.1]),
        integrator_factory=lambda f: jlangevin(f, system, dt=0.005, kT=KT,
                                               gamma=gamma),
        kT=KT, stride=STRIDE, update_period=PERIOD, seed=0, mesh=mesh, **kw)


def _port(n_walkers, gamma=0.0, **kw):
    system = make_system(1, "cpu")
    box = Box.cubic(50.0, "cpu")
    if n_walkers:
        state = stack_walkers([make_state(p[None, :], box, device="cpu")
                               for p in STARTS[:n_walkers]])
    else:
        state = make_state(STARTS[:1], box, device="cpu")
    return FluxTemperedSampler(
        system, state, ForceField(external=_dw, device="cpu").bind(system),
        [AxisPosition(0, 0, name="x")],
        GridSpec.create([-1.5], [1.5], [61], [0.1], "cpu"),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=KT,
                                     gamma=gamma),
        kT=KT, stride=STRIDE, update_period=PERIOD, seed=0, **kw)


def test_flux_walkers_pool_histograms_like_the_reference():
    js = _reference(4, min_round_trips=0)
    s = _port(4, min_round_trips=0)
    assert s.n_walkers == 4 and not s.batched
    js.begin_measurement()
    s.begin_measurement()
    jh = js.run(2 * STRIDE * PERIOD)
    h = s.run(2 * STRIDE * PERIOD)
    assert s.n_updates == js.n_updates == 2
    for m, jm in zip(h, jh):
        assert m["cv"].shape == np.asarray(jm["cv"]).shape == (4, PERIOD, 1)
        np.testing.assert_allclose(m["cv"], np.asarray(jm["cv"]), rtol=1e-5,
                                   atol=1e-7)
        assert m["round_trips"] == jm["round_trips"]
    np.testing.assert_array_equal(s._meas_h, js._meas_h)
    assert s._meas_h.sum() == 4 * 2 * STRIDE * PERIOD
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(js.bias.grid.V), rtol=1e-5,
                               atol=1e-6)
    # the carry's statistics restart per walker after each update
    assert [f.hist.shape for f in s.carry.flux] == [(61,)] * 4
    assert all(float(f.hist.sum()) == 0.0 for f in s.carry.flux)


def test_flux_walkers_equilibration_gate_like_the_reference():
    """At γ = 0 the four walkers make no round trip through the barrier:
    the gate defers the update on the pooled statistics until its cap."""
    js = _reference(4, min_round_trips=5, max_defer_periods=2)
    s = _port(4, min_round_trips=5, max_defer_periods=2)
    jh = js.run(3 * STRIDE * PERIOD)
    h = s.run(3 * STRIDE * PERIOD)
    applied = [m["update_applied"] for m in h]
    assert applied == [bool(m["update_applied"]) for m in jh] == [
        False, False, True]
    assert s.n_updates == js.n_updates == 1
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(js.bias.grid.V), rtol=1e-5,
                               atol=1e-6)


def test_flux_sampler_on_a_callable_engine_like_the_reference():
    """One walker, the force a plain callable (the reference wraps it in
    its _CallableEngine, as the port does)."""
    js = _reference(0, min_round_trips=0)
    s = _port(0, min_round_trips=0)
    assert s.n_walkers is None
    jh = js.run(2 * STRIDE * PERIOD)
    h = s.run(2 * STRIDE * PERIOD)
    for m, jm in zip(h, jh):
        np.testing.assert_allclose(m["cv"], np.asarray(jm["cv"]), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(js.bias.grid.V), rtol=1e-5,
                               atol=1e-6)


def test_flux_walkers_checkpoint_resume_is_bit_for_bit(tmp_path):
    a = _port(3, gamma=2.0, min_round_trips=0)
    a.run(STRIDE * PERIOD)
    a.save_checkpoint(str(tmp_path / "ck.npz"))
    ha = a.run(STRIDE * PERIOD)
    b = _port(3, gamma=2.0, min_round_trips=0)
    b.load_checkpoint(str(tmp_path / "ck.npz"))
    hb = b.run(STRIDE * PERIOD)
    assert b.n_updates == a.n_updates == 2
    assert torch.equal(a.bias.grid.V, b.bias.grid.V)
    np.testing.assert_array_equal(ha[-1]["cv"], hb[-1]["cv"])
    # independent streams: the walkers' states differ
    assert len(np.unique(np.round(ha[-1]["cv"][:, -1, 0], 6))) == 3
