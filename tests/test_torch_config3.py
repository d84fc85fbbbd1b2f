"""The Config 3 slice (bench_config3.py: Steinhardt Q6 and coordination on a
2-D well-tempered grid, multiple time stepping) through the port's entry
points, on the CPU, cut to 500 particles.

- The exact multiple-time-stepping path (``mts_lag=False``) against the
  JAX package's MetadSampler, γ = 0, 3 strides of 20 steps.  The JAX engine
  runs its XLA sweeps on the CPU.
- The port's lagged path (``mts_lag=True``) against its exact path over 40
  steps, and again with a repack at every rebuild boundary, so that the
  held bias force must travel with the slots.  The JAX package can run
  its lagged path only through its Pallas kernels (interpret mode on a
  CPU, a slow test there); the port runs it with its plain sweeps.

Inputs: an fcc lattice (a = 1.62, 500 particles) with Gaussian noise 0.05
and velocities at kT = 0.6, from a seed; r_cut 2.5 and skin 0.15 (three
cells per axis); the bias starts as a tilted plane (∂V/∂s = (400, 20),
V ≈ 40 at the start), so that the bias force is O(1) from the first step
and the lagged and held forces matter.

Tolerances: as tests/test_torch_sampler.py for the port against the
reference (rtol 1e-4 on per-stride scalars, atol 1e-6 on the CVs, atol
1e-3 on final positions); lagged against exact: CV endpoints rtol and atol
2e-3 (the reference's own, tests/test_fused.py), positions atol 1e-3.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metadyn_tpu.bias.grid import BiasGrid as JBiasGrid
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import BiasState as JBiasState
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.bias.metad import WallSpec as JWallSpec
from metadyn_tpu.bias.metad import WELL_TEMPERED
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import unpack_positions as junpack
from metadyn_tpu.sampler import MetadSampler as JSampler

from metadyn_tpu_torch import (
    Box, HillSpec, MetadSampler, PackedEngine, WallSpec, fcc_lattice,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops.packed import unpack_positions
from metadyn_tpu_torch.sampler import held_g, lag_supported

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)
KT = 0.6
STRIDE = 20
GRID = ([0.0, 4.0], [0.7, 28.0], [48, 48], [0.015, 0.5])
TILT = (400.0, 20.0)
S_REF = (0.425, 15.0)   # V(s0) ≈ 40


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs():
    pos = fcc_lattice(5, A_LAT)
    n, L = pos.shape[0], 5 * A_LAT
    rng = np.random.default_rng(3)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    vel = rng.normal(0.0, np.sqrt(KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    return pos, vel, n, L


def _tilted(grid_coords) -> tuple:
    """(V, dV) of the plane V = TILT · (s − S_REF) on the grid.  V is ~40
    where the run starts: away from 0, so that its relative error means
    something, and small enough that the well-tempered hills W·exp(−V/ΔT)
    keep a finite height."""
    sq, sc = np.meshgrid(*grid_coords, indexing="ij")
    V = (TILT[0] * (sq - S_REF[0]) + TILT[1] * (sc - S_REF[1])
         ).astype(np.float32)
    dV = np.stack([np.full_like(V, TILT[0]), np.full_like(V, TILT[1])])
    return V, dV


def _reference():
    pos, vel, n, L = _inputs()
    spec = JSpec.create(L, n, r_cut=2.5, skin=0.15, cap=40,
                        shift_energy=False, uniform_sigma=1.0,
                        uniform_eps=1.0)
    assert spec.cells_per_dim == (3, 3, 3)
    engine = JEngine(spec, rebuild_every=10)
    assert not engine.use_pallas   # the XLA engine path on the CPU
    state, ovf = engine.pack_state(
        pos, JBox.cubic(L), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel)
    assert not ovf
    cvs = [jpo.PackedSteinhardtQl(spec=spec, r_cut=NN * 1.2, l=6, name="q6"),
           jpo.PackedCoordination(spec=spec, r0=NN * 1.35, name="coord",
                                  r_cut=NN * 1.35 * 1.5)]
    gspec = JGridSpec.create(*GRID)
    V, dV = _tilted([np.asarray(gspec.axis_coords(d)) for d in range(2)])
    bias = JBiasState(grid=JBiasGrid(spec=gspec, V=jnp.asarray(V),
                                     dV=jnp.asarray(dV)),
                      n_hills=jnp.int32(0))
    sampler = JSampler(
        jmake_system(n), state, engine, cvs, grid_spec=gspec,
        hills=JHillSpec.create(W=0.4, stride=STRIDE, mode=WELL_TEMPERED,
                               deltaT=6.0),
        integrator_factory=lambda f: jlangevin(f, dt=0.004, kT=KT,
                                               gamma=0.0),
        seed=0, bias_every=5, chunks_per_block=3, initial_bias=bias,
        walls=JWallSpec.at_grid_edges(gspec, k=200.0))
    return sampler, state, spec, cvs, gspec, bias


def _port_from(jstate, jspec, jcvs, jgspec, jbias, mts_lag=False):
    """The reference's sampler in the port, built from its objects."""
    spec = interop.packed_spec_from(jspec)
    gspec = interop.grid_spec_from(jgspec, "cpu")
    return MetadSampler(
        make_system(spec.n_real, "cpu"),
        interop.packed_state_from(jstate, "cpu"),
        PackedEngine(spec, "cpu", rebuild_every=10),
        [interop.steinhardt_from(jcvs[0]), interop.coordination_from(jcvs[1])],
        gspec,
        HillSpec.create(W=0.4, stride=STRIDE, mode=WELL_TEMPERED, deltaT=6.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=KT, gamma=0.0),
        seed=0, bias_every=5, chunks_per_block=2,
        initial_bias=interop.bias_state_from(jbias, "cpu"),
        walls=WallSpec.at_grid_edges(gspec, k=200.0), mts_lag=mts_lag)


def _port(mts_lag: bool, always_repack: bool = False, gamma: float = 1.0):
    """The slice built in the port alone, the way a user would."""
    from metadyn_tpu_torch import GridSpec, PackedCoordination, PackedSpec
    from metadyn_tpu_torch import PackedSteinhardtQl
    from metadyn_tpu_torch.bias.grid import BiasGrid
    from metadyn_tpu_torch.bias.metad import BiasState
    pos, vel, n, L = _inputs()
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.15, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    engine = PackedEngine(spec, "cpu", rebuild_every=10,
                          always_repack=always_repack)
    state, ovf = engine.pack_state(
        pos, Box.cubic(L, "cpu"), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf
    cvs = [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6"),
           PackedCoordination(spec, r0=NN * 1.35, name="coord",
                              r_cut=NN * 1.35 * 1.5)]
    gspec = GridSpec.create(*GRID, "cpu")
    V, dV = _tilted([gspec.axis_coords(d).numpy() for d in range(2)])
    bias = BiasState(grid=BiasGrid(spec=gspec, V=torch.as_tensor(V),
                                   dV=torch.as_tensor(dV)), n_hills=0)
    return MetadSampler(
        make_system(n, "cpu"), state, engine, cvs, gspec,
        HillSpec.create(W=0.4, stride=STRIDE, mode=WELL_TEMPERED, deltaT=6.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=KT, gamma=gamma),
        seed=0, bias_every=5, chunks_per_block=1, initial_bias=bias,
        walls=WallSpec.at_grid_edges(gspec, k=200.0), mts_lag=mts_lag)


def _positions(sampler) -> np.ndarray:
    return unpack_positions(sampler.state, sampler.engine.spec).numpy()


def _min_image(d: np.ndarray, L: float) -> np.ndarray:
    return d - L * np.round(d / L)


def test_config3_exact_mts_matches_reference():
    jsampler, jstate, jspec, jcvs, jgspec, jbias = _reference()
    sampler = _port_from(jstate, jspec, jcvs, jgspec, jbias)
    jhist = jsampler.run(3 * STRIDE)
    hist = sampler.run(3 * STRIDE)   # blocks of 2 + 1 strides
    assert len(hist) == len(jhist) == 3
    for m, jm in zip(hist, jhist):
        assert int(m["step"]) == int(jm["step"])
        for k in ("nlist_overflow", "nlist_stale", "cell_width_violation",
                  "cv_out_of_grid"):
            assert bool(m[k]) == bool(jm[k]) is False, k
        np.testing.assert_allclose(m["cv"], jm["cv"], rtol=1e-4, atol=1e-6)
        for k in ("hill_height", "bias_V", "potential_energy",
                  "temperature"):
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    assert sampler.bias.n_hills == int(jsampler.bias.n_hills) == 3
    np.testing.assert_allclose(sampler.bias.grid.V.numpy(),
                               np.asarray(jsampler.bias.grid.V), rtol=1e-4,
                               atol=1e-4)
    d = _positions(sampler) - np.asarray(junpack(jsampler.state, jspec))
    np.testing.assert_allclose(_min_image(d, float(jstate.box.L[0])), 0.0,
                               atol=1e-3)


@pytest.mark.parametrize("always_repack", [False, True],
                         ids=["distance_repack", "always_repack"])
def test_lagged_mts_tracks_exact_mts(always_repack):
    """mts_lag=True against mts_lag=False, same seed, 40 steps at γ = 1.
    With a repack at every rebuild boundary the held bias force has to be
    permuted with the slots; the lagged run must then also match the
    lagged run without forced repacks."""
    res = {}
    for lag in (False, True):
        s = _port(lag, always_repack=always_repack)
        g0 = float(held_g(s.state).abs().max()) if lag else None
        slots0 = s.state.slot_of.clone()
        hist = s.run(2 * STRIDE)
        m = hist[-1]
        assert not any(bool(h["nlist_overflow"]) for h in hist)
        assert np.isfinite(m["cv"]).all()
        if always_repack:
            assert (s.state.slot_of != slots0).any()
        assert lag_supported(s.engine, s.cvs)
        if lag:
            assert g0 > 0.5             # a real held bias force
            assert s.carry.ctx is not None
        res[lag] = (np.asarray(m["cv"]), _positions(s), s.state.box.L_host[0])
    np.testing.assert_allclose(res[True][0], res[False][0], rtol=2e-3,
                               atol=2e-3)
    L = res[True][2]
    np.testing.assert_allclose(_min_image(res[True][1] - res[False][1], L),
                               0.0, atol=1e-3)
    if always_repack:
        s = _port(True, always_repack=False)
        s.run(2 * STRIDE)
        np.testing.assert_allclose(
            _min_image(res[True][1] - _positions(s), L), 0.0, atol=1e-4)
