"""The whole slice: the port's MetadSampler against the JAX package's, both
on the CPU, in the bench's configuration cut to 864 particles.

Packed LJ liquid (r_cut 2.5, skin 0.55, cap 40, sentinel layout, repack
check every 10 steps), two lamellar CVs on a 64x64 well-tempered grid with
edge walls, stride 20, 3 strides.  γ = 0, so the two packages' different
random streams play no part and the trajectories can be compared.

Tolerances: 60 steps of f32 dynamics whose pair forces are summed in
different orders (~1e-7 relative per force) drift apart slowly; rtol 1e-4
on the per-stride scalars, atol 1e-6 on the CVs (values ~1e-3, sums of
864 cosines), atol 1e-3 on the final positions.
"""
import numpy as np
import pytest
import torch

from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import (
    HillSpec as JHillSpec, WallSpec as JWallSpec, WELL_TEMPERED,
)
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.packed import PackedLamellar as JLamellar
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.ops.packed import unpack_positions as junpack
from metadyn_tpu.sampler import MetadSampler as JSampler
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import (
    HillSpec, MetadSampler, PackedEngine, WallSpec,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops.packed import unpack_positions

STRIDE = 20
GRID = ([-0.06, -0.06], [0.06, 0.06], [64, 64], [0.004, 0.004])


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference(bias_every):
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(6, 1.71)
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    n, L = pos.shape[0], 6 * 1.71
    # hot start (kT ~ 4): the half-skin trigger fires within the run, so
    # the distance-triggered repack is part of what is compared
    vel = rng.normal(0.0, 2.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    spec = JSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                        shift_energy=False, uniform_sigma=1.0,
                        uniform_eps=1.0)
    engine = JEngine(spec, rebuild_every=10)
    assert not engine.use_pallas   # the XLA engine path on the CPU
    cvs = [JLamellar.create([[0, 0, 3]], n_real=n, name="a"),
           JLamellar.create([[0, 3, 0]], n_real=n, name="b")]
    amps = np.ones(n, np.float32)
    state, ovf = engine.pack_state(
        pos, JBox.cubic(L), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={cv.attr_name: amps for cv in cvs})
    assert not ovf
    gspec = JGridSpec.create(*GRID)
    sampler = JSampler(
        jmake_system(n), state, engine, cvs, grid_spec=gspec,
        hills=JHillSpec.create(W=0.1, stride=STRIDE, mode=WELL_TEMPERED,
                               deltaT=5.0),
        integrator_factory=lambda f: jlangevin(f, dt=0.005, kT=1.0,
                                               gamma=0.0),
        seed=0, bias_every=bias_every, chunks_per_block=3,
        walls=JWallSpec.at_grid_edges(gspec, k=2000.0))
    return sampler, state, spec, cvs, gspec


def _port(bias_every, jstate, jspec, jcvs, jgspec):
    """The same sampler in the port, built from the reference's objects."""
    spec = interop.packed_spec_from(jspec)
    n = spec.n_real
    engine = PackedEngine(spec, "cpu", rebuild_every=10)
    gspec = interop.grid_spec_from(jgspec, "cpu")
    return MetadSampler(
        make_system(n, "cpu"), interop.packed_state_from(jstate, "cpu"),
        engine, [interop.lamellar_from(cv, "cpu") for cv in jcvs], gspec,
        HillSpec.create(W=0.1, stride=STRIDE, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=1.0, gamma=0.0),
        seed=0, bias_every=bias_every, chunks_per_block=2,
        walls=WallSpec.at_grid_edges(gspec, k=2000.0)), spec


@pytest.mark.parametrize("bias_every", [5, 1])
def test_sampler_slice_matches_reference(bias_every):
    jsampler, jstate, jspec, jcvs, jgspec = _reference(bias_every)
    sampler, spec = _port(bias_every, jstate, jspec, jcvs, jgspec)
    slot0 = sampler.state.slot_of.clone()
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
    # the half-skin trigger fired: slots migrated in both packages
    assert (sampler.state.slot_of != slot0).any()
    np.testing.assert_array_equal(sampler.state.slot_of.numpy(),
                                  np.asarray(jsampler.state.slot_of))
    assert sampler.bias.n_hills == int(jsampler.bias.n_hills) == 3
    np.testing.assert_allclose(sampler.bias.grid.V.numpy(),
                               np.asarray(jsampler.bias.grid.V), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(sampler.free_energy(1.0),
                               jsampler.free_energy(1.0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(sampler.grid_coords(1),
                               jsampler.grid_coords(1), rtol=1e-6)
    L = float(jstate.box.L[0])
    d = (unpack_positions(sampler.state, spec).numpy()
         - np.asarray(junpack(jsampler.state, jspec)))
    d -= L * np.round(d / L)
    np.testing.assert_allclose(d, 0.0, atol=1e-3)
