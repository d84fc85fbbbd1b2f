"""The triclinic packed slice (examples/triclinic_packed.yaml: a sheared fcc
LJ crystal in a tilted cell, well-tempered metadynamics on Steinhardt Q6)
through the port's entry points, on the CPU, against the JAX package's
``MetadSampler`` (its XLA sweeps on the CPU).

Cut to ``fcc_lattice(6, 1.68)``: 864 particles, L = 10.08, 3³ cells by the
perpendicular widths, cap 40.  Otherwise the YAML's settings: tilt (0.2,
-0.12, 0.1), the per-slot layout, LJ r_cut 2.5 without shift, skin 0.4,
rebuild every 5 steps; Q6 with r_cut 1.49 on 64 grid points over [0, 0.75]
with σ 0.02; W 0.3, ΔT 4, ``bias_every`` 1; BAOAB dt 0.004, kT 0.7 at γ = 0
(no noise, so both packages integrate the same trajectory), stride 20 (the
YAML's 50, cut).  The cubic lattice is not periodic under the tilted cell,
so the start has close contacts across the z face, as the reference's has.
The bias starts as the plane V = 200·(s − 0.45), V ≈ 20 at the start, so
the Q6 bias force is O(1) from the first step.

Three strides, in the port once repacking when the half-skin criterion
says so and once with a repack at every rebuild boundary, both against one
reference run (a repack permutes slots and changes no trajectory).  The
reference's build and compile are ~50 s of this file's ~100 s on one CPU
process, the port's two runs ~24 s each.  Each run is made once and each
check (a stride, the bias grid, the final positions) is its own case: a
failure names what disagrees, and pytest-xdist's ``--dist loadfile``
hands out the files with the most tests first, so this file's time falls
early in a parallel run and not at its tail.  Tolerances as
tests/test_torch_config3.py: per-stride scalars rtol 1e-4, the CV atol
1e-6, final positions by particle atol 1e-3 (minimum image in the tilted
cell).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metadyn_tpu.bias.grid import BiasGrid as JBiasGrid
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import BiasState as JBiasState
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.bias.metad import WELL_TEMPERED
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.sampler import MetadSampler as JSampler
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import (
    HillSpec, MetadSampler, PackedEngine, make_packed_langevin_step,
    make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import fractional, from_fractional
from metadyn_tpu_torch.ops.packed import unpack_positions

TILT = (0.2, -0.12, 0.1)
KT = 0.7
STRIDE = 20
GRID = ([0.0], [0.75], [64], [0.02])
SLOPE, S_REF = 200.0, 0.45


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    # module scope, so that it is set before the module-scoped runs below.
    # One thread: the port's plain sweeps at this size gain ~20% of wall
    # time from a second thread for ~60% more CPU time, which the other
    # test processes running beside this file pay for
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference():
    pos = fcc_lattice(6, 1.68)
    n, L = pos.shape[0], 6 * 1.68
    rng = np.random.default_rng(11)
    vel = rng.normal(0.0, np.sqrt(KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    spec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                                shift_energy=False, tilt=TILT)
    assert spec.cells_per_dim == (3, 3, 3) and spec.uniform_eps is None
    engine = JEngine(spec, rebuild_every=5)
    assert not engine.use_pallas
    state, ovf = engine.pack_state(
        pos, JBox.triclinic(L, L, L, *TILT), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf
    cv = jpo.PackedSteinhardtQl(spec=spec, r_cut=1.49, l=6, name="q6")
    gspec = JGridSpec.create(*GRID)
    s = np.asarray(gspec.axis_coords(0))
    bias = JBiasState(
        grid=JBiasGrid(spec=gspec,
                       V=jnp.asarray((SLOPE * (s - S_REF)).astype(np.float32)),
                       dV=jnp.full((1, 64), SLOPE, jnp.float32)),
        n_hills=jnp.int32(0))
    sampler = JSampler(
        jmake_system(n), state, engine, [cv], grid_spec=gspec,
        hills=JHillSpec.create(W=0.3, stride=STRIDE, mode=WELL_TEMPERED,
                               deltaT=4.0),
        integrator_factory=lambda f: jlangevin(f, dt=0.004, kT=KT,
                                               gamma=0.0),
        seed=11, chunks_per_block=3, initial_bias=bias)
    return sampler, state, spec, cv, gspec, bias


@pytest.fixture(scope="module")
def reference_run():
    """The reference sampler's start and its three strides, built and run
    once per file."""
    jsampler, jstate, jspec, jcv, jgspec, jbias = _reference()
    jhist = jsampler.run(3 * STRIDE)
    final = np.asarray(jp.unpack_positions(jsampler.state, jspec))
    return (jstate, jspec, jcv, jgspec, jbias, jhist, final,
            np.asarray(jsampler.bias.grid.V))


@pytest.fixture(scope="module", params=[False, True],
                ids=["distance_repack", "always_repack"])
def port_run(request, reference_run):
    """The port from the reference's start, its three strides run once per
    repack policy: repacking when the half-skin criterion says so (as the
    reference does), or at every rebuild boundary.  A repack only permutes
    slots, so both must give the reference's trajectory."""
    always_repack = request.param
    jstate, jspec, jcv, jgspec, jbias = reference_run[:5]
    spec = interop.packed_spec_from(jspec)
    gspec = interop.grid_spec_from(jgspec, "cpu")
    state = interop.packed_state_from(jstate, "cpu")
    assert state.box.tilt_host is not None
    engine = PackedEngine(spec, "cpu", rebuild_every=5,
                          always_repack=always_repack)
    sampler = MetadSampler(
        make_system(spec.n_real, "cpu"), state, engine,
        [interop.steinhardt_from(jcv)], gspec,
        HillSpec.create(W=0.3, stride=STRIDE, mode=WELL_TEMPERED, deltaT=4.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=KT, gamma=0.0),
        seed=11, chunks_per_block=2,
        initial_bias=interop.bias_state_from(jbias, "cpu"))
    slots0 = sampler.state.slot_of.clone()
    hist = sampler.run(3 * STRIDE)             # blocks of 2 + 1 strides
    return always_repack, spec, sampler, slots0, hist


@pytest.mark.parametrize("check", ["stride0", "stride1", "stride2", "bias",
                                   "positions"])
def test_triclinic_slice_matches_reference(reference_run, port_run, check):
    """One check of the port's run against the reference's: a stride's
    scalars and flags, the bias grid after the run, or the final positions
    (and, repacking at every boundary, that particles moved between
    slots)."""
    jhist, jfinal, jV = reference_run[5:]
    always_repack, spec, sampler, slots0, hist = port_run
    assert len(hist) == len(jhist) == 3
    if check.startswith("stride"):
        m, jm = hist[int(check[-1])], jhist[int(check[-1])]
        assert int(m["step"]) == int(jm["step"])
        for k in ("nlist_overflow", "nlist_stale", "cell_width_violation",
                  "cv_out_of_grid"):
            assert bool(m[k]) == bool(jm[k]) is False, k
        np.testing.assert_allclose(m["cv"], jm["cv"], rtol=0.0, atol=1e-6)
        for k in ("hill_height", "bias_V", "potential_energy",
                  "temperature"):
            assert np.all(np.isfinite(m[k])), k
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    elif check == "bias":
        assert sampler.bias.n_hills == 3
        np.testing.assert_allclose(sampler.bias.grid.V.numpy(), jV,
                                   rtol=1e-4, atol=1e-4)
    else:
        if always_repack:
            assert (sampler.state.slot_of != slots0).any()
        box = sampler.state.box
        d = torch.as_tensor(
            unpack_positions(sampler.state, spec).numpy() - jfinal)
        f = fractional(d, box)
        d = from_fractional(f - torch.round(f), box)
        np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-3)
