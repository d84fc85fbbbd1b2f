"""The Config 2 slice (examples/config2_diblock_sk.yaml: a bead-spring
diblock melt with FENE bonds and a per-type ε table, well-tempered
metadynamics on the S(k) mesh CV) through the port's entry points, on the
CPU, cut to 640 beads; and the soft push-off engine that relaxes its start.

- ``MetadSampler`` with ``PackedMesh`` through the autograd bias path,
  against the JAX package's sampler (its ``jax.vjp`` path, XLA sweeps on
  the CPU), γ = 0, 2 strides of 20 steps, states carried across by interop.
- The soft push-off (``pair_kind="soft"``, A = 100, FENE bonds, r_cut 1)
  on both packages' packed engines, γ = 0, 20 steps with repacks.

Inputs: 64 diblock chains of 10 beads laid straight on a lattice at ρ 0.85
(L = 9.10) with noise 0.02 and velocities from a numpy seed
(tests/test_torch_bond_kernels.lattice_melt); Config 2's engine (r_cut 2.5
without shift, ε table [[1, .6], [.6, 1]], FENE k 30 r0 1.5, skin 0.4,
rebuild every 5 steps), CV (k0 = 2π·2/L, width 0.4, 16³ mesh, CIC) and
bias (W 0.3, ΔT 5, walls k 50).  Config 2's grid, 81 points over [0, 8000]
with σ 100, holds S(k0) ≈ 1.6e3 at 8192 beads; at 640 beads S(k0) ≈ 131
sits below its lower wall (5% in from the edge), so the grid here is 81
points over [−500, 2500] with σ 37.5 (the same σ per span).  The bias
starts as the plane V = 2·(s − 111), V ≈ 40 at the start, so the bias
force is O(1) from the first step.

Tolerances as tests/test_torch_config3.py: rtol 1e-4 on per-stride
scalars and the CV, atol 1e-3 on final positions, V grid rtol and atol
1e-4.
"""
import numpy as np
import pytest
import torch

import jax
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
from metadyn_tpu.cv.packed import PackedMesh as JPackedMesh
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.sampler import MetadSampler as JSampler

from metadyn_tpu_torch import (
    HillSpec, MetadSampler, PackedEngine, WallSpec,
    make_packed_langevin_step, make_system, polymer_melt,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops.packed import unpack_positions

from tests.test_torch_bond_kernels import lattice_melt

STRIDE = 20
GRID = ([-500.0], [2500.0], [81], [37.5])
TILT, S_REF = 2.0, 111.0


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference():
    pos, vel, bonds, types, L = lattice_melt(10, 8, noise=0.02)
    n = pos.shape[0]
    es, _, ed, _ = jp.pair_scale_tables([[1.0, 0.6], [0.6, 1.0]])
    spec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                                shift_energy=False, fene_k=30.0, fene_r0=1.5,
                                eps_scale=es)
    engine = JEngine(spec, rebuild_every=5)
    assert not engine.use_pallas
    cv = JPackedMesh.create((16, 16, 16), L, n_real=n, k0=2 * np.pi * 2 / L,
                            width=0.4, name="sk")
    state, ovf = engine.pack_state(
        pos, JBox.cubic(L), types, ed[types], np.ones(n, np.float32),
        vel=vel, extra_attrs={**jp.bond_partner_attrs(bonds, n),
                              cv.attr_name: np.asarray(
                                  [1.0, -1.0], np.float32)[types]})
    assert not ovf
    gspec = JGridSpec.create(*GRID)
    s = np.asarray(gspec.axis_coords(0))
    V = (TILT * (s - S_REF)).astype(np.float32)
    bias = JBiasState(grid=JBiasGrid(spec=gspec, V=jnp.asarray(V),
                                     dV=jnp.full((1, 81), TILT, jnp.float32)),
                      n_hills=jnp.int32(0))
    sampler = JSampler(
        jmake_system(n, types=types, bonds=bonds), state, engine, [cv],
        grid_spec=gspec,
        hills=JHillSpec.create(W=0.3, stride=STRIDE, mode=WELL_TEMPERED,
                               deltaT=5.0),
        integrator_factory=lambda f: jlangevin(f, dt=0.002, kT=1.0,
                                               gamma=0.0),
        seed=0, chunks_per_block=2, initial_bias=bias,
        walls=JWallSpec.at_grid_edges(gspec, k=50.0))
    return sampler, state, spec, cv, gspec, bias


def test_config2_sampler_matches_reference():
    jsampler, jstate, jspec, jcv, jgspec, jbias = _reference()
    spec = interop.packed_spec_from(jspec)
    gspec = interop.grid_spec_from(jgspec, "cpu")
    cv = interop.mesh_from(jcv, "cpu")
    assert not hasattr(cv, "accum_bias_force")     # the autograd path
    sampler = MetadSampler(
        make_system(spec.n_real, "cpu"),
        interop.packed_state_from(jstate, "cpu"),
        PackedEngine(spec, "cpu", rebuild_every=5), [cv], gspec,
        HillSpec.create(W=0.3, stride=STRIDE, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0, gamma=0.0),
        seed=0, chunks_per_block=2,
        initial_bias=interop.bias_state_from(jbias, "cpu"),
        walls=WallSpec.at_grid_edges(gspec, k=50.0))
    jhist = jsampler.run(2 * STRIDE)
    hist = sampler.run(2 * STRIDE)
    assert len(hist) == len(jhist) == 2
    for m, jm in zip(hist, jhist):
        assert int(m["step"]) == int(jm["step"])
        for k in ("nlist_overflow", "nlist_stale", "cell_width_violation",
                  "cv_out_of_grid"):
            assert bool(m[k]) == bool(jm[k]) is False, k
        for k in ("cv", "hill_height", "bias_V", "potential_energy",
                  "temperature"):
            assert np.all(np.isfinite(m[k])), k
            np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
        assert float(m["hill_height"]) > 0.0
    assert sampler.bias.n_hills == int(jsampler.bias.n_hills) == 2
    np.testing.assert_allclose(sampler.bias.grid.V.numpy(),
                               np.asarray(jsampler.bias.grid.V), rtol=1e-4,
                               atol=1e-4)
    L = float(jstate.box.L[0])
    d = (unpack_positions(sampler.state, spec).numpy()
         - np.asarray(jp.unpack_positions(jsampler.state, jspec)))
    np.testing.assert_allclose(d - L * np.round(d / L), 0.0, atol=1e-3)


def test_soft_pushoff_engine_matches_reference():
    """The packed soft push-off of the Config 2/5 start (A = 100 through
    eps_i, FENE bonds, r_cut 1, skin 1) on a random-walk melt, 20 steps at
    γ = 0 with a repack every 5: the port's engine routes the soft pair to
    the plain sweep and matches the reference's XLA path."""
    pos, bonds = polymer_melt(16, 10, 9.0, seed=0)
    n, L = pos.shape[0], 9.0
    jspec = jp.PackedSpec.create(L, n, r_cut=1.0, skin=1.0, cap=40,
                                 pair_kind="soft", fene_k=30.0, fene_r0=1.5)
    jengine = JEngine(jspec, rebuild_every=5)
    jst, ovf = jengine.pack_state(
        pos, JBox.cubic(L), np.zeros(n, np.int32),
        np.full(n, 100.0, np.float32), np.ones(n, np.float32),
        extra_attrs=jp.bond_partner_attrs(bonds, n))
    assert not ovf
    engine = PackedEngine(interop.packed_spec_from(jspec), "cpu",
                          rebuild_every=5, always_repack=True)
    st = interop.packed_state_from(jst, "cpu")
    jst, jaux = jengine.init(jst)
    st, aux = engine.init(st)
    jstep = jax.jit(jlangevin(lambda s: jengine.force_into(s, None),
                              dt=0.002, kT=1.0, gamma=0.0))
    step = make_packed_langevin_step(lambda s: engine.force_into(s, aux),
                                     dt=0.002, kT=1.0, gamma=0.0)
    key = jax.random.PRNGKey(0)
    jrepack = jax.jit(jp.repack_incremental, static_argnums=1)
    for blk in range(4):
        jst, _ = jrepack(jst, jspec)
        st, aux = engine.rebuild(st, aux)
        for _ in range(5):
            jst = jstep(jst, key)
            st = step(st, noise=torch.zeros_like(st.v))
    spec = engine.spec
    d = (unpack_positions(st, spec).numpy()
         - np.asarray(jp.unpack_positions(jst, jspec)))
    np.testing.assert_allclose(d - L * np.round(d / L), 0.0, atol=1e-3)
    assert not bool(aux.overflow)
    ref = engine.refresh_energy(st, aux)
    assert torch.isfinite(ref.f).all() and float(ref.potential_energy) > 0.0


def test_sampler_refuses_energy_cvs():
    """An energy CV (the well-tempered ensemble) on a packed engine whose
    inner force calls skip the energy (no ``with_energy``) is refused, as
    the reference refuses it."""
    from metadyn_tpu_torch import Box, GridSpec, PackedSpec

    class EnergyCV:
        name = "pe"
        needs_live_energy = True

        def value(self, state, system):
            return state.potential_energy

    pos, vel, _, types, L = lattice_melt(10, 8, noise=0.02)
    n = pos.shape[0]
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40)
    engine = PackedEngine(spec, "cpu", rebuild_every=5)
    state, _ = engine.pack_state(pos, Box.cubic(L, "cpu"), types,
                                 np.ones(n, np.float32),
                                 np.ones(n, np.float32), vel=vel)
    assert not engine.energy_live
    with pytest.raises(AssertionError, match="with_energy=True"):
        MetadSampler(
            make_system(n, "cpu"), state, engine, [EnergyCV()],
            GridSpec.create(*GRID, "cpu"),
            HillSpec.create(W=0.3, stride=STRIDE),
            lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0))
