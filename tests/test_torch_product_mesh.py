"""The slab decomposition under a moving box and the walkers × space
product: the reference's compositions at its own sizes
(tests/test_spatial.py:651-960), each run on the port's slab engine
(2 x-slab shards of the CPU) against the same run on the port's single
grid, at the reference's tolerances.  Both runs draw the same numbers
(one generator, seed 0), so they differ by f32 reduction order alone.

- NPT + WTE under the slabs (``:651``): SCR-NPT and the energy CV on
  ``SpatialPackedEngine(with_energy=True)`` against ``PackedEngine``.
- The mesh CV on the product mesh (``:723``): 2 walkers on the nested
  engine with ``ShardedPackedMesh`` against 2 walkers on ``PackedEngine``
  with ``PackedMesh``.
- NPT + WTE on the product mesh (``:812``): 2 walkers, each with a box of
  its own, one kernel-1 call per shard for both.
- Box metadynamics under the slabs (``:891``): the aspect-ratio CV with
  anisotropic SCR-NPT and ``box_bias_fn``.

fcc 6³ at a 1.6 (864 particles, L 9.6, r_cut 2, skin 0.3, cap 24: 4³
cells, 2 x planes per shard), or the mesh case's 7³ lattice in L 18 (6³
cells); 2 strides of 10 steps (the reference runs 2 or 4 of 25), so the
second stride runs under the bias of the first's hills.  Box and V
rtol 1e-4, atol 1e-4; PE and CV rtol 1e-4 (the mesh case: CV rtol 5e-4,
atol 1e-5, V rtol 1e-3, atol 1e-5, the reference's).
"""
import numpy as np
import pytest

from metadyn_tpu_torch.bias.grid import GridSpec
from metadyn_tpu_torch.bias.metad import WELL_TEMPERED, HillSpec
from metadyn_tpu_torch.core.batch import stack_walkers
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.core.packed_engine import PackedEngine
from metadyn_tpu_torch.core.state import make_system
from metadyn_tpu_torch.cv.aspect_ratio import AspectRatio, box_bias_fn_for
from metadyn_tpu_torch.cv.packed import PackedMesh
from metadyn_tpu_torch.cv.simple import PotentialEnergyCV
from metadyn_tpu_torch.integrate.packed import (
    make_packed_langevin_step, make_packed_npt_scr_step,
)
from metadyn_tpu_torch.ops.packed import PackedSpec, unpack_positions
from metadyn_tpu_torch.parallel.mesh import ShardedPackedMesh
from metadyn_tpu_torch.parallel.spatial import SpatialPackedEngine
from metadyn_tpu_torch.parallel.walkers import WalkerSampler
from metadyn_tpu_torch.sampler import MetadSampler
from metadyn_tpu_torch.utils.lattice import fcc_lattice

from tests.test_torch_cli import torch_threads

SHARDS = ["cpu", "cpu"]
A_LAT, N_CELLS = 1.6, 6
L = N_CELLS * A_LAT
# 2 strides of 10 steps: the second runs under the first stride's hill
STRIDE = 10
N_STEPS = 2 * STRIDE


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def fcc_spec():
    pos = fcc_lattice(N_CELLS, A_LAT)
    return pos, PackedSpec.create(L, pos.shape[0], r_cut=2.0, skin=0.3,
                                  cap=24)


def pack(engine, pos, vel, extra=None):
    n = pos.shape[0]
    st, ovf = engine.pack_state(pos, Box.cubic(L if extra is None else 18.0,
                                               "cpu"),
                                np.zeros(n, np.int32), np.ones(n, np.float32),
                                np.ones(n, np.float32), vel=vel,
                                extra_attrs=extra)
    assert not ovf
    return st


def velocities(n, kT, seed):
    v = np.random.default_rng(seed).normal(0, np.sqrt(kT), (n, 3))
    return (v - v.mean(axis=0)).astype(np.float32)


def engines(spec, nested=False):
    return (PackedEngine(spec, "cpu", rebuild_every=5, with_energy=True),
            SpatialPackedEngine(spec, SHARDS, rebuild_every=5,
                                with_energy=True, nested=nested))


WTE_GRID = ([-8000.0], [0.0], [81], [100.0])


def test_npt_wte_under_spatial_dd():
    pos, spec = fcc_spec()
    n, kT = pos.shape[0], 1.2
    vel = velocities(n, kT, 4)

    def run(engine):
        s = MetadSampler(
            make_system(n, "cpu"), pack(engine, pos, vel), engine,
            [PotentialEnergyCV()], GridSpec.create(*WTE_GRID, "cpu"),
            HillSpec.create(W=2.0, stride=STRIDE, mode=WELL_TEMPERED,
                            deltaT=20.0),
            lambda f: make_packed_npt_scr_step(
                f, spec, dt=0.002, kT=kT, pressure=1.0, gamma=2.0,
                tau_p=1.0, engine=engine), seed=0, chunks_per_block=2)
        return s, s.run(N_STEPS)[-1]

    (s1, m1), (s2, m2) = (run(e) for e in engines(spec))
    assert not m2["nlist_overflow"] and not m2["cell_width_violation"]
    assert int(s2.bias.n_hills) == int(s1.bias.n_hills) == 2
    np.testing.assert_allclose(s2.bias.grid.V.numpy(), s1.bias.grid.V.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s2.state.box.L.numpy(),
                               s1.state.box.L.numpy(), rtol=1e-4, atol=1e-4)
    assert abs(float(s2.state.box.L[0]) - L) > 1e-3
    assert not s2.state.box.fixed
    np.testing.assert_allclose(unpack_positions(s2.state, spec).numpy(),
                               unpack_positions(s1.state, spec).numpy(),
                               rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(m2["potential_energy"], m1["potential_energy"],
                               rtol=1e-4)
    np.testing.assert_allclose(m2["cv"], m1["cv"], rtol=1e-4)


def test_mesh_cv_on_product_mesh():
    g = 7
    sites = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * (18.0 / g) - 9.0 + 0.6
    rng = np.random.default_rng(0)
    pos = (sites + rng.uniform(-0.1, 0.1, sites.shape)).astype(np.float32)
    n = pos.shape[0]
    spec = PackedSpec.create(18.0, n, r_cut=2.5, skin=0.5, cap=24,
                             shift_energy=False)
    k0 = 2.0 * np.pi * 2 / 18.0
    one = PackedMesh.create((8, 8, 8), 18.0, n_real=n, k0=k0, width=0.5,
                            name="sk")
    dd = ShardedPackedMesh.create((8, 8, 8), spec, SHARDS, n_real=n, k0=k0,
                                  width=0.5, box_L=18.0, name="sk")
    extra = {one.attr_name: np.ones(n, np.float32)}
    s0 = float(one.value(pack(PackedEngine(spec, "cpu"), pos, None, extra),
                         None))
    hi = max(8.0 * s0, 10.0)

    def run(engine, cv):
        states = stack_walkers([pack(engine, pos, velocities(n, 1.0, 100 + w),
                                     extra) for w in range(2)])
        s = WalkerSampler(
            make_system(n, "cpu"), states, engine, [cv],
            GridSpec.create([0.0], [hi], [41], [hi / 30], "cpu"),
            HillSpec.create(W=0.5, stride=STRIDE, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.001, kT=1.0,
                                                gamma=1.0),
            seed=0, chunks_per_block=1)
        return s, s.run(N_STEPS)[-1]

    s1, m1 = run(PackedEngine(spec, "cpu", rebuild_every=5), one)
    s2, m2 = run(SpatialPackedEngine(spec, SHARDS, rebuild_every=5,
                                     nested=True), dd)
    assert int(s2.bias.n_hills) == int(s1.bias.n_hills) == 4
    np.testing.assert_allclose(m2["cv"], m1["cv"], rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(s2.bias.grid.V.numpy(), s1.bias.grid.V.numpy(),
                               rtol=1e-3, atol=1e-5)
    assert not np.any(m2["nlist_overflow"])


def test_npt_wte_on_product_mesh():
    pos, spec = fcc_spec()
    n, kT = pos.shape[0], 1.2

    def run(engine):
        states = stack_walkers([pack(engine, pos, velocities(n, kT, 100 + w))
                                for w in range(2)])
        s = WalkerSampler(
            make_system(n, "cpu"), states, engine, [PotentialEnergyCV()],
            GridSpec.create(*WTE_GRID, "cpu"),
            HillSpec.create(W=2.0, stride=STRIDE, mode=WELL_TEMPERED,
                            deltaT=20.0),
            lambda f: make_packed_npt_scr_step(
                f, spec, dt=0.002, kT=kT, pressure=1.0, gamma=2.0,
                tau_p=1.0, engine=engine), seed=0, chunks_per_block=1)
        assert s.batched
        return s, s.run(N_STEPS)[-1]

    (s1, m1), (s2, m2) = (run(e) for e in engines(spec, nested=True))
    assert not np.any(m2["nlist_overflow"])
    assert int(s2.bias.n_hills) == int(s1.bias.n_hills) == 4
    np.testing.assert_allclose(s2.bias.grid.V.numpy(), s1.bias.grid.V.numpy(),
                               rtol=1e-4, atol=1e-4)
    L1, L2 = s1.states.box.L.numpy(), s2.states.box.L.numpy()
    np.testing.assert_allclose(L2, L1, rtol=1e-4, atol=1e-4)
    # each walker's box breathes on its own
    assert np.all(np.abs(L2[:, 0] - L) > 1e-3) and abs(L2[0, 0] - L2[1, 0]) \
        > 1e-4
    np.testing.assert_allclose(m2["potential_energy"], m1["potential_energy"],
                               rtol=1e-4)
    np.testing.assert_allclose(m2["cv"], m1["cv"], rtol=1e-4)


def test_box_metadynamics_under_spatial_dd():
    pos, spec = fcc_spec()
    n, kT = pos.shape[0], 1.0
    vel = velocities(n, kT, 5)
    cv = AspectRatio()

    def run(engine):
        def factory(f, bias):
            return make_packed_npt_scr_step(
                f, spec, dt=0.002, kT=kT, pressure=0.5, gamma=2.0,
                tau_p=1.0, anisotropic=True, engine=engine,
                box_bias_fn=box_bias_fn_for(cv, bias))

        s = MetadSampler(
            make_system(n, "cpu"), pack(engine, pos, vel), engine, [cv],
            GridSpec.create([0.6], [1.6], [41], [0.03], "cpu"),
            HillSpec.create(W=0.3, stride=STRIDE, mode=WELL_TEMPERED,
                            deltaT=4.0),
            factory, seed=0, chunks_per_block=2)
        return s, s.run(N_STEPS)[-1]

    (s1, m1), (s2, m2) = (run(e) for e in engines(spec))
    assert not m2["nlist_overflow"]
    assert int(s2.bias.n_hills) == int(s1.bias.n_hills) == 2
    np.testing.assert_allclose(s2.bias.grid.V.numpy(), s1.bias.grid.V.numpy(),
                               rtol=1e-4, atol=1e-4)
    L1, L2 = s1.state.box.L.numpy(), s2.state.box.L.numpy()
    np.testing.assert_allclose(L2, L1, rtol=1e-4, atol=1e-4)
    # the anisotropic barostat changed the box's shape
    assert abs(L2[0] / L2[1] - 1.0) > 1e-4
    np.testing.assert_allclose(m2["cv"], m1["cv"], rtol=1e-4)
