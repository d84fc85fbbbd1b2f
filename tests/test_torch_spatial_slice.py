"""The slab slice end to end on the CPU: ``MetadSampler`` on the port's
``SpatialPackedEngine`` (2 virtual shards of the CPU, every island on)
against the JAX package's single-grid sampler, the port's 2 shards against
its own single grid with the noise on, and the CLI with
``engine.spatial_devices: 2``.

1. Q6 + coordination on fcc 6³ (864 particles at ρ 1.0, a = 1.5874, kT
   0.3, dt 0.002; LJ r_cut 2, skin 0.35: 4³ cells, cap 32), 20 steps at γ
   = 0 in strides of 10 with a well-tempered hill per stride, as the
   reference's own
   ``tests/test_spatial.py::test_order_cvs_under_spatial_dd`` holds its
   sharded engine against its single-grid one at fcc 8³: CVs rtol 1e-4
   (atol 1e-5),
   two hills each, grid V rtol 1e-4 (atol 1e-6), PE rtol 1e-5.  γ = 0,
   since the two packages draw their noise from different generators.
2. The port's 2 shards against its single grid at γ = 1 with the same
   seed, lagged multiple time stepping on (the islands' monomial kernel
   against the single grid's recurrence one): the state is global, so is
   the noise; positions atol 1e-4, CVs rtol 1e-5.
3. ``python -m metadyn_tpu_torch.cli run`` on config3 shrunk to fcc 8³
   (4³ cells) with ``spatial_devices: 2 --device cpu`` against the same
   run unsharded, the YAML's lagged multiple time stepping in both (on the
   CPU the slab engine runs its islands, as on the card): the hill files
   are equal.
"""
import json

import numpy as np
import pytest
import torch

from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.bias.metad import WELL_TEMPERED as JWT
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.integrate.packed import make_packed_langevin_step as jstep
from metadyn_tpu.ops.packed import PackedSpec as JSpec
from metadyn_tpu.sampler import MetadSampler as JSampler
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedCoordination, PackedEngine,
    PackedSpec, PackedSteinhardtQl, WELL_TEMPERED, make_packed_langevin_step,
    make_system,
)
from metadyn_tpu_torch import cli
from metadyn_tpu_torch.io.hill_log import read_hills
from metadyn_tpu_torch.parallel.spatial import SpatialPackedEngine
from metadyn_tpu_torch.sampler import lag_supported

from tests.test_torch_cli import shrunk, torch_threads, write_cfg

A = 1.5874
N_CELLS = 6
NN = A / np.sqrt(2)
# LJ r_cut 2 and skin 0.35: 4³ cells of 2.38 (two x-planes per shard), and
# the stencil still covers coordination's r_cut (1.35·1.5 nn = 2.27)
SPEC = dict(r_cut=2.0, skin=0.35, cap=32, shift_energy=False)


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def inputs():
    pos = fcc_lattice(N_CELLS, A)
    n = pos.shape[0]
    rng = np.random.default_rng(3)
    vel = rng.normal(0, np.sqrt(0.3), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    return pos, vel, n, N_CELLS * A


def port_sampler(engine, gamma: float, **kw):
    pos, vel, n, L = inputs()
    spec = engine.spec
    st, ovf = engine.pack_state(pos, Box.cubic(L, "cpu"),
                                np.zeros(n, np.int32), np.ones(n, np.float32),
                                np.ones(n, np.float32), vel=vel)
    assert not ovf
    cvs = [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6"),
           PackedCoordination(spec, r0=NN * 1.35, r_cut=NN * 1.35 * 1.5,
                              name="co")]
    return MetadSampler(
        make_system(n, "cpu"), st, engine, cvs,
        GridSpec.create([0.0, 4.0], [0.7, 16.0], [24, 24], [0.02, 0.5],
                        "cpu"),
        HillSpec.create(W=0.3, stride=10, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=0.3,
                                            gamma=gamma),
        seed=0, chunks_per_block=1, **kw)


def spec_of(L, n, **kw):
    return PackedSpec.create(L, n, **SPEC, **kw)


def test_sharded_sampler_matches_reference_single_grid():
    pos, vel, n, L = inputs()
    jspec = JSpec.create(L, n, **SPEC)
    assert jspec.cells_per_dim == (4, 4, 4)
    jengine = JEngine(jspec, rebuild_every=5, use_pallas=False)
    jst, ovf = jengine.pack_state(pos, JBox.cubic(L), np.zeros(n, np.int32),
                                  eps_i=np.ones(n, np.float32),
                                  sigma_i=np.ones(n, np.float32), vel=vel)
    assert not bool(ovf)
    jref = JSampler(
        jmake_system(n), jst, jengine,
        cvs=[jpo.PackedSteinhardtQl(spec=jspec, r_cut=NN * 1.2, l=6,
                                    name="q6"),
             jpo.PackedCoordination(spec=jspec, r0=NN * 1.35,
                                    r_cut=NN * 1.35 * 1.5, name="co")],
        grid_spec=JGridSpec.create([0.0, 4.0], [0.7, 16.0], [24, 24],
                                   [0.02, 0.5]),
        hills=JHillSpec.create(W=0.3, stride=10, mode=JWT, deltaT=5.0),
        integrator_factory=lambda f: jstep(f, dt=0.002, kT=0.3, gamma=0.0),
        seed=0, chunks_per_block=1)
    m_ref = jref.run(20)[-1]

    engine = SpatialPackedEngine(spec_of(L, n), ["cpu", "cpu"],
                                 rebuild_every=5)
    s = port_sampler(engine, gamma=0.0)
    m = s.run(20)[-1]
    assert 0.4 < float(np.asarray(m_ref["cv"])[0]) < 0.65
    np.testing.assert_allclose(m["cv"], np.asarray(m_ref["cv"]), rtol=1e-4,
                               atol=1e-5)
    assert int(s.bias.n_hills) == int(jref.bias.n_hills) == 2
    np.testing.assert_allclose(s.bias.grid.V.numpy(),
                               np.asarray(jref.bias.grid.V), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(float(m["potential_energy"]),
                               float(m_ref["potential_energy"]), rtol=1e-5)


def test_sharded_sampler_matches_single_grid_with_noise():
    pos, vel, n, L = inputs()
    runs = []
    spec = spec_of(L, n, uniform_sigma=1.0, uniform_eps=1.0)
    for engine in (PackedEngine(spec, "cpu", rebuild_every=5),
                   SpatialPackedEngine(spec, ["cpu", "cpu"],
                                       rebuild_every=5)):
        s = port_sampler(engine, gamma=1.0, bias_every=5, mts_lag=True)
        m = s.run(20)[-1]
        runs.append((s.state.r[:, s.state.slot_of.long()].numpy(), m["cv"],
                     int(s.bias.n_hills)))
    (r1, cv1, h1), (r2, cv2, h2) = runs
    np.testing.assert_allclose(r2, r1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(cv2, cv1, rtol=1e-5)
    assert h1 == h2 == 2


def test_cli_spatial_devices_matches_unsharded(tmp_path):
    hills = []
    for sp_dev in (1, 2):
        d = tmp_path / f"sp{sp_dev}"
        d.mkdir()
        cfg = shrunk("config3_nucleation_2dcv", d,
                     system={"init": {"n_cells": 8}},
                     engine={"spatial_devices": sp_dev},
                     run={"n_steps": 40, "report_every": 40},
                     metadynamics={"stride": 20})
        assert cli.main(["run", write_cfg(cfg, d / "cfg.json"),
                         "--device", "cpu"]) == 0
        with open(cfg["output"]["hill_file"]) as f:
            hills.append(f.read())
        assert read_hills(cfg["output"]["hill_file"])["step"].tolist() == [
            20, 40]
    assert hills[0] == hills[1]
    assert bool(cfg["metadynamics"]["mts_lag"])
    # the sharded build: the slab engine on two virtual CPU shards
    sampler, _ = cli.build_sampler(json.loads(json.dumps(cfg)),
                                   device="cpu")
    assert isinstance(sampler.engine, SpatialPackedEngine)
    assert [str(d) for d in sampler.engine.devices] == ["cpu", "cpu"]
    assert lag_supported(sampler.engine, sampler.cvs)
