"""Config 1 (examples/config1_lj_lamellar.yaml: the LJ fluid on the
all-pairs engine, one lamellar CV, standard metadynamics) through the port
against the JAX package, on the CPU, shrunk to ``n_cells`` 4 (256
particles) and run at γ = 0, so that the two packages' different random
streams play no part.

- The slice: ``MetadSampler`` over ``AllPairsEngine`` (row_block 216, so
  the last row block is padded) with ``LamellarOP`` and its autograd bias
  force, built in both packages from the YAML's numbers; 2 strides of 25,
  at ``bias_every`` 1 and 5.
  Held: the CV trace, the hill centres and heights, the temperature and
  energy per stride, and the V grid, rtol 1e-4.
- The CLI: ``cli.build_sampler`` (the state and the initial CV) and
  ``cli.main(["run", ..., "--device", "cpu"])`` on the shrunk YAML against
  the JAX package's ``metadyn run`` on the same file, with Langevin at
  γ = 0 and with ``nvt_nh``: the same number of hill lines, hill values
  and the grid dump's V rtol 1e-4, and the trajectory's frames (one per
  report) atol 1e-4.
"""
import json

import numpy as np
import pytest
import yaml

from metadyn_tpu import cli as jcli
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import HillSpec as JHillSpec
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.engine import AllPairsEngine as JAllPairs
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.lamellar import LamellarOP as JLamellar
from metadyn_tpu.integrate.langevin import make_langevin_step as jlangevin
from metadyn_tpu.ops.pairs import lj_kernel as jlj_kernel
from metadyn_tpu.ops.pairs import lj_tables as jlj_tables
from metadyn_tpu.sampler import MetadSampler as JSampler
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import cli, interop
from metadyn_tpu_torch.bias.metad import HillSpec
from metadyn_tpu_torch.core.engine import AllPairsEngine
from metadyn_tpu_torch.core.state import make_state, make_system
from metadyn_tpu_torch.integrate.langevin import make_langevin_step
from metadyn_tpu_torch.io.grid_file import load_grid
from metadyn_tpu_torch.io.hill_log import read_hills
from metadyn_tpu_torch.io.trajectory import read_trajectory
from metadyn_tpu_torch.ops.pairs import lj_kernel, lj_tables
from metadyn_tpu_torch.sampler import MetadSampler

from tests.test_torch_cli import shrunk, torch_threads, write_cfg

N_CELLS, A, KT, DT, STRIDE = 4, 1.72, 1.5, 0.004, 25
GRID = ([-0.5], [0.5], [101], [0.02])


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


@pytest.fixture(scope="module", params=[1, 5])
def slice_runs(request):
    """Both packages' 2-stride runs of the shrunk slice, at ``bias_every``
    1 and 5 (the bias force held over 5 steps)."""
    bias_every = request.param
    pos = fcc_lattice(N_CELLS, A)
    n, L = pos.shape[0], N_CELLS * A
    rng = np.random.default_rng(1)
    vel = rng.normal(0, np.sqrt(KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    jsys = jmake_system(n)
    jcv = JLamellar.create(mode=[1.0], lattice_vectors=[[0, 0, 1]],
                           name="lam")
    ref = JSampler(
        jsys, jmake_state(pos, JBox.cubic(L), vel=vel),
        JAllPairs(jsys, pair_params=jlj_tables(1, r_cut=2.5),
                  pair_kernel=jlj_kernel, row_block=216),
        cvs=[jcv], grid_spec=JGridSpec.create(*GRID),
        hills=JHillSpec.create(W=0.2, stride=STRIDE, mode="standard"),
        integrator_factory=lambda f: jlangevin(f, jsys, dt=DT, kT=KT,
                                               gamma=0.0),
        seed=1, chunks_per_block=1, bias_every=bias_every)
    with torch_threads():
        sys_ = make_system(n, "cpu")
        port = MetadSampler(
            sys_, make_state(pos, interop.box_from(JBox.cubic(L), "cpu"),
                             vel=vel, device="cpu"),
            AllPairsEngine(sys_, pair_params=lj_tables(1, r_cut=2.5,
                                                       device="cpu"),
                           pair_kernel=lj_kernel, row_block=216,
                           device="cpu"),
            cvs=[interop.lamellar_op_from(jcv, "cpu")],
            grid_spec=interop.grid_spec_from(JGridSpec.create(*GRID), "cpu"),
            hills=HillSpec.create(W=0.2, stride=STRIDE, mode="standard"),
            integrator_factory=lambda f: make_langevin_step(
                f, sys_, dt=DT, kT=KT, gamma=0.0),
            seed=1, chunks_per_block=1, bias_every=bias_every)
        h_port = port.run(2 * STRIDE)
    h_ref = ref.run(2 * STRIDE)
    return ref, port, h_ref, h_port


@pytest.mark.parametrize("key", ["cv", "hill_height", "temperature",
                                 "potential_energy", "bias_V"])
def test_slice_metrics_match_reference(slice_runs, key):
    _, _, h_ref, h_port = slice_runs
    a = np.stack([np.asarray(m[key], np.float64) for m in h_port])
    b = np.stack([np.asarray(m[key], np.float64) for m in h_ref])
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)
    assert not any(bool(m["nlist_overflow"]) for m in h_port)


def test_slice_bias_grid_matches_reference(slice_runs):
    ref, port, _, _ = slice_runs
    V_ref = np.asarray(ref.bias.grid.V)
    np.testing.assert_allclose(port.bias.grid.V.numpy(), V_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(V_ref).max())
    assert port.bias.n_hills == int(ref.bias.n_hills) == 2


def shrunk_config1(tmp_path, kind="langevin"):
    return shrunk("config1_lj_lamellar", tmp_path,
                  system={"init": {"n_cells": N_CELLS}},
                  integrator={"gamma": 0.0, "kind": kind},
                  run={"n_steps": 2 * STRIDE, "report_every": STRIDE})


def test_cli_build_sampler_matches_reference(tmp_path):
    cfg = shrunk_config1(None)
    ref, _ = jcli.build_sampler(json.loads(json.dumps(cfg)))
    port, _ = cli.build_sampler(json.loads(json.dumps(cfg)), device="cpu")
    rs = interop.state_arrays(interop.state_from(ref.carry.state, "cpu"))
    for k in ("pos", "vel", "image", "force", "potential_energy"):
        np.testing.assert_allclose(getattr(port.carry.state, k).numpy(),
                                   rs[k], rtol=1e-5, atol=1e-4, err_msg=k)
    assert isinstance(port.engine, AllPairsEngine)
    assert port.engine.row_block == 216
    s_ref = float(ref.cvs[0].value(ref.carry.state, ref.system))
    s = float(port.cvs[0].value(port.carry.state, port.system))
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["langevin", "nvt_nh"])
def test_cli_run_matches_reference_files(tmp_path, kind):
    """Langevin at γ = 0 and the deterministic Nosé–Hoover step."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    cfg_ref = shrunk_config1(ref_dir, kind)
    cfg_port = shrunk_config1(port_dir, kind)
    for c, d in ((cfg_ref, ref_dir), (cfg_port, port_dir)):
        c["output"]["trajectory"] = str(d / "traj.npz")
    p = ref_dir / "cfg.yaml"
    with open(p, "w") as f:
        yaml.safe_dump(cfg_ref, f)
    assert jcli.main(["run", str(p)]) == 0
    assert cli.main(["run", write_cfg(cfg_port, port_dir / "cfg.json"),
                     "--device", "cpu"]) == 0
    lines = [len(open(c["output"]["hill_file"]).readlines())
             for c in (cfg_ref, cfg_port)]
    assert lines[0] == lines[1] == 3         # the header and two hills
    h_ref, h = (read_hills(c["output"]["hill_file"])
                for c in (cfg_ref, cfg_port))
    np.testing.assert_array_equal(h["step"], h_ref["step"])
    for k in ("center", "sigma", "height"):
        np.testing.assert_allclose(h[k], h_ref[k], rtol=1e-4, atol=1e-7)
    # a trajectory frame per report, as the reference's CLI writes them
    t_ref, t = (read_trajectory(c["output"]["trajectory"])
                for c in (cfg_ref, cfg_port))
    np.testing.assert_array_equal(t["step"], [STRIDE, 2 * STRIDE])
    np.testing.assert_array_equal(t["step"], t_ref["step"])
    np.testing.assert_array_equal(t["image"], t_ref["image"])
    np.testing.assert_allclose(t["pos"], t_ref["pos"], atol=1e-4)
    V_ref = load_grid(cfg_ref["output"]["grid_file"])[0].grid.V.numpy()
    V = load_grid(cfg_port["output"]["grid_file"])[0].grid.V.numpy()
    np.testing.assert_allclose(V, V_ref, rtol=1e-4,
                               atol=1e-4 * np.abs(V_ref).max())
