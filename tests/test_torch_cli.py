"""The port's CLI builder and offline subcommands against the JAX package's
``metadyn_tpu/cli.py``, on the CPU.

- ``build_sampler`` on two shrunk example configs, each built by both
  packages: ``config2_diblock_sk`` cut as tests/test_cli.py:226 cuts it
  (40 chains of 10, L 10.2, cap 64, a 16³ mesh), with ``prerelax_steps``
  0 so that both start from the same numpy melt, and
  ``triclinic_packed`` at ``n_cells`` 6 (864 particles).  Held: the packed
  state by particle id (positions, velocities, types, every attr: se/hs,
  the bond partners, the CV coefficients) and the spec exactly, the
  initial CV values rtol 1e-5, the grid, the walls and the hill schedule
  exactly.
- The push-off's force at step 0 (``core/pushoff.prerelax_pack``: the
  soft pair on every pair and FENE + WCA by partner gather, on the packed
  engine) against the reference CLI's ``ForceField(soft_tables(1,
  A=100, r_cut=1), fene=...)`` on the all-pairs engine, on a 512-bead melt:
  |Δf| ≤ 1e-4·max|f| + 1e-4 per component, the energy rtol 1e-5.
- ``rdf`` on a port-written DCD against the reference's command on the
  same file (rtol 1e-6; ``sum-hills`` and ``fes`` are held on a run's
  files in tests/test_torch_cli_runs.py).
- ``rdf`` on a port-written GSD file in both CLIs, as on the DCD.
- The variants of the example YAMLs and the keys that the port once
  refused run (hill-list mode, the 2-D decomposition, the neighbour
  table, GSD frames: the port refuses nothing that the reference runs);
  the combinations the reference refuses raise its ValueError (the NVT
  kinds on the packed engine, NPT on a tilted box, the box bias of
  several walkers, the aspect ratio or a mesh CV beside an order CV on the
  walkers x space product); and no silent CPU fallback.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from metadyn_tpu import cli as jcli
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.forcefield import ForceField
from metadyn_tpu.core.state import make_state, make_system
from metadyn_tpu.ops.bonds import FENEBondParams
from metadyn_tpu.ops.pairs import soft_kernel, soft_tables

from metadyn_tpu_torch import cli
from metadyn_tpu_torch.core.pushoff import prerelax_pack
from metadyn_tpu_torch.interop import packed_spec_fields
from metadyn_tpu_torch.io.trajectory import DCDWriter
from metadyn_tpu_torch.utils.lattice import polymer_melt


@contextlib.contextmanager
def torch_threads(n: int = 2):
    """``n`` torch threads inside the block: the suite runs several
    workers on one machine, and more threads than cores make torch's
    parallel regions crawl."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def shrunk(name: str, tmp_path=None, **over) -> dict:
    """An example config with ``over`` merged in (dicts key by key) and
    its output paths moved into ``tmp_path`` (dropped without one)."""
    with open(f"examples/{name}.yaml") as f:
        cfg = yaml.safe_load(f)

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(cfg, over)
    cfg.setdefault("chunks_per_block", 1)
    out = cfg.setdefault("output", {})
    for k in ("hill_file", "log_file", "grid_file", "checkpoint"):
        if k in out:
            if tmp_path is None:
                del out[k]
            else:
                out[k] = str(tmp_path / os.path.basename(out[k]))
    return cfg


def write_cfg(cfg: dict, path) -> str:
    """``cfg`` as JSON at ``path`` (the CLI reads JSON as it reads YAML)."""
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


BUILD_CASES = {
    "config2": ("config2_diblock_sk", dict(
        system={"init": {"n_chains": 40, "chain_len": 10, "box_L": 10.2,
                         "prerelax_steps": 0}},
        engine={"cap": 64},
        cvs=[{"name": "sk", "kind": "mesh", "mesh": [16, 16, 16],
              "k0": 2.45, "width": 0.4, "mode": [1.0, -1.0],
              "grid": {"min": 0.0, "max": 1200.0, "num_points": 41,
                       "sigma": 30.0}}],
        metadynamics={"stride": 100})),
    "triclinic": ("triclinic_packed", dict(system={"init": {"n_cells": 6}})),
}


@pytest.fixture(scope="module", params=sorted(BUILD_CASES))
def built(request):
    name, over = BUILD_CASES[request.param]
    cfg = shrunk(name, **over)
    ref, _ = jcli.build_sampler(json.loads(json.dumps(cfg)))
    with torch_threads():
        port, _ = cli.build_sampler(json.loads(json.dumps(cfg)),
                                    device="cpu")
    return request.param, ref, port


def _by_pid(a, slot_of):
    a = np.asarray(a)
    return a[..., np.asarray(slot_of)]


@pytest.mark.parametrize("part", ["state", "spec", "cvs", "bias"])
def test_build_sampler_matches_reference(built, part):
    case, ref, port = built
    rs, ps = ref.carry.state, port.carry.state
    if part == "state":
        rso, pso = np.asarray(rs.slot_of), ps.slot_of.numpy()
        for k in ("r", "v", "typ", "image"):
            np.testing.assert_array_equal(
                _by_pid(getattr(ps, k).numpy(), pso),
                _by_pid(getattr(rs, k), rso), err_msg=k)
        assert sorted(ps.attrs) == sorted(rs.attrs)
        for k in rs.attrs:
            np.testing.assert_array_equal(_by_pid(ps.attrs[k].numpy(), pso),
                                          _by_pid(rs.attrs[k], rso),
                                          err_msg=k)
        if case == "config2":
            assert {"bp0", "bp1", "mesh_sk"} <= set(ps.attrs)
        np.testing.assert_array_equal(ps.box.L.numpy(), np.asarray(rs.box.L))
        if case == "triclinic":
            np.testing.assert_array_equal(ps.box.tilt.numpy(),
                                          np.asarray(rs.box.tilt))
    elif part == "spec":
        rspec = ref.engine.spec
        for k, v in packed_spec_fields(port.engine.spec).items():
            assert v == getattr(rspec, k), k
        assert port.engine.rebuild_every == ref.engine.rebuild_every
    elif part == "cvs":
        assert [c.log_name for c in port.cvs] == [c.log_name
                                                  for c in ref.cvs]
        for pc, rc in zip(port.cvs, ref.cvs):
            pv = float(pc.value(ps, port.system))
            rv = float(rc.value(rs, ref.system))
            np.testing.assert_allclose(pv, rv, rtol=1e-5)
    else:
        pg, rg = port.grid_spec, ref.grid_spec
        for k in ("lo", "hi", "sigma"):
            np.testing.assert_array_equal(getattr(pg, k).numpy(),
                                          np.asarray(getattr(rg, k)))
        assert pg.shape == rg.shape and pg.periodic == rg.periodic
        if ref.walls is None:
            assert port.walls is None
        else:
            for k in ("k", "lo", "hi"):
                np.testing.assert_array_equal(
                    getattr(port.walls, k).numpy(),
                    np.asarray(getattr(ref.walls, k)))
        assert port.hills.mode == ref.hills.mode
        assert port.hills.stride == int(ref.hills.stride)
        for k in ("W", "deltaT"):
            assert getattr(port.hills, k) == pytest.approx(
                float(getattr(ref.hills, k)), rel=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_prerelax_force_at_step0_matches_reference(seed):
    """32 chains of 16 at ρ 0.85 (512 beads): the port's push-off force
    (plain soft sweep + gathered FENE/WCA) against the reference CLI's
    all-pairs force field."""
    n_chains, chain_len = 32, 16
    L = float((n_chains * chain_len / 0.85) ** (1 / 3))
    pos, bonds = polymer_melt(n_chains, chain_len, L, seed=seed)
    engine, st = prerelax_pack(pos, bonds, L, "cpu", 30.0, 1.5)
    st, aux = engine.init(st)
    st = engine.refresh_energy(st, aux)
    f_port = st.f[:, st.slot_of.long()].T.numpy()

    n = pos.shape[0]
    sys0 = make_system(n, bonds=bonds)
    ff = ForceField(pair_params=soft_tables(1, A=100.0, r_cut=1.0),
                    pair_kernel=soft_kernel, row_block=min(n, 1024),
                    fene=FENEBondParams(k=jnp.full(1, 30.0),
                                        r0=jnp.full(1, 1.5),
                                        epsilon=jnp.ones(1),
                                        sigma=jnp.ones(1)))
    ref = ff.bind(sys0)(make_state(pos, JBox.cubic(L)))
    f_ref = np.asarray(ref.force)
    tol = 1e-4 * np.abs(f_ref).max() + 1e-4
    assert np.abs(f_port - f_ref).max() <= tol
    np.testing.assert_allclose(float(st.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)


# name -> (overrides, "runs").  Every example
# YAML runs on the port as written since the box CVs, NPT and the walkers x
# space product (ROADMAP queue 1, items 3 and 9's first part); the variants
# that stayed refused run since hill-list mode (item 4) and the 2-D
# decomposition (item 9's second part): Config 1 with an MSD CV in hill-list
# mode, the walkers on 2-D blocks ([3, 1]: config4_walkers has 3^3 cells)
# and config4_walkers_sk_dd's walkers x space with the pencil-FFT S(k) on
# [2, 1], each one stride (of 5 steps on the blocks of 864 particles)
# with two walkers; and the WTE run under NPT with GSD frames since GSD
# (item 8), at 864 particles for one stride of 25 steps (its packed run
# writes no frames, as the reference's).
_ONE_STRIDE = {"n_steps": 20, "report_every": 20}
REFUSED_YAMLS = {
    "config1_lj_lamellar": (dict(cvs=[{
        "name": "m", "kind": "msd", "sigma": 0.1}],
        run={"n_steps": 25, "report_every": 25}), "runs"),
    "config4_walkers": (dict(engine={"spatial_devices": [3, 1]},
                             metadynamics={"n_walkers": 2, "stride": 5},
                             run={"n_steps": 5, "report_every": 5}),
                        "runs"),
    "config4_walkers_sk_dd": (dict(engine={"spatial_devices": [2, 1]},
                                   metadynamics={"n_walkers": 2},
                                   run=_ONE_STRIDE), "runs"),
    "config6_wte": (dict(integrator={"kind": "npt_scr", "pressure": 1.0},
                         system={"init": {"n_cells": 6}},
                         run={"n_steps": 25, "report_every": 25},
                         output={"trajectory": "t.gsd"}), "runs"),
}


@pytest.mark.parametrize("name", sorted(REFUSED_YAMLS))
def test_refused_example_yaml_names_its_item(tmp_path, name):
    """The variants once refused run one stride on the CPU and log one hill
    per walker (the port refuses none of them since GSD)."""
    over, item = REFUSED_YAMLS[name]
    assert item == "runs"
    cfg = shrunk(name, tmp_path, **over)
    p = write_cfg(cfg, tmp_path / "cfg.json")
    assert cli.main(["run", p, "--device", "cpu"]) == 0
    rows = open(cfg["output"]["hill_file"]).read().splitlines()[1:]
    assert len(rows) == int(cfg["metadynamics"].get("n_walkers", 1))
    assert all(np.isfinite([float(x) for x in r.split()]).all()
               for r in rows)


_MESH_CV = {"name": "sk", "kind": "mesh", "mesh": [8, 8, 8], "k0": 2.45,
            "grid": {"min": 0.0, "max": 100.0, "num_points": 5,
                     "sigma": 1.0}}
_AR_CV = {"name": "a", "kind": "aspect_ratio",
          "grid": {"min": 0, "max": 2, "num_points": 5, "sigma": 0.1}}


def _runs_2d(sampler, cfg):
    """The 2-D blocks run a stride; on the YAML's tilted box they refuse,
    as the reference's 2-D islands assert."""
    from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D
    assert isinstance(sampler.engine, SpatialPackedEngine2D)
    assert sampler.engine.shape == (3, 1)
    m = sampler.run(10)[-1]
    assert 0.0 < float(m["cv"][0]) < 1.0
    tilted = shrunk("triclinic_packed", system={"init": {"n_cells": 6}},
                    engine=cfg["engine"])
    with pytest.raises(ValueError, match="orthorhombic"):
        cli.build_sampler(tilted, device="cpu")


def _runs_table(sampler, cfg):
    """The table engine runs a stride and its CV through the table is the
    cell sweeps'; on the YAML's tilted box it refuses (orthorhombic
    minimum image, as the reference)."""
    from metadyn_tpu_torch.cv.packed_order import make_table_order_force
    assert sampler.engine.nbr_table == (2.0, 48)
    m = sampler.run(10)[-1]
    assert not bool(m["nlist_overflow"])
    st = sampler.state
    tv, _ = make_table_order_force(sampler.cvs, sampler.engine.spec)
    np.testing.assert_allclose(
        tv(st, sampler.carry.aux.nbr)[0].numpy(),
        [float(cv.value(st, None)) for cv in sampler.cvs], rtol=2e-5)
    tilted = shrunk("triclinic_packed", system={"init": {"n_cells": 6}},
                    engine=cfg["engine"])
    with pytest.raises(ValueError, match="orthorhombic"):
        cli.build_sampler(tilted, device="cpu")


def _runs_list_mode(sampler, cfg):
    """Hill-list mode: two strides deposit two hills into the buffer."""
    from metadyn_tpu_torch.bias.hill_list import HillListBias
    assert isinstance(sampler.bias, HillListBias)
    hist = sampler.run(20)
    assert int(sampler.bias.n_hills) == 2
    assert not bool(hist[-1]["cv_out_of_grid"])
    np.testing.assert_allclose(sampler.bias.sigma.numpy(),
                               [cfg["cvs"][0]["sigma"]])


def _runs_gsd(sampler, cfg):
    """A ``.gsd`` trajectory builds and runs a stride; its writer is the
    native GSDWriter."""
    import tempfile
    from metadyn_tpu_torch.io.gsd_file import GSDWriter
    from metadyn_tpu_torch.io.trajectory import make_trajectory_writer
    m = sampler.run(10)[-1]
    assert np.isfinite(m["cv"]).all()
    assert cfg["output"]["trajectory"] == "t.gsd"
    with tempfile.TemporaryDirectory() as d:
        w = make_trajectory_writer(os.path.join(d, "t.gsd"))
        assert isinstance(w, GSDWriter) and w.native
        w.close()


REFUSED_KEYS = {
    # the distributed mesh CV under spatial_devices and the walkers x space
    # product run since item 9's first part; what the reference refuses on
    # the product stays refused: the mesh CV beside an order CV
    "spatial_devices": (dict(engine={"spatial_devices": 2},
                             metadynamics={"n_walkers": 2},
                             cvs=[_MESH_CV, {
                                 "name": "q6", "kind": "steinhardt",
                                 "r_cut": 1.49, "grid": {
                                     "min": 0, "max": 1, "num_points": 5,
                                     "sigma": 0.1}}]),
                        "cannot be combined"),
    # the 2-D decomposition (item 9) and the neighbour table (item 6) run
    # on the YAML's box made orthorhombic (3^3 cells: a [3, 1] mesh)
    "spatial_2d": (dict(engine={"spatial_devices": [3, 1]},
                        system={"tilt": None},
                        metadynamics={"stride": 10}), _runs_2d),
    "nbr_table": (dict(engine={"nbr_table": [2.0, 48]},
                       system={"tilt": None},
                       metadynamics={"stride": 10}), _runs_table),
    # the box CVs and NPT run since item 3, hill-list mode since item 4 (the
    # MSD and the Q6 CV without a grid); what stays refused: the aspect
    # ratio on the walkers x space product and the box bias of several
    # walkers (the reference's refusals), NPT on this YAML's tilted box
    "msd": (dict(cvs=[{"name": "m", "kind": "msd", "sigma": 0.1}],
                 metadynamics={"stride": 10}), _runs_list_mode),
    "aspect_ratio": (dict(engine={"spatial_devices": 2},
                          metadynamics={"n_walkers": 2}, cvs=[_AR_CV]),
                     "aspect-ratio"),
    "npt_scr": (dict(integrator={"kind": "npt_scr", "pressure": 1.0}),
                "orthorhombic"),
    "box_bias": (dict(integrator={"kind": "npt_scr", "pressure": 1.0,
                                  "box_bias": True},
                      metadynamics={"n_walkers": 2}), "box_bias"),
    # the NVT integrators run on the particle-order engines since item 7;
    # on this packed YAML they raise the reference CLI's own ValueError
    "nvt_nh": (dict(integrator={"kind": "nvt_nh"}),
               "packed engine supports langevin/nve/npt_scr"),
    "nvt_bdp": (dict(integrator={"kind": "nvt_bdp"}),
                "packed engine supports langevin/nve/npt_scr"),
    "hill_list": (dict(cvs=[{"name": "q6", "kind": "steinhardt",
                             "r_cut": 1.49, "sigma": 0.02}],
                       metadynamics={"stride": 10}), _runs_list_mode),
    # GSD frames since item 8: the native writer (a packed run writes no
    # frames, as in the reference)
    "gsd": (dict(output={"trajectory": "t.gsd"},
                 metadynamics={"stride": 10}), _runs_gsd),
}


@pytest.mark.parametrize("case", sorted(REFUSED_KEYS))
def test_unported_keys_raise_naming_their_item(case):
    """What the reference refuses raises its ValueError; a key once
    refused builds and runs on the CPU, and its check holds."""
    over, item = dict(REFUSED_KEYS[case][0]), REFUSED_KEYS[case][1]
    system = {"init": {"n_cells": 6}, **over.pop("system", {})}
    cfg = shrunk("triclinic_packed", system=system, **over)
    if callable(item):
        sampler, cfg = cli.build_sampler(cfg, device="cpu")
        item(sampler, cfg)
        return
    with pytest.raises(ValueError, match=item):
        cli.build_sampler(cfg, device="cpu")


def test_rdf_reads_gsd(tmp_path):
    """``rdf`` on a port-written GSD file, against the reference's command
    on the same file (formerly refused)."""
    from metadyn_tpu_torch.io.gsd_file import GSDWriter
    rng = np.random.default_rng(4)
    w = GSDWriter(str(tmp_path / "t.gsd"))
    for i in range(3):
        w.append(rng.uniform(-4.0, 4.0, (300, 3)), np.zeros((300, 3)),
                 [8.0, 8.0, 8.0], 100 * i)
    w.close()
    ref, port = _both(lambda p: ["rdf", str(tmp_path / "t.gsd"), "--out", p,
                                 "--bins", "40", "--skip", "1"],
                      tmp_path, "dat")
    np.testing.assert_allclose(port["tab"], ref["tab"], rtol=1e-6)


def test_run_without_cuda_exits_with_an_error(tmp_path, capsys):
    """No CUDA device and no ``--device cpu``: an error, no CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks its absence")
    cfg = shrunk("triclinic_packed", tmp_path,
                 system={"init": {"n_cells": 6}})
    assert cli.main(["run", write_cfg(cfg, tmp_path / "cfg.json")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(cfg["output"]["hill_file"])


def _both(argv_of, d, ext):
    """Run a subcommand in both packages; returns their output tables."""
    out = []
    for tag, main in (("ref", jcli.main), ("port", cli.main)):
        p = str(d / f"{tag}.{ext}")
        assert main(argv_of(p)) == 0
        out.append(dict(np.load(p)) if ext == "npz" else
                   {"tab": np.loadtxt(p)})
    return out


def test_rdf_matches_reference(tmp_path):
    rng = np.random.default_rng(4)
    w = DCDWriter(str(tmp_path / "t.dcd"))
    for i in range(3):
        w.append(rng.uniform(-4.0, 4.0, (300, 3)), np.zeros((300, 3)),
                 [8.0, 8.0, 8.0], 100 * i)
    w.close()
    ref, port = _both(lambda p: ["rdf", str(tmp_path / "t.dcd"), "--out", p,
                                 "--bins", "40", "--skip", "1"],
                      tmp_path, "dat")
    np.testing.assert_allclose(port["tab"], ref["tab"], rtol=1e-6)


@pytest.mark.parametrize("flag", ["nlist_overflow", "cell_width_violation"])
def test_run_refuses_to_go_on_past_a_health_flag(tmp_path, monkeypatch,
                                                 flag):
    """A stride that flags a cell overflow or a cell narrower than r_cut +
    skin ends the run with RuntimeError after a checkpoint, as the
    reference's CLI does: its forces were wrong."""
    cfg = shrunk("triclinic_packed", tmp_path,
                 system={"init": {"n_cells": 6}},
                 metadynamics={"stride": 5},
                 run={"n_steps": 10, "report_every": 5},
                 output={"checkpoint": str(tmp_path / "ck.npz")})
    r = cli.CliRun(cfg, device="cpu")
    run = r.sampler.run

    def flagged(n):
        hist = run(n)
        hist[-1] = {**hist[-1], flag: np.bool_(True)}
        return hist

    monkeypatch.setattr(r.sampler, "run", flagged)
    with pytest.raises(RuntimeError, match="by step 5"):
        r.run()
    assert os.path.exists(cfg["output"]["checkpoint"])
