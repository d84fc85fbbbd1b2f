"""``python -m metadyn_tpu_torch.cli run`` end to end on the CPU, bit-for-bit
resume, and ``sum-hills``/``fes`` on a run's files against the JAX
package's commands.

The four packed example YAMLs, shrunk as tests/test_cli.py shrinks them
and cut further for this file's time (the push-off's plain sweep costs
~20–35 ms a step on the CPU whatever the melt's size): config2 and
config5_flux on one melt, 12 chains of 10 (the reference test's 40 and
30) at L 8.2 with 400 push-off steps, pair r_cut 2 (3³ cells), cap 24
for its ~4.4 beads per cell, config2 with a 16³ mesh; both YAMLs push off at seed 0, kT 1,
FENE k 30, r0 1.5, so the second run takes the first's push-off
(``shared_pushoff``: the push-off is deterministic on the CPU); config3
at ``n_cells`` 6 (the reference test's 7) with the YAML's cap 48; the
triclinic path at
``n_cells`` 6; two strides of production, 25 steps each (20 for
config3, whose repack check runs every 10 steps, and 10 for the
triclinic path; the reference test's strides are 50 to 100 steps).  Each run is made once and each check is
its own case: the exit code and the files; the hill rows the reference
test expects (two hills; the 2-D centres of config3 in six columns),
their centres against the logged CV values; the CSV log's columns (the
reference's metric keys) with ``nlist_overflow`` 0 in every row; the
grid dump; T in a band around the YAML's kT (the reference test's
0.3–3.0 for the melts at kT 1; 0.3–0.9 for config3 at kT 0.6, whose fcc
start dips to ~0.48 in its first strides; 0.4–1.2 for the triclinic
crystal at kT 0.7).

Resume, bit for bit within the port (``io/checkpoint.py``): a
``MetadSampler`` and a ``FluxTemperedSampler`` each run K steps, save, run
K more; a fresh build loads and runs K; the state, the bias, the
histograms and the generator agree exactly.  ``run --resume`` after a
10-step triclinic run with a checkpoint reproduces the straight 20-step
run's hill file, CSV log and grid dump byte for byte.

``sum-hills`` (grid given and auto range, ``--blocks``, well-tempered to
npz) on the straight run's hill file and ``fes`` on its grid dump, against
the reference's commands on the same files, rtol 1e-6.

``config4_walkers`` (3 walkers of 864, 2 strides of 20) and
``config6_wte`` (864 particles, 2 strides of 25) with every output file:
one hill row per (stride, walker), a CSV column per walker, T of the last
stride in a band, W hills per stride in the grid dump; the walkers'
``--resume`` against their straight run, byte for byte.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import cli
from metadyn_tpu_torch.core import pushoff
from metadyn_tpu_torch.io.grid_file import load_grid
from metadyn_tpu_torch.io.hill_log import read_hills
from metadyn_tpu_torch.io.metrics import read_csv

from tests.test_torch_cli import _both, shrunk, torch_threads, write_cfg

# the reference's CSV columns of a metadynamics run (its sorted metric keys)
METAD_COLUMNS = ["bias_V", "cell_width_violation", "cv_0", "cv_out_of_grid",
                 "hill_height", "nlist_overflow", "nlist_stale",
                 "potential_energy", "step", "temperature"]


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def triclinic(tmp_path, n_steps: int) -> dict:
    return shrunk("triclinic_packed", tmp_path,
                  system={"init": {"n_cells": 6}},
                  metadynamics={"stride": 10},
                  run={"n_steps": n_steps, "report_every": 10},
                  output={"log_file": "log.csv", "grid_file": "grid.npz",
                          "checkpoint": "ck.npz"})


# the shrunk melt of config2 and config5_flux
MELT = {"n_chains": 12, "chain_len": 10, "box_L": 8.2,
        "prerelax_steps": 400}

# (example, overrides, hills, T band)
RUNS = {
    "config2": ("config2_diblock_sk", dict(
        system={"init": MELT},
        engine={"pair": {"r_cut": 2.0}, "cap": 24},
        cvs=[{"name": "sk", "kind": "mesh", "mesh": [16, 16, 16],
              "k0": 2.45, "width": 0.4, "mode": [1.0, -1.0],
              "grid": {"min": 0.0, "max": 1200.0, "num_points": 41,
                       "sigma": 30.0}}],
        run={"n_steps": 50, "report_every": 50},
        metadynamics={"stride": 25}), 2, (0.3, 3.0)),
    "config3": ("config3_nucleation_2dcv", dict(
        system={"init": {"n_cells": 6}},
        run={"n_steps": 40, "report_every": 40},
        metadynamics={"stride": 20}), 2, (0.3, 0.9)),
    "config5_flux": ("config5_flux", dict(
        system={"init": MELT},
        engine={"pair": {"r_cut": 2.0}, "cap": 24},
        run={"n_steps": 50, "report_every": 50},
        metadynamics={"stride": 25, "update_period": 2}), 0, (0.3, 3.0)),
    "triclinic": (None, None, 2, (0.4, 1.2)),
}


@contextlib.contextmanager
def shared_pushoff(memo: dict):
    """Inside the block, a push-off with the same arguments as one kept in
    ``memo`` returns that one's positions (a copy) instead of running
    again; a new one is kept there."""
    run = pushoff.prerelax_melt

    def memoized(pos, bonds, *args, **kw):
        key = (pos.tobytes(), bonds.tobytes(), repr(args),
               repr(sorted(kw.items())))
        if key not in memo:
            memo[key] = run(pos, bonds, *args, **kw)
        return memo[key].copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pushoff, "prerelax_melt", memoized)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(case)``: the case's config and exit code, each run once."""
    done, pushoffs = {}, {}

    def get(case):
        if case not in done:
            name, over, _, _ = RUNS[case]
            d = tmp_path_factory.mktemp(case)
            cfg = (triclinic(d, 20) if name is None
                   else shrunk(name, d, **over))
            with shared_pushoff(pushoffs):
                rc = cli.main(["run", write_cfg(cfg, d / "cfg.json"),
                               "--device", "cpu"])
            done[case] = (cfg, rc)
        return done[case]

    return get


@pytest.mark.parametrize("check", ["files", "hills", "log", "grid"])
@pytest.mark.parametrize("case", sorted(RUNS))
def test_cli_run(runs, case, check):
    cfg, rc = runs(case)
    _, _, n_hills, band = RUNS[case]
    out = cfg["output"]
    assert rc == 0
    if check == "files":
        for k in ("hill_file", "log_file", "grid_file", "checkpoint"):
            assert (k in out) == os.path.exists(out.get(k, "")), k
    elif check == "hills":
        if n_hills == 0:
            assert "hill_file" not in out      # flux-tempered: no hills
            return
        lines = open(out["hill_file"]).read().splitlines()
        d = len(cfg["cvs"])
        assert len(lines) == 1 + n_hills
        assert all(len(row.split()) == 2 + 2 * d for row in lines[1:])
        h = read_hills(out["hill_file"])
        stride = cfg["metadynamics"]["stride"]
        np.testing.assert_array_equal(h["step"],
                                      stride * np.arange(1, n_hills + 1))
        assert np.isfinite(h["center"]).all()
        if "log_file" in out:
            log = read_csv(out["log_file"])
            np.testing.assert_allclose(h["center"][:, 0], log["cv_0"],
                                       rtol=1e-7)
    elif check == "log":
        if "log_file" not in out:
            return
        log = read_csv(out["log_file"])
        if n_hills == 0:
            # flux-tempered: one row per update period, a column per stride
            period = cfg["metadynamics"]["update_period"]
            assert log["temperature_0"].shape == (1,)
            temps = np.stack([log[f"temperature_{i}"]
                              for i in range(period)], 1).ravel()
            over = np.stack([log[f"nlist_overflow_{i}"]
                             for i in range(period)], 1).ravel()
        else:
            assert sorted(log) == METAD_COLUMNS
            temps, over = log["temperature"], log["nlist_overflow"]
        assert (over == 0).all()
        assert band[0] < temps[-1] < band[1], temps
    else:
        bias, meta = load_grid(out["grid_file"])
        assert np.isfinite(bias.grid.V.numpy()).all()
        mode = cfg["metadynamics"]["mode"]
        assert meta["mode"] == mode
        if n_hills:
            assert bias.n_hills == n_hills
            assert float(bias.grid.V.max()) > 0.0


@pytest.fixture(scope="module")
def resumed(runs, tmp_path_factory):
    """The triclinic run in two legs of 10 steps, the second ``--resume``,
    beside the straight 20-step run."""
    d = tmp_path_factory.mktemp("resumed")
    cfg = triclinic(d, 10)
    p = write_cfg(cfg, d / "cfg.json")
    with torch_threads():
        assert cli.main(["run", p, "--device", "cpu"]) == 0
        assert cli.main(["run", p, "--device", "cpu", "--resume"]) == 0
        return runs("triclinic")[0]["output"], cfg["output"]


@pytest.mark.parametrize("what", ["hill_file", "log_file", "grid"])
def test_run_resume_matches_straight_run(resumed, what):
    a, b = resumed
    if what == "grid":
        ga, ma = load_grid(a["grid_file"])
        gb, mb = load_grid(b["grid_file"])
        assert ma == mb and ga.n_hills == gb.n_hills == 2
        assert torch.equal(ga.grid.V, gb.grid.V)
        assert torch.equal(ga.grid.dV, gb.grid.dV)
        return
    text = open(a[what], "rb").read()
    assert open(b[what], "rb").read() == text
    assert text.count(b"\n") == 1 + 2


def _tiny(tmp_path, mode: str) -> dict:
    """864-particle fcc in the tilted cell: Q6 metadynamics, or
    flux-tempered metadynamics on a lamellar CV."""
    over = dict(system={"init": {"n_cells": 6}}, chunks_per_block=2,
                metadynamics={"stride": 10}, output={})
    if mode == "flux":
        over["metadynamics"] = {"mode": "flux_tempered", "stride": 10,
                                "update_period": 1, "min_round_trips": 0}
        over["cvs"] = [{"name": "lam", "kind": "lamellar",
                        "lattice_vector": [0, 0, 2],
                        "grid": {"min": -0.5, "max": 0.5, "num_points": 41,
                                 "sigma": 0.02}}]
    return shrunk("triclinic_packed", tmp_path, **over)


def _fingerprint(sampler) -> dict:
    c = sampler.carry
    out = {"r": c.state.r, "v": c.state.v, "f": c.state.f,
           "slot_of": c.state.slot_of, "V": sampler.bias.grid.V,
           "dV": sampler.bias.grid.dV, "gen": c.generator.get_state()}
    if hasattr(c, "flux"):
        out.update(hist=c.flux.hist, up=c.flux.flux_up,
                   down=c.flux.flux_down, prev=c.flux.prev_bin,
                   n_updates=torch.tensor(sampler.n_updates))
    else:
        out.update(step=torch.tensor(c.step),
                   n_hills=torch.tensor(sampler.bias.n_hills))
    return {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("mode", ["metad", "flux"])
def test_sampler_checkpoint_resumes_bit_for_bit(tmp_path, mode):
    cfg = _tiny(tmp_path, mode)
    ck = str(tmp_path / "ck.npz")
    k = 10
    s1, _ = cli.build_sampler(json.loads(json.dumps(cfg)), device="cpu")
    s1.run(k)
    s1.save_checkpoint(ck)
    s1.run(k)
    ref = _fingerprint(s1)
    s2, _ = cli.build_sampler(json.loads(json.dumps(cfg)), device="cpu")
    s2.load_checkpoint(ck)
    s2.run(k)
    got = _fingerprint(s2)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    if mode == "flux":
        assert s2.n_updates == 2
    else:
        assert s2.bias.n_hills == 2


def test_flux_checkpoint_refuses_a_metad_checkpoint(tmp_path):
    """What stays refused: a checkpoint of another sampler's carry."""
    ck = str(tmp_path / "ck.npz")
    s, _ = cli.build_sampler(_tiny(tmp_path, "metad"), device="cpu")
    s.save_checkpoint(ck)
    f, _ = cli.build_sampler(_tiny(tmp_path, "flux"), device="cpu")
    with pytest.raises(ValueError, match="structure"):
        f.load_checkpoint(ck)


@pytest.mark.parametrize("variant", ["grid", "auto", "blocks", "wt_npz"])
def test_sum_hills_matches_reference(runs, tmp_path, variant):
    hills = runs("triclinic")[0]["output"]["hill_file"]
    ext = "npz" if variant == "wt_npz" else "dat"
    extra = {"grid": ["--min", "0.0", "--max", "0.75", "--bins", "64"],
             "auto": [],
             "blocks": ["--bins", "51", "--blocks", "2"],
             "wt_npz": ["--mode", "well_tempered", "--kT", "0.7",
                        "--deltaT", "4.0", "--bins", "33"]}[variant]
    ref, port = _both(lambda p: ["sum-hills", hills, "--out", p] + extra,
                      tmp_path, ext)
    assert ref.keys() == port.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-12)
    if variant == "blocks":
        assert port["tab"].shape == (51, 3)


@pytest.mark.parametrize("ext", ["dat", "npz"])
def test_fes_matches_reference(runs, tmp_path, ext):
    grid = runs("triclinic")[0]["output"]["grid_file"]
    ref, port = _both(lambda p: ["fes", grid, "--out", p, "--kT", "0.7"],
                      tmp_path, ext)
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("case", ["frozen", "mismatched"])
def test_restart_from_grid(runs, tmp_path, case):
    """``restart_from_grid`` seeds the bias from the straight run's dump:
    with ``add_hills: false`` it stays as it was, through the periodic
    dumps (``grid_every`` with ``{step}``), and no hill is logged; a dump
    whose grid differs from the config's is refused."""
    grid = runs("triclinic")[0]["output"]["grid_file"]
    cfg = triclinic(tmp_path, 20)
    cfg["metadynamics"].update(restart_from_grid=grid, add_hills=False)
    cfg["output"].update(grid_file=str(tmp_path / "g_{step}.npz"),
                         grid_every=10, checkpoint_every=10)
    if case == "mismatched":
        cfg["cvs"][0]["grid"]["num_points"] = 65
        with pytest.raises(ValueError, match="grid dump shape"):
            cli.build_sampler(cfg, device="cpu")
        return
    assert cli.main(["run", write_cfg(cfg, tmp_path / "cfg.json"),
                     "--device", "cpu"]) == 0
    seed, _ = load_grid(grid)
    for step in (10, 20):
        b, meta = load_grid(str(tmp_path / f"g_{step}.npz"))
        assert torch.equal(b.grid.V, seed.grid.V) and b.n_hills == 2
        assert meta["mode"] == "well_tempered"
    assert not os.path.exists(cfg["output"]["hill_file"])
    assert os.path.exists(cfg["output"]["checkpoint"])


# examples/config4_walkers.yaml (8 walkers of 864) and config6_wte.yaml
# (2,048 particles) shrunk: 3 walkers of 864 over 2 strides of 20, and the
# energy CV on 864 particles (n_cells 6) over 2 strides of 25, each with
# every output file; config4_walkers_sk_dd.yaml as written (4 walkers of
# 343 on 2 x-slab shards of the CPU, the distributed S(k) CV) but 1 of its
# 5 strides of 20.  (example, overrides, walkers, T band: the fcc starts
# dip in their first strides, config4's to ~0.6 at kT 1, config6's to ~1.0
# at kT 1.5; the sc start of config4_walkers_sk_dd at kT 1 is at 0.95-1.02
# by steps 20-40)
ENSEMBLE_RUNS = {
    "config4_walkers_sk_dd": (dict(
        run={"n_steps": 20, "report_every": 20}), 4, (0.5, 1.5)),
    "config4_walkers": (dict(
        metadynamics={"n_walkers": 3}, run={"n_steps": 40,
                                            "report_every": 20}), 3,
        (0.3, 1.2)),
    "config6_wte": (dict(
        system={"init": {"n_cells": 6}},
        run={"n_steps": 50, "report_every": 50}), 1, (0.5, 2.0)),
}
ENSEMBLE_OUT = {"log_file": "log.csv", "grid_file": "grid.npz",
                "checkpoint": "ck.npz"}


@pytest.fixture(scope="module")
def ensemble_runs(tmp_path_factory):
    """``ensemble_runs(case)``: the case's config and exit code, run once;
    ``ensemble_runs("resumed")``: config4_walkers' 20 + 20 steps
    (``--resume``) beside its straight 40."""
    done = {}

    def get(case):
        if case not in done:
            d = tmp_path_factory.mktemp(case)
            name = "config4_walkers" if case == "resumed" else case
            over = dict(ENSEMBLE_RUNS[name][0])
            over["output"] = ENSEMBLE_OUT
            cfg = shrunk(name, d, **over)
            if case == "resumed":
                cfg["run"]["n_steps"] = 20
            p = write_cfg(cfg, d / "cfg.json")
            with torch_threads():
                rc = cli.main(["run", p, "--device", "cpu"])
                if case == "resumed":
                    rc |= cli.main(["run", p, "--device", "cpu", "--resume"])
            done[case] = (cfg, rc)
        return done[case]

    return get


@pytest.mark.parametrize("check", ["files", "hills", "log", "grid"])
@pytest.mark.parametrize("case", sorted(ENSEMBLE_RUNS))
def test_cli_walkers_and_wte_run(ensemble_runs, case, check):
    """The two YAMLs the walkers and the energy CV unlock: the files, one
    hill row per (stride, walker) in stride order, the CSV log with a
    column per walker, T of the last stride (every walker's) in its band,
    the grid dump with W hills per stride."""
    cfg, rc = ensemble_runs(case)
    _, n_walkers, band = ENSEMBLE_RUNS[case]
    out = cfg["output"]
    stride = cfg["metadynamics"]["stride"]
    strides = cfg["run"]["n_steps"] // stride
    assert rc == 0
    if check == "files":
        for k in ("hill_file", "log_file", "grid_file", "checkpoint"):
            assert os.path.exists(out[k]), k
    elif check == "hills":
        h = read_hills(out["hill_file"])
        np.testing.assert_array_equal(
            h["step"], np.repeat(stride * np.arange(1, strides + 1),
                                 n_walkers))
        assert np.isfinite(h["center"]).all() and (h["height"] > 0).all()
        log = read_csv(out["log_file"])
        cvs = np.stack([log[f"cv_{w}"] for w in range(n_walkers)], 1)
        np.testing.assert_allclose(h["center"][:, 0], cvs.ravel(),
                                   rtol=1e-7)
    elif check == "log":
        log = read_csv(out["log_file"])
        assert len(log["cv_0"]) == strides
        if n_walkers == 1:
            assert sorted(log) == METAD_COLUMNS
            temps = log["temperature"][-1:]
        else:
            assert f"temperature_{n_walkers - 1}" in log
            assert "step" not in log      # the reference's walker metrics
            temps = np.asarray([log[f"temperature_{w}"][-1]
                                for w in range(n_walkers)])
        over = [v for k, v in log.items() if k.startswith("nlist_overflow")]
        assert len(over) == n_walkers and all((v == 0).all() for v in over)
        assert ((band[0] < temps) & (temps < band[1])).all(), temps
    else:
        bias, meta = load_grid(out["grid_file"])
        assert meta["mode"] == cfg["metadynamics"]["mode"]
        assert bias.n_hills == n_walkers * strides
        assert np.isfinite(bias.grid.V.numpy()).all()
        assert float(bias.grid.V.max()) > 0.0


@pytest.mark.parametrize("what", ["hill_file", "log_file", "grid"])
def test_cli_walkers_resume_matches_straight_run(ensemble_runs, what):
    """config4_walkers: 20 steps, then ``--resume`` for 20 more, against the
    straight 40, byte for byte (the stacked walker states, the generator
    and the bias in the checkpoint)."""
    a = ensemble_runs("config4_walkers")[0]["output"]
    b = ensemble_runs("resumed")[0]["output"]
    if what == "grid":
        ga, _ = load_grid(a["grid_file"])
        gb, _ = load_grid(b["grid_file"])
        assert ga.n_hills == gb.n_hills == 6
        assert torch.equal(ga.grid.V, gb.grid.V)
        assert torch.equal(ga.grid.dV, gb.grid.dV)
        return
    assert open(a[what], "rb").read() == open(b[what], "rb").read()


# the box CVs and NPT through the CLI (ROADMAP queue 1, item 3): case ->
# (example, overrides).  config6_wte shrunk to 864 particles (3³ cells of
# 3.44 against r_list 2.9: room for the barostat) under isotropic SCR-NPT
# with its energy CV, the packed MSD CV, and the aspect ratio with
# anisotropic SCR and the box bias; config1 (all pairs) with the MSD CV
# under SCR-NPT.  One stride each.
BOX_BUILDS = {
    "npt_scr": ("config6_wte", dict(integrator={
        "kind": "npt_scr", "pressure": 1.0})),
    "msd": ("config6_wte", dict(cvs=[{
        "name": "m", "kind": "msd",
        "grid": {"min": 0.0, "max": 2.0, "num_points": 41,
                 "sigma": 0.05}}])),
    "box_bias": ("config6_wte", dict(
        integrator={"kind": "npt_scr", "pressure": 1.0, "anisotropic": True,
                    "box_bias": True},
        cvs=[{"name": "a", "kind": "aspect_ratio",
              "grid": {"min": 0.8, "max": 1.2, "num_points": 41,
                       "sigma": 0.01}}])),
    "msd_all_pairs": ("config1_lj_lamellar", dict(
        integrator={"kind": "npt_scr", "pressure": 1.0},
        cvs=[{"name": "m", "kind": "msd",
              "grid": {"min": 0.0, "max": 2.0, "num_points": 41,
                       "sigma": 0.05}}])),
}


@pytest.mark.parametrize("case", sorted(BOX_BUILDS))
def test_cli_box_builds(case):
    """The CLI builds what the reference's builds: the packed SCR step with
    the engine's energy on every force call, the MSD CV with its reference
    positions, the aspect ratio with the two-argument box-bias factory;
    a stride runs and the box moves on the device."""
    name, over = BOX_BUILDS[case]
    cfg = shrunk(name, system={"init": {"n_cells": 6}},
                 metadynamics={"stride": 25}, **over)
    sampler, _ = cli.build_sampler(cfg, device="cpu")
    m = sampler.run(25)[-1]
    box = sampler.state.box
    assert np.all(np.isfinite(m["cv"])) and float(m["hill_height"]) > 0.0
    if "npt_scr" in str(cfg["integrator"].get("kind")):
        assert not box.fixed and float((box.L - 1.72 * 6).abs().max()) > 0.0
        assert getattr(sampler.engine, "virial_live", True)
    if case == "box_bias":
        np.testing.assert_allclose(m["cv"][0], float(box.L[0] / box.L[1]),
                                   rtol=1e-6)
        assert float(box.L[0]) != float(box.L[1])
    if case.startswith("msd"):
        assert 0.0 < float(m["cv"][0]) < 2.0
