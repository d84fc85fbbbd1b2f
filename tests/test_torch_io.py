"""The port's file formats against the JAX package's, on the same inputs
made from a numpy seed: the hill log, CSV and JSONL metrics and DCD
trajectories byte for byte; ``read_hills``, ``fes_from_hills``,
``fes_error_from_hills``, ``read_dcd`` and ``rdf`` bit for bit; grid dumps
read across the two packages with V, dV and the metadata bit for bit; the
YAML reader against ``yaml.safe_load`` on every example config; and the
port's CLI importing neither jax, nor the JAX package, nor PyYAML."""
import glob
import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from metadyn_tpu.bias.grid import BiasGrid as JBiasGrid
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import BiasState as JBiasState
from metadyn_tpu.io import grid_file as jgrid_file
from metadyn_tpu.io import hill_log as jhill_log
from metadyn_tpu.io import metrics as jmetrics
from metadyn_tpu.io import trajectory as jtraj
from metadyn_tpu.utils.analysis import rdf as jrdf

from metadyn_tpu_torch.bias.grid import BiasGrid, GridSpec
from metadyn_tpu_torch.bias.metad import BiasState, HillRecord
from metadyn_tpu_torch.io import config, grid_file, hill_log, metrics
from metadyn_tpu_torch.io import trajectory
from metadyn_tpu_torch.utils.analysis import rdf

EXAMPLES = sorted(glob.glob("examples/*.yaml"))


def _hills(d: int, n: int = 7, seed: int = 0):
    """Hill records, widths and CV names from a numpy seed."""
    rng = np.random.default_rng(seed)
    rec = SimpleNamespace(
        step=np.arange(1, n + 1) * 50,
        center=rng.normal(size=(n, d)).astype(np.float32),
        height=rng.uniform(0.1, 0.5, n).astype(np.float32))
    sigma = rng.uniform(0.05, 0.2, d).astype(np.float32)
    names = [f"cv{k}" for k in range(d)]
    return rec, sigma, names


def _write_hills(tmp_path, d: int, overwrite_second: bool):
    """The same records through both packages' HillLog, in two appends
    (the second log object opened with ``overwrite_second``)."""
    rec, sigma, names = _hills(d)
    cvs = [SimpleNamespace(log_name=f"cv_{n}") for n in names]
    jsam = SimpleNamespace(grid_spec=SimpleNamespace(sigma=jnp.asarray(sigma)),
                           cvs=cvs)
    tsam = SimpleNamespace(grid_spec=SimpleNamespace(
        sigma=torch.as_tensor(sigma)), cvs=cvs)
    paths = {}
    for tag, mod, sam in (("ref", jhill_log, jsam), ("port", hill_log, tsam)):
        p = str(tmp_path / f"{tag}.hills")
        mod.HillLog(p, sam, overwrite=True).append(SimpleNamespace(
            step=rec.step[:4], center=rec.center[:4], height=rec.height[:4]))
        mod.HillLog(p, sam, overwrite=overwrite_second).append(
            SimpleNamespace(step=rec.step[4:], center=rec.center[4:],
                            height=rec.height[4:]))
        paths[tag] = p
    return paths


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("overwrite_second", [False, True])
def test_hill_log_bytes_match_reference(tmp_path, d, overwrite_second):
    paths = _write_hills(tmp_path, d, overwrite_second)
    ref = open(paths["ref"], "rb").read()
    assert open(paths["port"], "rb").read() == ref
    assert ref.count(b"\n") == (1 + 3 if overwrite_second else 1 + 7)


def test_hill_log_takes_a_sampler_block_of_records(tmp_path):
    """``HillLog.append`` takes the port's stacked ``HillRecord`` of host
    arrays, as ``MetadSampler.run`` builds it from a block's metrics."""
    rec, sigma, names = _hills(2)
    sam = SimpleNamespace(grid_spec=SimpleNamespace(
        sigma=torch.as_tensor(sigma)),
        cvs=[SimpleNamespace(log_name=n) for n in names])
    p = str(tmp_path / "h")
    hill_log.HillLog(p, sam, overwrite=True).append(
        HillRecord(step=rec.step, center=rec.center, height=rec.height))
    back = hill_log.read_hills(p)
    np.testing.assert_array_equal(back["step"], rec.step)
    np.testing.assert_allclose(back["center"], rec.center, rtol=1e-7)
    assert back["cv_names"] == names


@pytest.mark.parametrize("mode", ["standard", "well_tempered"])
@pytest.mark.parametrize("d", [1, 2])
def test_read_hills_and_fes_match_reference(tmp_path, mode, d):
    p = _write_hills(tmp_path, d, False)["port"]
    a, b = hill_log.read_hills(p), jhill_log.read_hills(p)
    for k in ("step", "center", "sigma", "height"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["cv_names"] == b["cv_names"]
    coords = [np.linspace(-2.0, 2.0, 21 + 4 * k) for k in range(d)]
    kw = dict(mode=mode, kT=0.7, deltaT=4.0)
    np.testing.assert_array_equal(hill_log.fes_from_hills(p, coords, **kw),
                                  jhill_log.fes_from_hills(p, coords, **kw))
    for x, y in zip(hill_log.fes_error_from_hills(p, coords, n_blocks=3,
                                                  **kw),
                    jhill_log.fes_error_from_hills(p, coords, n_blocks=3,
                                                   **kw)):
        np.testing.assert_array_equal(x, y)


def _metric_rows(n: int = 5):
    """Host metric rows as the samplers return them (numpy scalars and
    arrays of the port's dtypes)."""
    rng = np.random.default_rng(3)
    return [{"step": np.asarray(100 * (i + 1)),
             "cv": rng.normal(size=2).astype(np.float32),
             "bias_V": np.float32(rng.normal()),
             "temperature": np.float32(rng.uniform(0.5, 1.5)),
             "nlist_overflow": np.bool_(i == 3),
             "potential_energy": np.float32(-1000.0 * rng.uniform())}
            for i in range(n)]


@pytest.mark.parametrize("kind", ["csv", "jsonl"])
def test_metrics_text_matches_reference(tmp_path, kind):
    rows = _metric_rows()
    cls = {"csv": "CSVLogger", "jsonl": "JSONLLogger"}[kind]
    out = {}
    for tag, mod in (("ref", jmetrics), ("port", metrics)):
        p = str(tmp_path / f"{tag}.{kind}")
        getattr(mod, cls)(p, overwrite=True).append(rows[:3])
        getattr(mod, cls)(p).append(rows[3:])
        out[tag] = open(p, "rb").read()
    assert out["port"] == out["ref"]
    if kind == "csv":
        back = metrics.read_csv(str(tmp_path / "port.csv"))
        ref = jmetrics.read_csv(str(tmp_path / "port.csv"))
        assert back.keys() == ref.keys()
        for k in back:
            np.testing.assert_array_equal(back[k], ref[k])
        np.testing.assert_array_equal(back["nlist_overflow"],
                                      [0, 0, 0, 1, 0])


def _frames(n_frames: int = 3, n: int = 11):
    rng = np.random.default_rng(7)
    return [rng.normal(size=(n, 3)).astype(np.float32) * 3.0
            for _ in range(n_frames)]


@pytest.mark.parametrize("ext", ["dcd", "npz"])
def test_trajectory_files_match_reference(tmp_path, ext):
    """The same frames, appended in two sessions: DCD byte for byte (its
    header patched in place), npz frames array for array."""
    frames = _frames()
    img = np.zeros((11, 3), np.int32)
    for tag, mod in (("ref", jtraj), ("port", trajectory)):
        p = str(tmp_path / f"{tag}.{ext}")
        w = mod.make_trajectory_writer(p)
        w.append(frames[0], img, [9.0, 8.0, 7.0], step=100)
        if ext == "dcd":
            w.close()
        w = mod.make_trajectory_writer(p, overwrite=False)
        for i, fr in enumerate(frames[1:]):
            w.append(fr, img, [9.0, 8.0, 7.0], step=150 + 50 * i)
        if ext == "dcd":
            w.close()
    ref, port = str(tmp_path / f"ref.{ext}"), str(tmp_path / f"port.{ext}")
    if ext == "dcd":
        assert open(port, "rb").read() == open(ref, "rb").read()
        a, b = trajectory.read_dcd(port), jtraj.read_dcd(port)
    else:
        a, b = trajectory.read_trajectory(port), jtraj.read_trajectory(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["pos"], np.stack(frames))


@pytest.mark.parametrize("per_frame_box", [False, True])
def test_rdf_matches_reference(per_frame_box):
    frames = np.stack(_frames(n=200))
    box = (np.asarray([[9.0, 9.5, 10.0]] * 3) if per_frame_box
           else np.asarray([9.0, 9.5, 10.0]))
    for x, y in zip(rdf(frames, box, n_bins=30),
                    jrdf(frames, box, n_bins=30)):
        np.testing.assert_array_equal(x, y)


def _grid_arrays(periodic):
    rng = np.random.default_rng(11)
    shape = (13, 9)
    return dict(lo=np.asarray([-1.0, 0.5], np.float32),
                hi=np.asarray([1.0, 3.5], np.float32),
                sigma=np.asarray([0.1, 0.2], np.float32), shape=shape,
                periodic=(periodic, False),
                V=rng.normal(size=shape).astype(np.float32),
                dV=rng.normal(size=(2,) + shape).astype(np.float32),
                n_hills=17)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
@pytest.mark.parametrize("periodic", [False, True])
def test_grid_dump_read_across_packages(tmp_path, direction, periodic):
    g = _grid_arrays(periodic)
    p = str(tmp_path / "grid.npz")
    if direction == "port_to_ref":
        spec = GridSpec.create(g["lo"], g["hi"], g["shape"], g["sigma"],
                               "cpu", periodic=g["periodic"])
        bias = BiasState(grid=BiasGrid(spec=spec, V=torch.as_tensor(g["V"]),
                                       dV=torch.as_tensor(g["dV"])),
                         n_hills=g["n_hills"])
        grid_file.dump_grid(p, bias, mode="well_tempered", deltaT=4.0)
        back, meta = jgrid_file.load_grid(p)
        arr = np.asarray
    else:
        spec = JGridSpec.create(g["lo"], g["hi"], g["shape"], g["sigma"],
                                periodic=g["periodic"])
        bias = JBiasState(grid=JBiasGrid(spec=spec, V=jnp.asarray(g["V"]),
                                         dV=jnp.asarray(g["dV"])),
                          n_hills=jnp.int32(g["n_hills"]))
        jgrid_file.dump_grid(p, bias, mode="well_tempered", deltaT=4.0)
        back, meta = grid_file.load_grid(p)
        arr = lambda t: t.numpy() if isinstance(t, torch.Tensor) else t  # noqa
    assert meta == {"mode": "well_tempered", "deltaT": 4.0}
    for k in ("V", "dV"):
        a = arr(getattr(back.grid, k))
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, g[k])
    s = back.grid.spec
    for k in ("lo", "hi", "sigma"):
        np.testing.assert_array_equal(arr(getattr(s, k)), g[k])
    assert tuple(s.shape) == g["shape"]
    assert tuple(s.periodic) == g["periodic"]
    assert int(np.asarray(back.n_hills)) == g["n_hills"]
    # the npz members themselves: the same keys and dtypes either way
    with np.load(p) as z:
        assert sorted(z.files) == sorted(
            ["lo", "hi", "sigma", "shape", "periodic", "V", "dV", "n_hills",
             "mode", "deltaT"])
        assert z["n_hills"].dtype == np.int32
        assert z["shape"].dtype == np.int64
        assert z["deltaT"].dtype == np.float32


@pytest.mark.parametrize("path", EXAMPLES)
def test_yaml_reader_matches_pyyaml(path):
    text = open(path).read()
    ref = yaml.safe_load(text)
    assert config.loads(text) == ref
    assert config.load_config(path) == ref
    # JSON (what the CLI tests write) reads as json.loads reads it
    assert config.loads(json.dumps(ref, indent=1)) == ref


@pytest.mark.parametrize("text", [
    "a: 1e-5\nb: 1.0e-5\nc: 0x1F\nd: 017\ne: .inf\nf: yes\ng: ~\n"
    "h: 'x # y'\ni: \"a\\\"b\"\nj: off\nk: -0.0\nl: 1_000\n",
    "j: [a, {b: 1, c: [2, 3]}, 'q', [[1.0, 0.6], [0.6, 1.0]]]\n"
    "k:\n- 1\n- x\nl:\n  - a: 1   # after\n    b: [2,\n        3]\n"
    "  - c: {d: 3,\n       e: /tmp/x.txt}\n",
    "# only\n---\n- a\n- b: 1\n  c: 2\n-\n  - 1\n  - {}\n- []\n",
])
def test_yaml_reader_scalars_and_nesting(text):
    assert config.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: |\n  b\n", "a: 12:30\n",
                                  "a: 2001-12-14\n", "a: [1, 2\n"])
def test_yaml_reader_refuses_what_it_lacks(text):
    with pytest.raises(ValueError):
        config.loads(text)


def test_python_m_cli_imports_no_jax_package_or_pyyaml(tmp_path):
    """``python -m metadyn_tpu_torch.cli fes`` on a port grid dump, in a
    fresh interpreter (run as ``-m`` runs it, through ``runpy``), leaves
    jax, the JAX package and PyYAML out of ``sys.modules``."""
    g = _grid_arrays(False)
    spec = GridSpec.create(g["lo"], g["hi"], g["shape"], g["sigma"], "cpu")
    grid_file.dump_grid(str(tmp_path / "g.npz"), BiasState(
        grid=BiasGrid(spec=spec, V=torch.as_tensor(g["V"]),
                      dV=torch.as_tensor(g["dV"])), n_hills=3))
    out = str(tmp_path / "fes.dat")
    code = ("import runpy, sys\n"
            f"sys.argv = ['metadyn-torch', 'fes', {str(tmp_path / 'g.npz')!r},"
            f" '--out', {out!r}]\n"
            "try:\n"
            "    runpy.run_module('metadyn_tpu_torch.cli', run_name='__main__',"
            " alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'metadyn_tpu', 'yaml', 'flax')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert np.loadtxt(out).shape == (13 * 9, 3)
