"""GSD trajectories (``io/gsd_file.py`` and its native core
``csrc/gsd.cpp``) against the JAX package's ``metadyn_tpu/io/gsd_file.py``,
on the CPU.

- The port's native writer and its ``_PyFile`` against the reference's
  writer on the same frames: the same bytes but for the header's 64-byte
  ``application`` field (bytes 48-111), which names each package.
- Each package's reader on the other's files; append-by-replay
  (``overwrite=False``) against the straight file, byte for byte.
- The mirrors of the reference's tests/test_io.py:132-213: the v1 layout
  at struct level, the HOOMD chunks through the reader, frame-0
  inheritance, the replay, and the Python writer's layout.
- ``run --device cpu`` of Config 1 (the all-pairs example, the one
  example whose runs write frames; packed runs write none, as in the
  reference) cut to 256 particles and 50 steps (2 reports), to a
  ``.gsd`` and to an npz trajectory: their frames equal to the bit; a
  ``--resume`` leg's file holds the straight run's frames, each with the
  leg's own step count as in the reference, byte for byte; ``rdf`` on
  the ``.gsd`` in both CLIs (rtol 1e-6, as tests/test_torch_cli.py holds
  ``rdf`` on a DCD).
"""
import struct

import numpy as np
import pytest

from metadyn_tpu.io import gsd_file as jgsd

from metadyn_tpu_torch import cli
from metadyn_tpu_torch.io import gsd_file as tgsd
from metadyn_tpu_torch.io.trajectory import (
    make_trajectory_writer, read_trajectory,
)

from tests.test_torch_cli import _both, shrunk, torch_threads, write_cfg

APP = slice(48, 112)   # the header's application field


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def _frames(seed=2, n=5, k=3):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(n, 3)).astype(np.float32) for _ in range(k)],
            [rng.integers(-2, 3, (n, 3)).astype(np.int32) for _ in range(k)])


def _write(writer_cls, path, frames, imgs, step0=10, **kw):
    w = writer_cls(str(path), **kw)
    for i, (fr, im) in enumerate(zip(frames, imgs)):
        w.append(fr, im, [6.0, 7.0, 8.0], step=step0 + 5 * i,
                 velocity=fr * 0.5 if i == 1 else None)
    w.close()
    return w


def _same_but_application(a: bytes, b: bytes) -> None:
    assert len(a) == len(b)
    assert a[:APP.start] == b[:APP.start] and a[APP.stop:] == b[APP.stop:]


@pytest.mark.parametrize("core", ["native", "python"])
def test_writer_matches_reference_bytes(tmp_path, monkeypatch, core):
    """Same frames, same bytes as the reference's writer but for the
    application field; ``native`` tells which core wrote."""
    frames, imgs = _frames()
    _write(jgsd.GSDWriter, tmp_path / "ref.gsd", frames, imgs)
    if core == "python":
        monkeypatch.setenv("METADYN_NO_NATIVE", "1")
    w = _write(tgsd.GSDWriter, tmp_path / "port.gsd", frames, imgs)
    assert w.native == (core == "native")
    a = (tmp_path / "ref.gsd").read_bytes()
    b = (tmp_path / "port.gsd").read_bytes()
    _same_but_application(a, b)
    assert b[APP].rstrip(b"\0") == b"metadyn_tpu_torch"


def test_readers_read_each_others_files(tmp_path):
    frames, imgs = _frames(seed=3)
    _write(jgsd.GSDWriter, tmp_path / "ref.gsd", frames, imgs)
    _write(tgsd.GSDWriter, tmp_path / "port.gsd", frames, imgs)
    for reader, other in ((tgsd, "ref.gsd"), (jgsd, "port.gsd")):
        mine = reader.read_gsd_frames(str(tmp_path / other))
        theirs = (jgsd if reader is tgsd else tgsd).read_gsd_frames(
            str(tmp_path / other))
        assert len(mine) == len(theirs) == 3
        for fa, fb in zip(mine, theirs):
            assert fa.keys() == fb.keys()
            for k in fa:
                np.testing.assert_array_equal(fa[k], fb[k])
        np.testing.assert_array_equal(mine[2]["particles/position"],
                                      frames[2])


def test_append_by_replay_gives_the_straight_file(tmp_path):
    frames, imgs = _frames(seed=4, k=4)
    _write(tgsd.GSDWriter, tmp_path / "straight.gsd", frames, imgs)
    p = tmp_path / "legs.gsd"
    _write(tgsd.GSDWriter, p, frames[:2], imgs[:2])
    w = tgsd.GSDWriter(str(p), overwrite=False)
    for i in (2, 3):
        w.append(frames[i], imgs[i], [6.0, 7.0, 8.0], step=10 + 5 * i)
    w.close()
    assert p.read_bytes() == (tmp_path / "straight.gsd").read_bytes()


def test_gsd_roundtrip_native(tmp_path):
    """The mirror of the reference's test of the native writer: v1 byte
    layout at struct level, HOOMD chunks through the independent reader,
    frame-0 inheritance, append-resume."""
    assert tgsd._lib() is not None, "g++ is expected in this environment"
    p = str(tmp_path / "traj.gsd")
    w = make_trajectory_writer(p)
    assert isinstance(w, tgsd.GSDWriter) and w.native
    frames, imgs = _frames()
    for i, (fr, im) in enumerate(zip(frames, imgs)):
        w.append(fr, im, [6.0, 7.0, 8.0], step=10 + 5 * i)
    w.close()

    raw = open(p, "rb").read()
    magic, index_loc, _, nm_loc, _, schema_ver, gsd_ver = \
        struct.unpack_from("<QQQQQII", raw, 0)
    assert magic == 0x65DF65DF65DF65DF
    assert gsd_ver == (1 << 16)                  # v1 layout
    assert schema_ver == (1 << 16) | 4           # hoomd 1.4
    assert raw[48:48 + 17] == b"metadyn_tpu_torch"
    assert raw[112:112 + 5] == b"hoomd"
    frame0, n0, loc0 = struct.unpack_from("<QQq", raw, index_loc)
    assert frame0 == 0 and loc0 >= 256

    doc = tgsd.read_gsd(p)
    assert doc["schema"] == "hoomd" and len(doc["frames"]) == 3
    f0 = doc["frames"][0]
    np.testing.assert_allclose(f0["particles/position"], frames[0])
    np.testing.assert_array_equal(f0["particles/image"], imgs[0])
    np.testing.assert_allclose(f0["configuration/box"][:3], [6., 7., 8.])
    assert f0["configuration/step"][0] == 10
    assert f0["particles/N"][0] == 5
    assert tgsd.gsd_types(f0) == ["A"]
    assert "particles/typeid" not in doc["frames"][2]
    inh = tgsd.read_gsd_frames(p)
    np.testing.assert_array_equal(inh[2]["particles/typeid"],
                                  np.zeros(5, np.uint32))
    np.testing.assert_allclose(inh[2]["particles/position"], frames[2])
    assert inh[2]["configuration/step"][0] == 20

    w2 = tgsd.GSDWriter(p, overwrite=False)
    w2.append(frames[0], imgs[0], [6.0, 7.0, 8.0], step=25)
    w2.close()
    doc2 = tgsd.read_gsd(p)
    assert len(doc2["frames"]) == 4
    np.testing.assert_allclose(doc2["frames"][3]["particles/position"],
                               frames[0])
    np.testing.assert_allclose(doc2["frames"][1]["particles/position"],
                               frames[1])


def test_gsd_python_writer_identical_layout(tmp_path):
    """The mirror of the reference's test of its Python writer, and its
    bytes against the native core's for the same chunks."""
    pos = np.arange(12, dtype=np.float32).reshape(4, 3)
    for cls, name in ((tgsd._PyFile, "py.gsd"), (tgsd._NativeFile, "c.gsd")):
        f = cls(str(tmp_path / name), "metadyn_tpu_torch", "hoomd",
                (1 << 16) | 4)
        f.write_chunk("configuration/step", np.asarray([7], np.uint64))
        f.write_chunk("particles/position", pos)
        f.end_frame()
        f.write_chunk("configuration/step", np.asarray([9], np.uint64))
        f.end_frame()
        f.close()
    doc = tgsd.read_gsd(str(tmp_path / "py.gsd"))
    assert doc["gsd_version"] == (1 << 16)
    assert len(doc["frames"]) == 2
    np.testing.assert_allclose(doc["frames"][0]["particles/position"], pos)
    assert doc["frames"][1]["configuration/step"][0] == 9
    assert ((tmp_path / "py.gsd").read_bytes()
            == (tmp_path / "c.gsd").read_bytes())


def test_native_build_failure_names_its_log(tmp_path, monkeypatch):
    """No quiet fallback to Python: a core that does not compile raises,
    naming its log."""
    from metadyn_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "_build")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="libbroken.log"):
        _build.load("broken")


# --- the CLI -------------------------------------------------------------

def _c1(tmp_path, traj: str, n_steps: int, **out) -> str:
    cfg = shrunk("config1_lj_lamellar", tmp_path,
                 system={"init": {"n_cells": 4}},
                 run={"n_steps": n_steps, "report_every": 25})
    cfg["output"].update(trajectory=str(tmp_path / traj), **out)
    return write_cfg(cfg, tmp_path / f"{traj}.json")


@pytest.fixture(scope="module")
def c1_runs(tmp_path_factory):
    """Config 1's runs: straight to .gsd and to npz, and in two legs of 25
    steps (the second ``--resume``) to .gsd."""
    d = tmp_path_factory.mktemp("c1")
    with torch_threads():
        for traj in ("straight.gsd", "straight.npz"):
            assert cli.main(["run", _c1(d, traj, 50), "--device",
                             "cpu"]) == 0
        (d / "legs").mkdir()
        legs = _c1(d / "legs", "legs.gsd", 25,
                   checkpoint=str(d / "legs" / "ckpt.npz"))
        assert cli.main(["run", legs, "--device", "cpu"]) == 0
        assert cli.main(["run", legs, "--device", "cpu", "--resume"]) == 0
    return d


def test_cli_gsd_frames_equal_npz_frames(c1_runs):
    frames = tgsd.read_gsd_frames(str(c1_runs / "straight.gsd"))
    npz = read_trajectory(str(c1_runs / "straight.npz"))
    assert len(frames) == npz["step"].shape[0] == 2
    for i, fr in enumerate(frames):
        assert np.array_equal(fr["particles/position"], npz["pos"][i])
        assert np.array_equal(fr["particles/image"], npz["image"][i])
        assert int(fr["configuration/step"][0]) == int(npz["step"][i])
        np.testing.assert_array_equal(fr["configuration/box"][:3],
                                      npz["box_L"][i])
    assert [int(f["configuration/step"][0]) for f in frames] == [25, 50]
    assert jgsd.read_gsd(str(c1_runs / "straight.gsd"))["application"] \
        == "metadyn_tpu_torch"


def test_cli_gsd_resume_leg_holds_the_straight_frames(c1_runs, tmp_path):
    """The two legs' file is the straight run's frames to the bit, each
    frame's step the leg's own count, as the reference's CLI writes it
    (metadyn_tpu/cli.py:817-857: ``done`` counts from 0 in every leg): the
    straight run's frames written again with the steps (25, 25) give the
    legs' file byte for byte."""
    straight = tgsd.read_gsd_frames(str(c1_runs / "straight.gsd"))
    legs = tgsd.read_gsd_frames(str(c1_runs / "legs" / "legs.gsd"))
    assert [int(f["configuration/step"][0]) for f in straight] == [25, 50]
    assert [int(f["configuration/step"][0]) for f in legs] == [25, 25]
    p = tmp_path / "expected.gsd"
    w = tgsd.GSDWriter(str(p))
    for fr in straight:
        w.append(fr["particles/position"], fr["particles/image"],
                 fr["configuration/box"][:3], step=25)
    w.close()
    assert p.read_bytes() == (c1_runs / "legs" / "legs.gsd").read_bytes()


def test_rdf_on_gsd_matches_reference(c1_runs, tmp_path):
    """``rdf`` on the port's .gsd in both CLIs (formerly refused)."""
    traj = str(c1_runs / "straight.gsd")
    ref, port = _both(lambda p: ["rdf", traj, "--out", p, "--bins", "40"],
                      tmp_path, "npz")
    np.testing.assert_allclose(port["g"], ref["g"], rtol=1e-6)
    np.testing.assert_allclose(port["r"], ref["r"], rtol=1e-6)
    assert np.isfinite(port["g"]).all() and port["g"].max() > 1.0
