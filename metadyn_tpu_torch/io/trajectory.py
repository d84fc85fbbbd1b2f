"""Trajectory writers (counterpart of ``metadyn_tpu/io/trajectory.py``):
npz frames and binary DCD, byte for byte the reference's files.

- npz (default): one file with stacked frames (positions, images, box,
  step); appending rewrites it atomically.
- ``.dcd``: the CHARMM/NAMD binary format (Fortran records, CHARMM version
  24 with the unit-cell flag), which VMD, MDAnalysis and mdtraj read.

``make_trajectory_writer`` picks by extension (``.gsd``: the HOOMD-schema
writer of ``io/gsd_file.py``); the writers share the
``append(pos, image, box_L, step)`` interface.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from .grid_file import atomic_savez

_KEYS = ("pos", "image", "box_L", "step")


class TrajectoryWriter:
    def __init__(self, path: str, overwrite: bool = True):
        self.path = path
        self._frames: list[dict] = []
        if overwrite and os.path.exists(path):
            os.unlink(path)
        elif os.path.exists(path):
            old = read_trajectory(path)
            self._frames = [{k: old[k][i] for k in _KEYS}
                            for i in range(old["step"].shape[0])]

    def append(self, pos, image, box_L, step: int) -> None:
        self._frames.append({
            "pos": np.asarray(pos, np.float32),
            "image": np.asarray(image, np.int32),
            "box_L": np.asarray(box_L, np.float32),
            "step": np.int64(step),
        })
        atomic_savez(self.path, {k: np.stack([f[k] for f in self._frames])
                                 for k in _KEYS}, np.savez_compressed)


def read_trajectory(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _rec(payload: bytes) -> bytes:
    """One Fortran unformatted record: i32 length, payload, i32 length."""
    n = struct.pack("<i", len(payload))
    return n + payload + n


class DCDWriter:
    """CHARMM-format binary DCD (little-endian, 32-bit Fortran records).

    Header: 'CORD' and the 20-int icntrl block (the frame count patched in
    place on every append, unit-cell flag set, CHARMM version 24), a title
    record, and the atom count.  Each frame: the XTLABC unit-cell record
    (6 f64: [A, cos γ, B, cos β, cos α, C], the cosines 0) and one f32
    record per coordinate axis."""

    _NSET_OFF = 8          # byte offset of NSET (icntrl[0]) inside the file
    _NSTEP_OFF = 20        # byte offset of NSTEP (icntrl[3])

    def __init__(self, path: str, overwrite: bool = True):
        self.path = path
        self.n_atoms: int | None = None
        self._n_frames = 0
        if not overwrite and os.path.exists(path):
            with open(path, "rb") as f:
                hdr = f.read(12)
            if hdr[4:8] != b"CORD":
                raise ValueError(f"{path} is not a DCD file")
            self._n_frames = struct.unpack("<i", hdr[8:12])[0]
            self.n_atoms = read_dcd(path)["pos"].shape[1]
            self._f = open(path, "r+b")
            self._f.seek(0, os.SEEK_END)
        else:
            self._f = open(path, "w+b")

    def _write_header(self, n_atoms: int, step: int) -> None:
        icntrl = [0] * 20
        icntrl[1] = step           # ISTART
        icntrl[2] = 1              # NSAVC (frames are report-spaced)
        icntrl[10] = 1             # unit-cell present
        icntrl[19] = 24            # CHARMM version
        self._f.write(_rec(b"CORD" + struct.pack("<20i", *icntrl)))
        # the reference's title, so the two packages' files are the same
        title = b"Created by metadyn_tpu".ljust(80)[:80]
        self._f.write(_rec(struct.pack("<i", 1) + title))
        self._f.write(_rec(struct.pack("<i", n_atoms)))

    def append(self, pos, image, box_L, step: int) -> None:
        pos = np.asarray(pos, np.float32)
        if self.n_atoms is None:
            self.n_atoms = pos.shape[0]
            self._write_header(pos.shape[0], int(step))
        if pos.shape[0] != self.n_atoms:
            raise ValueError(f"frame has {pos.shape[0]} atoms, the file "
                             f"{self.n_atoms}")
        L = np.asarray(box_L, np.float64).reshape(-1)
        xtlabc = np.array([L[0], 0.0, L[1], 0.0, 0.0, L[2]], np.float64)
        self._f.write(_rec(xtlabc.tobytes()))
        for ax in range(3):
            self._f.write(_rec(np.ascontiguousarray(pos[:, ax]).tobytes()))
        self._n_frames += 1
        end = self._f.tell()
        self._f.seek(self._NSET_OFF)
        self._f.write(struct.pack("<i", self._n_frames))
        self._f.seek(self._NSTEP_OFF)
        self._f.write(struct.pack("<i", int(step)))
        self._f.seek(end)
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_dcd(path: str) -> dict:
    """Frames and boxes of a DCD file."""
    with open(path, "rb") as f:
        raw = f.read()
    off = 0

    def rec():
        nonlocal off
        (n,) = struct.unpack_from("<i", raw, off)
        payload = raw[off + 4:off + 4 + n]
        (n2,) = struct.unpack_from("<i", raw, off + 4 + n)
        if n != n2:
            raise ValueError(f"{path}: corrupt Fortran record")
        off += 8 + n
        return payload

    hdr = rec()
    if hdr[:4] != b"CORD":
        raise ValueError(f"{path} is not a DCD file")
    icntrl = struct.unpack("<20i", hdr[4:84])
    nset, istart = icntrl[0], icntrl[1]
    rec()                                   # titles
    (n_atoms,) = struct.unpack("<i", rec())
    frames, boxes = [], []
    for _ in range(nset):
        xtl = np.frombuffer(rec(), np.float64)
        boxes.append([xtl[0], xtl[2], xtl[5]])
        xyz = [np.frombuffer(rec(), np.float32) for _ in range(3)]
        frames.append(np.stack(xyz, axis=1))
    return {
        "pos": np.stack(frames) if frames else np.zeros((0, n_atoms, 3)),
        "box_L": np.asarray(boxes, np.float64),
        "istart": np.int64(istart),
        "n_frames": np.int64(nset),
    }


def make_trajectory_writer(path: str, overwrite: bool = True):
    """``.dcd`` → DCDWriter, ``.gsd`` → GSDWriter, else npz."""
    if path.endswith(".gsd"):
        from .gsd_file import GSDWriter
        return GSDWriter(path, overwrite=overwrite)
    if path.endswith(".dcd"):
        return DCDWriter(path, overwrite=overwrite)
    return TrajectoryWriter(path, overwrite=overwrite)
