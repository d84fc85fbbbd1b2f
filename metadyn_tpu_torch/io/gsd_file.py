"""GSD trajectories (counterpart of ``metadyn_tpu/io/gsd_file.py``): a
writer with a native C++ core and a pure-Python reader.

- :class:`GSDWriter` writes HOOMD-schema (``schema="hoomd"``, 1.4) frames
  in the GSD v1 file layout, which every release of the ``gsd`` reader
  reads, through the native core ``csrc/gsd.cpp`` (ctypes-bound), or
  through :class:`_PyFile`, which writes the same bytes in Python, when
  ``METADYN_NO_NATIVE=1`` is set: the way to write GSD on a host without
  a C++ compiler, since a failed build raises.  The Python core packs
  the whole index again after every frame, so a long trajectory costs it
  many times the native core's time (``scripts/gsd_write_bench.py``).
  ``writer.native`` says which ran.
- :func:`read_gsd` reads the v1 and the v2 layout with ``struct`` alone,
  so files written elsewhere can be read; :func:`read_gsd_frames` applies
  the schema's frame-0 inheritance.

Writer and reader are separate implementations of the public spec
(gsd.readthedocs.io, file layout), so a round trip checks both.  The files
are the reference's byte for byte but for the header's 64-byte
``application`` field, which names this package.

The core compiles at first use (``ops/_build.py``: ``g++ -O2 -shared
-fPIC -std=c++17`` into ``_build/libgsd.so``, about a second).  A failed
build raises and names its log: there is no quiet fallback to Python.
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from ..ops import _build

NATIVE = "gsd"
APPLICATION = "metadyn_tpu_torch"

_HEADER = struct.Struct("<QQQQQII64s64s80s")
_ENTRY = struct.Struct("<QQqIHBB")
_MAGIC = 0x65DF65DF65DF65DF

# gsd type codes
_T_UINT8, _T_UINT16, _T_UINT32, _T_UINT64 = 1, 2, 3, 4
_T_INT8, _T_INT16, _T_INT32, _T_INT64 = 5, 6, 7, 8
_T_FLOAT, _T_DOUBLE = 9, 10
_DTYPES = {
    _T_UINT8: np.uint8, _T_UINT16: np.uint16, _T_UINT32: np.uint32,
    _T_UINT64: np.uint64, _T_INT8: np.int8, _T_INT16: np.int16,
    _T_INT32: np.int32, _T_INT64: np.int64, _T_FLOAT: np.float32,
    _T_DOUBLE: np.float64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _lib():
    """The native core, built at first use, or None under
    ``METADYN_NO_NATIVE=1``.  Raises RuntimeError, naming the build log,
    when the core does not compile."""
    if os.environ.get("METADYN_NO_NATIVE"):
        return None
    lib = _build.load(NATIVE)
    if lib.metadyn_gsd_create.argtypes is None:
        lib.metadyn_gsd_create.restype = ctypes.c_void_p
        lib.metadyn_gsd_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint32]
        lib.metadyn_gsd_write_chunk.restype = ctypes.c_int
        lib.metadyn_gsd_write_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint8,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p]
        lib.metadyn_gsd_end_frame.restype = ctypes.c_int
        lib.metadyn_gsd_end_frame.argtypes = [ctypes.c_void_p]
        lib.metadyn_gsd_nframes.restype = ctypes.c_uint64
        lib.metadyn_gsd_nframes.argtypes = [ctypes.c_void_p]
        lib.metadyn_gsd_close.restype = ctypes.c_int
        lib.metadyn_gsd_close.argtypes = [ctypes.c_void_p]
    return lib


def _chunk_shape(arr: np.ndarray) -> tuple:
    """(code, N, M) of a chunk: at most 2-d, a dtype of the gsd types."""
    if arr.ndim > 2:
        raise ValueError(f"gsd chunks are at most 2-d, got {arr.shape}")
    code = _CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"gsd has no type for {arr.dtype}")
    n = arr.shape[0] if arr.ndim else 1
    m = arr.shape[1] if arr.ndim == 2 else 1
    return code, n, m


class _NativeFile:
    """A gsd file written by the C++ core; closed by :meth:`close`."""

    def __init__(self, path, application, schema, schema_version):
        lib = _lib()
        if lib is None:
            raise RuntimeError("the native gsd core is switched off "
                               "(METADYN_NO_NATIVE)")
        self._lib = lib
        self._h = lib.metadyn_gsd_create(
            path.encode(), application.encode(), schema.encode(),
            schema_version)
        if not self._h:
            raise OSError(f"cannot create gsd file {path!r}")

    def write_chunk(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        code, n, m = _chunk_shape(arr)
        rc = self._lib.metadyn_gsd_write_chunk(
            self._h, name.encode(), code, n, m,
            arr.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"gsd chunk write failed: {name}")

    def end_frame(self) -> None:
        if self._lib.metadyn_gsd_end_frame(self._h) != 0:
            raise OSError("gsd end_frame failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.metadyn_gsd_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("gsd close failed")


class _PyFile:
    """The same v1 layout written in Python (``METADYN_NO_NATIVE=1``),
    byte for byte the native core's file."""

    def __init__(self, path, application, schema, schema_version):
        self._f = open(path, "wb+")
        self._names: list[str] = []
        self._index: list[tuple] = []
        self._frame = 0
        self._app = application
        self._schema = schema
        self._sver = schema_version
        self._data_end = 256
        self._f.write(b"\0" * 256)
        self._flush()

    def _name_id(self, name: str) -> int:
        if name in self._names:
            return self._names.index(name)
        if len(name.encode()) >= 64:
            raise ValueError(f"gsd chunk names are < 64 bytes: {name!r}")
        self._names.append(name)
        return len(self._names) - 1

    def write_chunk(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        code, n, m = _chunk_shape(arr)
        self._f.seek(self._data_end)
        raw = arr.tobytes()
        self._f.write(raw)
        self._index.append(
            (self._frame, n, self._data_end, m, self._name_id(name), code, 0))
        self._data_end += len(raw)

    def end_frame(self) -> None:
        self._frame += 1
        self._flush()

    def _flush(self) -> None:
        f = self._f
        index_loc = self._data_end
        f.seek(index_loc)
        for e in self._index:
            f.write(_ENTRY.pack(*e))
        f.write(b"\0" * _ENTRY.size)
        namelist_loc = index_loc + (len(self._index) + 1) * _ENTRY.size
        for nm in self._names:
            f.write(nm.encode().ljust(64, b"\0"))
        f.write(b"\0" * 64)
        f.seek(0)
        f.write(_HEADER.pack(
            _MAGIC, index_loc, len(self._index) + 1, namelist_loc,
            len(self._names) + 1, self._sver, (1 << 16) | 0,
            self._app.encode(), self._schema.encode(), b""))
        f.flush()

    def close(self) -> None:
        if self._f:
            self._flush()
            self._f.close()
            self._f = None


class GSDWriter:
    """HOOMD-schema GSD trajectory writer (``make_trajectory_writer`` picks
    it for ``.gsd``), with the npz and DCD writers' ``append``.

    Frame 0 carries the full configuration (step, dimensions, box, N,
    typeid, types, position, image); later frames step, box, position and
    image, and readers take the rest from frame 0 (the schema's
    inheritance).  With ``overwrite=False`` an existing file's frames are
    read and written again into a new file, which then goes on (the npz
    writer's resume).  ``native`` is True when the C++ core writes."""

    #: HOOMD schema version written ((major << 16) | minor)
    SCHEMA_VERSION = (1 << 16) | 4

    def __init__(self, path: str, overwrite: bool = True,
                 types: list[str] | None = None):
        old_frames = None
        if not overwrite and os.path.exists(path):
            old_frames = read_gsd(path)["frames"]
        self.native = _lib() is not None
        cls = _NativeFile if self.native else _PyFile
        self._file = cls(path, APPLICATION, "hoomd", self.SCHEMA_VERSION)
        self._types = list(types) if types else ["A"]
        self._first = True
        if old_frames:
            for fr in old_frames:
                for name, arr in fr.items():
                    self._file.write_chunk(name, arr)
                self._file.end_frame()
            self._first = False

    def append(self, pos, image, box_L, step: int,
               typeid=None, velocity=None) -> None:
        pos = np.asarray(pos, np.float32)
        n = pos.shape[0]
        f = self._file
        f.write_chunk("configuration/step", np.asarray([step], np.uint64))
        box = np.zeros(6, np.float32)
        box[:3] = np.asarray(box_L, np.float32)
        f.write_chunk("configuration/box", box)
        if self._first:
            f.write_chunk("configuration/dimensions",
                          np.asarray([3], np.uint8))
            f.write_chunk("particles/N", np.asarray([n], np.uint32))
            tid = (np.zeros(n, np.uint32) if typeid is None
                   else np.asarray(typeid, np.uint32))
            f.write_chunk("particles/typeid", tid)
            w = max(len(t) for t in self._types) + 1
            tarr = np.zeros((len(self._types), w), np.int8)
            for i, t in enumerate(self._types):
                b = t.encode()
                tarr[i, :len(b)] = np.frombuffer(b, np.int8)
            f.write_chunk("particles/types", tarr)
        f.write_chunk("particles/position", pos.reshape(n, 3))
        f.write_chunk("particles/image",
                      np.asarray(image, np.int32).reshape(n, 3))
        if velocity is not None:
            f.write_chunk("particles/velocity",
                          np.asarray(velocity, np.float32).reshape(n, 3))
        f.end_frame()
        self._first = False

    def close(self) -> None:
        self._file.close()


def _read_names(data: bytes, version_major: int) -> list[str]:
    if version_major >= 2:
        # v2: densely packed NUL-terminated strings
        return [s.decode() for s in data.split(b"\0") if s]
    names = []
    for off in range(0, len(data), 64):
        nm = data[off:off + 64].split(b"\0", 1)[0]
        if not nm:
            break
        names.append(nm.decode())
    return names


def read_gsd(path: str) -> dict:
    """A GSD file (v1 or v2 layout) as ``{"application", "schema",
    "schema_version", "gsd_version", "frames": [dict, ...]}``, each frame
    chunk name -> ndarray, as stored: no frame-0 inheritance
    (:func:`read_gsd_frames` applies it)."""
    with open(path, "rb") as f:
        raw = f.read()
    (magic, index_loc, index_alloc, nm_loc, nm_alloc, schema_ver, gsd_ver,
     app, schema, _res) = _HEADER.unpack(raw[:_HEADER.size])
    if magic != _MAGIC:
        raise OSError(f"{path}: not a GSD file (bad magic)")
    vmaj = gsd_ver >> 16
    entries = []
    for i in range(index_alloc):
        off = index_loc + i * _ENTRY.size
        e = _ENTRY.unpack(raw[off:off + _ENTRY.size])
        if e[2] == 0:  # location 0 ends the valid entries
            break
        entries.append(e)
    names = _read_names(raw[nm_loc:nm_loc + nm_alloc * 64], vmaj)
    n_frames = max((e[0] for e in entries), default=-1) + 1
    frames: list[dict] = [dict() for _ in range(int(n_frames))]
    for frame, n, loc, m, nid, typ, _flags in entries:
        dt = np.dtype(_DTYPES[typ])
        nb = int(n) * int(m) * dt.itemsize
        arr = np.frombuffer(raw[loc:loc + nb], dt).reshape(int(n), int(m))
        if m == 1:
            arr = arr[:, 0]
        frames[int(frame)][names[nid]] = arr
    return {
        "application": app.split(b"\0", 1)[0].decode(),
        "schema": schema.split(b"\0", 1)[0].decode(),
        "schema_version": schema_ver,
        "gsd_version": gsd_ver,
        "frames": frames,
    }


def read_gsd_frames(path: str) -> list[dict]:
    """Frames with the HOOMD schema's inheritance: a chunk that frame i > 0
    omits takes its frame-0 value."""
    frames = read_gsd(path)["frames"]
    if not frames:
        return frames
    base = frames[0]
    return [{**base, **fr} for fr in frames]


def gsd_types(frame: dict) -> list[str]:
    """The ``particles/types`` int8 matrix as type names."""
    tarr = np.asarray(frame["particles/types"], np.int8)
    return [bytes(row.tobytes()).split(b"\0", 1)[0].decode()
            for row in tarr]
