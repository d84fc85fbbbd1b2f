"""Bias-grid dump and restart files (counterpart of
``metadyn_tpu/io/grid_file.py``).

The same npz keys in the same layout (``lo``, ``hi``, ``sigma`` f32,
``shape`` i64, ``periodic`` bool, ``V``, ``dV`` f32, ``n_hills`` i32,
``mode`` str, ``deltaT`` f32), written atomically (temp + rename), so each
package reads the other's dumps.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..bias.grid import BiasGrid, GridSpec
from ..bias.metad import BiasState


def atomic_savez(path: str, payload: dict, savez=np.savez) -> None:
    """``savez`` into a temp file beside ``path``, then rename: a crash
    never leaves a torn file."""
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def dump_grid(path: str, bias: BiasState, mode: str = "standard",
              deltaT: float = 1.0) -> None:
    spec = bias.grid.spec
    atomic_savez(path, dict(
        lo=spec.lo.cpu().numpy(), hi=spec.hi.cpu().numpy(),
        sigma=spec.sigma.cpu().numpy(),
        shape=np.asarray(spec.shape, np.int64),
        periodic=np.asarray(spec.periodic, bool),
        V=bias.grid.V.cpu().numpy(), dV=bias.grid.dV.cpu().numpy(),
        n_hills=np.asarray(bias.n_hills, np.int32),
        mode=np.asarray(mode), deltaT=np.asarray(deltaT, np.float32),
    ))


def load_grid(path: str, device="cpu") -> tuple:
    """A grid dump as (BiasState on ``device``, {"mode", "deltaT"})."""
    with np.load(path, allow_pickle=False) as z:
        def t(k):
            return torch.as_tensor(z[k], device=device)

        spec = GridSpec(lo=t("lo"), hi=t("hi"), sigma=t("sigma"),
                        shape=tuple(int(n) for n in z["shape"]),
                        periodic=tuple(bool(p) for p in z["periodic"]))
        bias = BiasState(grid=BiasGrid(spec=spec, V=t("V"), dV=t("dV")),
                         n_hills=int(z["n_hills"]))
        meta = {"mode": str(z["mode"]), "deltaT": float(z["deltaT"])}
    return bias, meta
