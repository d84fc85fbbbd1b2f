"""Hill log file, PLUMED's column format (counterpart of
``metadyn_tpu/io/hill_log.py``: the same header and rows, byte for byte).

One row per hill: the step, the centre s⃗, the widths σ⃗ and the height W',
each number as ``%.8g``, under a ``#! FIELDS`` header.  The samplers hand
:meth:`HillLog.append` the records of a block of strides already on the
host.  :func:`fes_from_hills` and :func:`fes_error_from_hills` sum the
hills back into a free-energy surface offline (PLUMED ``sum_hills``).
"""
from __future__ import annotations

import os

import numpy as np


class HillLog:
    def __init__(self, path: str, sampler, overwrite: bool = False):
        """``sampler`` gives the widths (``grid_spec.sigma``, or in
        hill-list mode the buffer's ``bias.sigma``) and the CV names
        (``cvs[i].log_name``)."""
        self.path = path
        sigma = (sampler.grid_spec.sigma if sampler.grid_spec is not None
                 else sampler.bias.sigma)
        self._sigma = np.asarray(sigma.cpu())
        names = [cv.log_name for cv in sampler.cvs]
        if overwrite or not os.path.exists(path):
            with open(path, "w") as f:
                cols = (["step"] + names + [f"sigma_{n}" for n in names]
                        + ["height"])
                f.write("#! FIELDS " + " ".join(cols) + "\n")

    def append(self, recs) -> None:
        """recs: stacked hill records on the host (``.step`` (n,),
        ``.center`` (n, d), ``.height`` (n,))."""
        step = np.atleast_1d(np.asarray(recs.step))
        center = np.atleast_2d(np.asarray(recs.center))
        height = np.atleast_1d(np.asarray(recs.height))
        sigma = self._sigma
        with open(self.path, "a") as f:
            for i in range(step.shape[0]):
                row = [f"{int(step[i])}"]
                row += [f"{x:.8g}" for x in center[i]]
                row += [f"{x:.8g}" for x in sigma]
                row += [f"{height[i]:.8g}"]
                f.write(" ".join(row) + "\n")


def read_hills(path: str) -> dict[str, np.ndarray]:
    """A hill file back as arrays: steps, centres, widths, heights."""
    with open(path) as f:
        header = f.readline().strip()
        if not header.startswith("#! FIELDS"):
            raise ValueError(f"{path}: no '#! FIELDS' header")
        names = header.split()[2:]
        data = np.atleast_2d(np.loadtxt(f, ndmin=2))
    d = (len(names) - 2) // 2
    if data.size == 0:
        data = np.zeros((0, len(names)))
    return {
        "step": data[:, 0].astype(np.int64),
        "center": data[:, 1:1 + d],
        "sigma": data[:, 1 + d:1 + 2 * d],
        "height": data[:, -1],
        "cv_names": names[1:1 + d],
    }


def _sum_hills(V, mesh, centers, sigmas, heights) -> None:
    for c, sig, w in zip(centers, sigmas, heights):
        expo = sum(((m - ci) / si) ** 2 for m, ci, si in zip(mesh, c, sig))
        V += w * np.exp(-0.5 * expo)


def _scale(mode: str, kT: float, deltaT: float) -> float:
    return -1.0 if mode == "standard" else -(kT + deltaT) / deltaT


def fes_from_hills(path: str, grid_coords: list, mode: str = "standard",
                   kT: float = 1.0, deltaT: float = 1.0) -> np.ndarray:
    """FES on the grid ``grid_coords`` by direct hill summation, shifted to
    min 0: F = −V (standard) or −(kT + ΔT)/ΔT · V (well-tempered)."""
    h = read_hills(path)
    mesh = np.meshgrid(*grid_coords, indexing="ij")
    V = np.zeros(mesh[0].shape)
    _sum_hills(V, mesh, h["center"], h["sigma"], h["height"])
    F = _scale(mode, kT, deltaT) * V
    return F - F.min()


def fes_error_from_hills(path: str, grid_coords: list, n_blocks: int = 4,
                         mode: str = "standard", kT: float = 1.0,
                         deltaT: float = 1.0) -> tuple:
    """Time-block FES convergence estimate: the cumulative FES at
    ``n_blocks`` points in hill time, each aligned to mean 0, and the
    per-node standard deviation across them.  Returns ``(F, err)``: the
    full run's FES (min 0) and that deviation."""
    h = read_hills(path)
    n = h["step"].size
    if not n >= n_blocks >= 2:
        raise ValueError(f"need n_hills >= n_blocks >= 2, got {n}, "
                         f"{n_blocks}")
    mesh = np.meshgrid(*grid_coords, indexing="ij")
    scale = _scale(mode, kT, deltaT)
    bounds = [int(round(n * (k + 1) / n_blocks)) for k in range(n_blocks)]
    V = np.zeros(mesh[0].shape)
    snaps, i0 = [], 0
    for b in bounds:
        _sum_hills(V, mesh, h["center"][i0:b], h["sigma"][i0:b],
                   h["height"][i0:b])
        i0 = b
        Fk = scale * V
        snaps.append(Fk - Fk.mean())
    err = np.std(np.stack(snaps), axis=0, ddof=1)
    F = scale * V
    return F - F.min(), err
