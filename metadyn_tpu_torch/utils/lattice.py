"""Initial particle configurations, host-side numpy (counterpart of
``metadyn_tpu/utils/lattice.py``; only the fcc lattice is ported)."""
from __future__ import annotations

import numpy as np


def fcc_lattice(n_cells: int, a: float) -> np.ndarray:
    """FCC lattice, 4·n_cells³ particles, lattice constant a, centred."""
    base = np.array(
        [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]], np.float32
    )
    cells = np.arange(n_cells)
    i, j, k = np.meshgrid(cells, cells, cells, indexing="ij")
    origins = np.stack([i.ravel(), j.ravel(), k.ravel()],
                       axis=1).astype(np.float32)
    pos = (origins[:, None, :] + base[None, :, :]).reshape(-1, 3) * a
    return (pos - pos.mean(axis=0)).astype(np.float32)
