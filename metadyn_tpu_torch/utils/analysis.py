"""Offline trajectory analysis: the radial distribution function
(counterpart of ``metadyn_tpu/utils/analysis.py``, numpy on the host: the
analysis reads dumped frames once, it is no device loop)."""
from __future__ import annotations

import numpy as np


def rdf(pos, box_L, r_max: float | None = None, n_bins: int = 100,
        chunk: int = 256) -> tuple:
    """g(r) of one or more frames.

    ``pos``: (N, 3) or (F, N, 3) positions, wrapped or not; ``box_L``:
    (3,) orthorhombic lengths for every frame, or (F, 3) per frame;
    ``r_max``: the histogram's range, at most (and by default) min(L)/2,
    the minimum-image bound.  Returns ``(r, g)`` with ``r`` the bin
    centres."""
    pos = np.asarray(pos, np.float64)
    if pos.ndim == 2:
        pos = pos[None]
    F, N, _ = pos.shape
    box_L = np.asarray(box_L, np.float64)
    if box_L.size not in (3, 3 * F):
        raise ValueError(f"box_L shape {box_L.shape} != (3,) or (F, 3)")
    boxes = np.broadcast_to(box_L.reshape(-1, 3), (F, 3))
    Lmin = boxes.min()
    if r_max is None:
        r_max = 0.5 * Lmin
    if r_max > 0.5 * Lmin + 1e-9:
        raise ValueError(f"r_max {r_max} exceeds the minimum-image bound "
                         f"{0.5 * Lmin}")

    edges = np.linspace(0.0, r_max, n_bins + 1)
    hist = np.zeros(n_bins, np.float64)
    norm = 0.0
    for f in range(F):
        p, L = pos[f], boxes[f]
        p = p - L * np.floor(p / L)          # wrap (takes unwrapped input)
        for i0 in range(0, N, chunk):
            d = p[i0:i0 + chunk, None, :] - p[None, :, :]
            d -= L * np.round(d / L)          # minimum image
            r = np.sqrt(np.einsum("ijk,ijk->ij", d, d))
            rr = r[(r > 1e-9) & (r < r_max)]  # ordered pairs, self excluded
            hist += np.histogram(rr, bins=edges)[0]
        # ideal-gas ordered-pair count for this frame's density
        rho = N / L.prod()
        norm += N * rho
    shell = (4.0 / 3.0) * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    g = hist / (norm * shell)
    return 0.5 * (edges[1:] + edges[:-1]), g
