"""Initial particle configurations, host-side numpy (counterpart of
``metadyn_tpu/utils/lattice.py``; the fcc lattice and the bead-spring melt
are ported, the simple-cubic lattice waits)."""
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


def polymer_melt(
    n_chains: int, chain_len: int, box_L: float, bond_len: float = 0.97,
    seed: int = 0, grid_starts: bool = False, persistence: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Random-walk bead-spring chains in a cubic box, the reference's
    builder draw for draw (same seed, same numbers).

    Returns (positions (n_chains·chain_len, 3) f32, bonds (B, 2) i32).
    Overlaps are expected: push them off with the soft pair before the
    production potential.  ``grid_starts`` puts the chain starts on a
    jittered lattice instead of uniformly at random, and ``persistence``
    (0..1) correlates successive bond directions; both cap the worst-case
    local density of the start."""
    rng = np.random.default_rng(seed)
    pos = np.empty((n_chains, chain_len, 3), np.float32)
    if grid_starts:
        g = int(np.ceil(n_chains ** (1 / 3)))
        pts = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)[:n_chains]
        jitter = rng.uniform(0.1, 0.9, (n_chains, 3))
        pos[:, 0] = ((pts + jitter) * (box_L / g) - box_L / 2).astype(
            np.float32)
    else:
        pos[:, 0] = rng.uniform(-box_L / 2, box_L / 2, (n_chains, 3))
    steps = rng.normal(size=(n_chains, chain_len - 1, 3))
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True)
    if persistence > 0.0:
        for i in range(1, chain_len - 1):
            s = (persistence * steps[:, i - 1]
                 + (1.0 - persistence) * steps[:, i])
            steps[:, i] = s / np.linalg.norm(s, axis=-1, keepdims=True)
    pos[:, 1:] = pos[:, :1] + np.cumsum(steps * bond_len, axis=1)
    idx = np.arange(n_chains * chain_len).reshape(n_chains, chain_len)
    bonds = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    return pos.reshape(-1, 3), bonds.astype(np.int32)
