"""Cell list and fixed-capacity neighbour list on the particle-order state
(counterpart of ``metadyn_tpu/ops/cell_list.py``; HOOMD's ``CellList`` and
``NeighborList``).

1. **Binning by sort.**  Particles are argsorted (stably) by linear cell
   id; a particle's rank in its cell indexes a dense (n_cells, capacity)
   table.  A rank at or past the capacity goes to the table's drop slot,
   never into the next cell's range, and raises the overflow flag.
2. **27 neighbour cells per particle** give (N, 27·capacity) candidates;
   a minimum-image distance filter within r_cut + skin, minus the particle
   itself and its exclusions, leaves the valid ones.
3. **Compaction by cumsum and scatter** into a fixed (N, max_neighbors)
   full list (each pair listed from both sides).  Every entry past a
   row's capacity or not valid goes to the drop region behind the list,
   which is sliced away; those are the only duplicate scatter indices.
   The region has one slot per candidate column modulo its size, so the
   dropped entries do not all land on one address.

The wide (N, 27·capacity) intermediates stay int32 where the reference's
are (the candidate ids, the cumsum, the scatter targets); at 62,500
particles and capacity 69 they hold ~116M entries each.  Orthorhombic
boxes only, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import Box, minimum_image

# size of the drop region behind the compacted list (see the docstring)
DROP_SLOTS = 1 << 16


@dataclass(frozen=True)
class CellSpec:
    """Static geometry of the cell decomposition."""

    cells_per_dim: tuple
    cell_capacity: int
    max_neighbors: int
    r_cut: float
    skin: float

    @property
    def n_cells(self) -> int:
        cx, cy, cz = self.cells_per_dim
        return cx * cy * cz

    @property
    def r_list(self) -> float:
        return self.r_cut + self.skin

    @classmethod
    def create(cls, box_L, n_particles: int, r_cut: float, skin: float = 0.4,
               cell_capacity: int | None = None,
               max_neighbors: int | None = None) -> "CellSpec":
        """The reference's sizing: at least 3 cells per axis (then the
        27-cell stencil spans the axis, so no neighbour is missed), a cell
        capacity of 3× the mean occupancy (at least 4), a list of 2× the
        mean count within r_cut + skin (at least 8), rounded up to 8."""
        L = np.asarray(box_L, np.float64).reshape(-1)
        if L.size == 1:
            L = np.repeat(L, 3)
        r_list = r_cut + skin
        cpd = tuple(max(3, int(np.floor(l / r_list))) for l in L)
        n_cells = int(np.prod(cpd))
        density = n_particles / float(np.prod(L))
        cell_vol = float(np.prod(L)) / n_cells
        if cell_capacity is None:
            cell_capacity = max(4, int(np.ceil(density * cell_vol * 3.0)))
        if max_neighbors is None:
            mean_nbrs = density * 4.0 / 3.0 * np.pi * r_list ** 3
            max_neighbors = max(8, int(np.ceil(mean_nbrs * 2.0)))
        max_neighbors = ((max_neighbors + 7) // 8) * 8
        return cls(cells_per_dim=cpd, cell_capacity=cell_capacity,
                   max_neighbors=max_neighbors, r_cut=r_cut, skin=skin)


@dataclass(frozen=True)
class NeighborList:
    """Fixed-shape full neighbour list and its rebuild bookkeeping."""

    idx: torch.Tensor      # (N, max_neighbors) i32; N marks padding
    ref_pos: torch.Tensor  # (N, 3) positions at build time
    overflow: torch.Tensor  # () bool: a cell or a row over capacity
    spec: CellSpec


_OFFSETS = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], np.int32)


def _cell_coords(pos: torch.Tensor, box: Box, spec: CellSpec) -> torch.Tensor:
    if box.tilt is not None:
        raise ValueError("the particle-order cell list is orthorhombic "
                         "only: a tilted box runs on the all-pairs engine "
                         "or the packed engine")
    cpd = torch.as_tensor(spec.cells_per_dim, dtype=torch.int32,
                          device=pos.device)
    c = torch.floor((pos / box.L + 0.5) * cpd.to(pos.dtype)).to(torch.int32)
    return torch.minimum(torch.clamp(c, min=0), cpd - 1)


def _linear_id(c: torch.Tensor, spec: CellSpec) -> torch.Tensor:
    _, cy, cz = spec.cells_per_dim
    return (c[..., 0] * cy + c[..., 1]) * cz + c[..., 2]


def build_neighbor_list(pos: torch.Tensor, box: Box, spec: CellSpec,
                        exclusions: torch.Tensor | None = None
                        ) -> NeighborList:
    """The (N, max_neighbors) full list.  ``exclusions`` is an (N, E) int32
    table of particle ids to leave out (bonded pairs), N marking padding."""
    n = pos.shape[0]
    dev = pos.device
    cap = spec.cell_capacity
    my_cell = _cell_coords(pos, box, spec)                          # (N, 3)
    cid = _linear_id(my_cell, spec)                                 # (N,)
    order = torch.argsort(cid, stable=True).to(torch.int32)
    sorted_cid = cid[order]
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - torch.searchsorted(sorted_cid, sorted_cid, side="left",
                                 out_int32=True))
    cell_overflow = torch.any(rank >= cap)
    table_size = spec.n_cells * cap
    tbl_idx = torch.where(rank < cap, sorted_cid * cap + rank, table_size)
    table = torch.full((table_size + 1,), n, dtype=torch.int32, device=dev)
    table[tbl_idx] = order
    table = table[:table_size]

    cpd = torch.as_tensor(spec.cells_per_dim, dtype=torch.int32, device=dev)
    offsets = torch.as_tensor(_OFFSETS, device=dev)
    nbr_cells = torch.remainder(my_cell[:, None, :] + offsets[None], cpd)
    nbr_cid = _linear_id(nbr_cells, spec)                           # (N, 27)
    slot = torch.arange(cap, dtype=torch.int32, device=dev).repeat(27)
    cand = table[torch.repeat_interleave(nbr_cid, cap, dim=1) * cap
                 + slot[None, :]]                                   # (N, 27·cap)
    del nbr_cells, nbr_cid, slot

    # the distance filter, one component at a time, all (N, 27·cap)
    cand_safe = torch.clamp(cand, max=n)
    r2 = torch.zeros(cand.shape, dtype=pos.dtype, device=dev)
    for d in range(3):
        comp_pad = torch.cat([pos[:, d], pos.new_zeros(1)])
        dx = pos[:, d][:, None] - comp_pad[cand_safe]
        L = box.L[d]
        dx = dx - L * torch.round(dx / L)
        r2 += dx * dx
        del dx
    del cand_safe
    i_ids = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    ok = (r2 < spec.r_list ** 2) & (cand != n) & (cand != i_ids)
    del r2
    if exclusions is not None:
        for e in range(exclusions.shape[1]):
            ok &= cand != exclusions[:, e][:, None]
    k = spec.max_neighbors
    nbr_overflow = torch.any(torch.sum(ok, dim=1) > k)

    # compaction: the column of each valid candidate is the cumsum of the
    # valid mask; the rest go to the drop region behind the list
    col = torch.cumsum(ok, dim=1, dtype=torch.int32) - 1
    keep = ok & (col < k)
    spread = torch.remainder(
        torch.arange(cand.shape[1], dtype=torch.int32, device=dev),
        DROP_SLOTS)
    dest = torch.where(keep, i_ids * k + col, n * k + spread[None, :])
    del col, keep, ok
    idx = torch.full((n * k + DROP_SLOTS,), n, dtype=torch.int32, device=dev)
    idx[dest] = cand
    return NeighborList(idx=idx[:n * k].reshape(n, k), ref_pos=pos,
                        overflow=cell_overflow | nbr_overflow, spec=spec)


def needs_rebuild(nbr: NeighborList, pos: torch.Tensor,
                  box: Box) -> torch.Tensor:
    """HOOMD's half-skin trigger: a particle moved more than skin/2 since
    the build (a () bool tensor, no host read)."""
    d = minimum_image(pos - nbr.ref_pos, box)
    return torch.max(torch.sum(d * d, dim=-1)) > (0.5 * nbr.spec.skin) ** 2


def exclusions_from_bonds(bonds: np.ndarray, n: int, max_excl: int = 8,
                          device="cuda") -> torch.Tensor:
    """The (N, max_excl) int32 exclusion table of a bond list (HOOMD's 1-2
    exclusions), built on the host, N marking padding."""
    table = np.full((n, max_excl), n, np.int32)
    count = np.zeros(n, np.int32)
    for a, b in np.asarray(bonds):
        for x, y in ((a, b), (b, a)):
            if count[x] >= max_excl:
                raise ValueError(f"particle {x} exceeds max_excl={max_excl}")
            table[x, count[x]] = y
            count[x] += 1
    return torch.as_tensor(table, device=device)
