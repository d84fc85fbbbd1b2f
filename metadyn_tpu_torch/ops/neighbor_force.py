"""Pair forces over a fixed neighbour list (counterpart of
``metadyn_tpu/ops/neighbor_force.py``).

The list is full (every pair on both rows), so the force is a gather and
a row reduction with no scatter; the energy and virial take a factor ½.
Coordinates stay separate components, each (N, K).  Padding entries get
r² = 1e30, which every kernel's cut-off masks.  Orthorhombic minimum image,
as the cell list.
"""
from __future__ import annotations

import torch

from ..core.box import Box
from .cell_list import NeighborList
from .pairs import PairForceResult, PairKernel, PairParams


def neighbor_pair_force(pos: torch.Tensor, types: torch.Tensor, box: Box,
                        nbr: NeighborList, kernel: PairKernel,
                        params: PairParams) -> PairForceResult:
    n = pos.shape[0]
    j = nbr.idx                                     # (N, K), padding n
    mask = j < n
    j_safe = torch.clamp(j, max=n)
    dx = []
    r2 = torch.zeros(j.shape, dtype=pos.dtype, device=pos.device)
    for d in range(3):
        comp_pad = torch.cat([pos[:, d], pos.new_zeros(1)])
        c = pos[:, d][:, None] - comp_pad[j_safe]
        L = box.L[d]
        c = c - L * torch.round(c / L)
        dx.append(c)
        r2 = r2 + c * c
    r2 = torch.where(mask, r2, 1e30)
    types_pad = torch.cat([types, types.new_zeros(1)])
    e, coef = kernel(r2, types[:, None], types_pad[j_safe], params)
    force = torch.stack([torch.sum(coef * c, dim=1) for c in dx], dim=1)
    w = torch.stack([torch.sum(torch.where(mask, coef * c * c, 0.0))
                     for c in dx])
    return PairForceResult(0.5 * torch.sum(e), force, 0.5 * w)
