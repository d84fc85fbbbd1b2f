"""Bonded forces on the particle-order state: harmonic and FENE + WCA
bead-spring bonds (counterpart of ``metadyn_tpu/ops/bonds.py``; HOOMD's
``PotentialBondHarmonic`` and ``PotentialBondFENE``).

Gather, compute, scatter-add over the static (B, 2) bond table.  The
scatter is ``index_put_`` with ``accumulate=True``, which on a GPU sorts
the indices and sums each particle's bonds without atomics.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.box import Box, minimum_image
from .pairs import PairForceResult


@dataclass(frozen=True)
class HarmonicBondParams:
    k: torch.Tensor   # (n_bond_types,) spring constant
    r0: torch.Tensor  # (n_bond_types,) rest length


@dataclass(frozen=True)
class FENEBondParams:
    k: torch.Tensor        # (n_bond_types,)
    r0: torch.Tensor       # (n_bond_types,) maximum extension
    epsilon: torch.Tensor  # (n_bond_types,) WCA ε of the bonded pair
    sigma: torch.Tensor    # (n_bond_types,)


def _no_bonds(pos: torch.Tensor) -> PairForceResult:
    return PairForceResult(pos.new_zeros(()), torch.zeros_like(pos),
                           pos.new_zeros(3))


def _scatter_pairs(pos, i, j, f_pair, e, dr) -> PairForceResult:
    force = torch.zeros_like(pos)
    force.index_put_((i,), f_pair, accumulate=True)
    force.index_put_((j,), -f_pair, accumulate=True)
    return PairForceResult(torch.sum(e), force, torch.sum(f_pair * dr, dim=0))


def harmonic_bond_force(pos: torch.Tensor, bonds: torch.Tensor,
                        bond_types: torch.Tensor, box: Box,
                        params: HarmonicBondParams) -> PairForceResult:
    """u = ½ k (r − r0)² over the bond table."""
    if bonds.shape[0] == 0:
        return _no_bonds(pos)
    i, j = bonds[:, 0].long(), bonds[:, 1].long()
    dr = minimum_image(pos[i] - pos[j], box)
    r = torch.sqrt(torch.sum(dr * dr, dim=-1))
    k = params.k[bond_types]
    r0 = params.r0[bond_types]
    e = 0.5 * k * (r - r0) ** 2
    coef = -k * (r - r0) / r
    return _scatter_pairs(pos, i, j, coef[:, None] * dr, e, dr)


def fene_bond_force(pos: torch.Tensor, bonds: torch.Tensor,
                    bond_types: torch.Tensor, box: Box,
                    params: FENEBondParams) -> PairForceResult:
    """FENE + WCA (Kremer–Grest): u = −½ k r0² ln(1 − (r/r0)²) + WCA(r),
    with (r/r0)² clamped at 0.99."""
    if bonds.shape[0] == 0:
        return _no_bonds(pos)
    i, j = bonds[:, 0].long(), bonds[:, 1].long()
    dr = minimum_image(pos[i] - pos[j], box)
    r2 = torch.sum(dr * dr, dim=-1)
    k = params.k[bond_types]
    r0 = params.r0[bond_types]
    eps = params.epsilon[bond_types]
    sig = params.sigma[bond_types]
    x = torch.clamp(r2 / (r0 * r0), max=0.99)
    e_fene = -0.5 * k * r0 * r0 * torch.log1p(-x)
    coef_fene = -k / (1.0 - x)
    rc2 = (2.0 ** (1.0 / 3.0)) * sig * sig
    inside = r2 < rc2
    r2s = torch.where(inside, r2, 1.0)
    s2 = sig * sig / r2s
    s6 = s2 * s2 * s2
    e_wca = torch.where(inside, 4.0 * eps * (s6 * s6 - s6) + eps, 0.0)
    coef_wca = torch.where(
        inside, 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s, 0.0)
    return _scatter_pairs(pos, i, j, (coef_fene + coef_wca)[:, None] * dr,
                          e_fene + e_wca, dr)
