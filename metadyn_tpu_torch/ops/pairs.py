"""Pair potentials and the row-blocked all-pairs force (counterpart of
``metadyn_tpu/ops/pairs.py``; HOOMD's ``PotentialPairLJ`` and friends).

A pair kernel maps ``(r2, ti, tj, params) -> (energy_ij, coef_ij)``, where
the pair force on i is ``coef · (r_i − r_j)`` with ``coef = −2 du/d(r²)``.
Parameters are (T, T) type-pair tables.  The kernels test the cut-off and
then substitute a safe r² *before* any division, so a masked lane (a self
pair at r = 0, a pair beyond the cut-off) stays finite and contributes no
NaN to a gradient taken through it.

:func:`all_pairs_force` streams row blocks over all N columns: memory
O(row_block · N), the correctness anchor for the neighbour-list engine and
the engine of Config 1.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..core.box import Box, minimum_image

PairKernel = Callable[..., tuple]


@dataclass(frozen=True)
class PairParams:
    """Type-pair coefficient tables, (T, T) f32 each."""

    epsilon: torch.Tensor
    sigma: torch.Tensor
    r_cut: torch.Tensor
    shift_const: torch.Tensor  # energy shift at r_cut (0 disables)
    r_on: Optional[torch.Tensor] = None  # XPLOR smoothing onset, or None

    def replace(self, **changes) -> "PairParams":
        return dataclasses.replace(self, **changes)


def _table(x, T: int, device) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=device),
        (T, T)).clone()


def lj_tables(n_types: int, epsilon=1.0, sigma=1.0, r_cut=2.5,
              shift: bool = True, device="cuda") -> PairParams:
    """LJ tables: scalars broadcast to every type pair, or (T, T) arrays."""
    T = n_types
    eps, sig, rc = (_table(x, T, device) for x in (epsilon, sigma, r_cut))
    if shift:
        sr6 = (sig / rc) ** 6
        shift_c = 4.0 * eps * (sr6 * sr6 - sr6)
    else:
        shift_c = torch.zeros((T, T), dtype=torch.float32, device=device)
    return PairParams(epsilon=eps, sigma=sig, r_cut=rc, shift_const=shift_c)


def xplor_tables(n_types: int, epsilon=1.0, sigma=1.0, r_cut=2.5, r_on=2.0,
                 device="cuda") -> PairParams:
    """LJ with XPLOR smoothing (HOOMD ``mode="xplor"``): the energy times
    S(r), which ramps 1 → 0 over [r_on, r_cut] (C¹, no shift)."""
    p = lj_tables(n_types, epsilon=epsilon, sigma=sigma, r_cut=r_cut,
                  shift=False, device=device)
    return p.replace(r_on=_table(r_on, n_types, device))


def wca_tables(n_types: int, epsilon=1.0, sigma=1.0,
               device="cuda") -> PairParams:
    """WCA: LJ cut and shifted at its minimum 2^(1/6) σ."""
    rc = (2.0 ** (1.0 / 6.0)) * _table(sigma, n_types, device)
    return lj_tables(n_types, epsilon=epsilon, sigma=sigma, r_cut=rc,
                     shift=True, device=device)


def soft_tables(n_types: int, A=25.0, r_cut=1.0, device="cuda") -> PairParams:
    """Soft DPD-conservative repulsion tables (A stored in ``epsilon``)."""
    T = n_types
    return PairParams(
        epsilon=_table(A, T, device),
        sigma=torch.ones((T, T), dtype=torch.float32, device=device),
        r_cut=_table(r_cut, T, device),
        shift_const=torch.zeros((T, T), dtype=torch.float32, device=device))


def _pick(table: torch.Tensor, ti, tj) -> torch.Tensor:
    """table[ti, tj]; a one-type table is its one entry (no gather)."""
    if table.shape[0] == 1:
        return table[0, 0]
    return table[ti, tj]


def lj_kernel(r2: torch.Tensor, ti, tj, p: PairParams):
    """Lennard-Jones 12-6: u = 4ε[(σ/r)¹² − (σ/r)⁶] − u(r_cut), with XPLOR
    smoothing when ``p.r_on`` is set."""
    eps = _pick(p.epsilon, ti, tj)
    sig = _pick(p.sigma, ti, tj)
    rc2 = _pick(p.r_cut, ti, tj) ** 2
    # r2 ≈ 0 (a self pair) is masked too, before the division
    inside = (r2 < rc2) & (r2 > 1e-12)
    r2s = torch.where(inside, r2, 1.0)
    inv_r2 = sig * sig / r2s
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    e = 4.0 * eps * (inv_r6 * inv_r6 - inv_r6) - _pick(p.shift_const, ti, tj)
    coef = 4.0 * eps * (12.0 * inv_r6 * inv_r6 - 6.0 * inv_r6) / r2s
    if p.r_on is not None:
        # S = (rc²−r²)²(rc²+2r²−3r_on²)/(rc²−r_on²)³ on [r_on, rc], 1 below;
        # dS/dr² = −6(rc²−r²)(r²−r_on²)/(rc²−r_on²)³
        ron2 = _pick(p.r_on, ti, tj) ** 2
        denom = (rc2 - ron2) ** 3
        in_ramp = r2s > ron2
        S = torch.where(
            in_ramp, (rc2 - r2s) ** 2 * (rc2 + 2.0 * r2s - 3.0 * ron2) / denom,
            1.0)
        dSdr2 = torch.where(
            in_ramp, -6.0 * (rc2 - r2s) * (r2s - ron2) / denom, 0.0)
        coef = S * coef - 2.0 * e * dSdr2
        e = S * e
    return torch.where(inside, e, 0.0), torch.where(inside, coef, 0.0)


def soft_kernel(r2: torch.Tensor, ti, tj, p: PairParams):
    """DPD-conservative soft repulsion u = (A rc/2)(1 − r/rc)²,
    F = A(1 − r/rc) r̂."""
    A = _pick(p.epsilon, ti, tj)
    rc = _pick(p.r_cut, ti, tj)
    inside = (r2 < rc * rc) & (r2 > 1e-12)
    r = torch.sqrt(torch.where(inside, r2, 1.0))
    x = 1.0 - r / rc
    e = 0.5 * A * rc * x * x
    coef = A * x / r
    return torch.where(inside, e, 0.0), torch.where(inside, coef, 0.0)


class PairForceResult(NamedTuple):
    energy: torch.Tensor  # () total potential energy
    force: torch.Tensor   # (N, 3)
    virial: torch.Tensor  # (3,) diagonal virial Σ_{i<j} f_ij,d · r_ij,d


def all_pairs_force(pos: torch.Tensor, types: torch.Tensor, box: Box,
                    kernel: PairKernel, params: PairParams,
                    row_block: int = 1024) -> PairForceResult:
    """O(N²) masked all-pairs force in blocks of ``row_block`` rows; the
    last block is padded with rows that are masked out of every sum.  Each
    unordered pair is visited from both sides, so the energy and virial
    take a factor ½."""
    n = pos.shape[0]
    row_block = min(row_block, n)
    n_blocks = -(-n // row_block)
    pad = n_blocks * row_block - n
    pos_p = torch.cat([pos, pos.new_zeros((pad, 3))]) if pad else pos
    types_p = torch.cat([types, types.new_zeros((pad,))]) if pad else types
    col_ids = torch.arange(n, dtype=torch.int32, device=pos.device)
    e_sum, w_sum, forces = 0.0, 0.0, []
    for b in range(n_blocks):
        sl = slice(b * row_block, (b + 1) * row_block)
        rid = torch.arange(sl.start, sl.stop, dtype=torch.int32,
                           device=pos.device)
        dr = minimum_image(pos_p[sl, None, :] - pos[None, :, :], box)
        r2 = torch.sum(dr * dr, dim=-1)
        e, coef = kernel(r2, types_p[sl, None], types[None, :], params)
        valid = (rid[:, None] != col_ids[None, :]) & (rid[:, None] < n)
        e = torch.where(valid, e, 0.0)
        coef = torch.where(valid, coef, 0.0)
        cdr = coef[:, :, None] * dr
        forces.append(torch.sum(cdr, dim=1))
        w_sum = w_sum + torch.sum(cdr * dr, dim=(0, 1))
        e_sum = e_sum + torch.sum(e)
    force = torch.cat(forces)[:n]
    return PairForceResult(0.5 * e_sum, force, 0.5 * w_sum)
