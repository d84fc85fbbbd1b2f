"""Steinhardt Q_l helpers (counterpart of ``metadyn_tpu/cv/steinhardt.py``).

    Q_l = sqrt( 4π/(2l+1) · Σ_{m=−l..l} | ⟨Y_lm(r̂_ij)⟩_bonds |² )

Spherical harmonics are evaluated singularity-free in Cartesian form:
Y_lm = N_lm · p_lm(cosθ) · (sinθ e^{iφ})^m, where p_lm = P_l^m / sin^mθ is
a polynomial in cosθ and (sinθ e^{iφ})^m = ((x+iy)/r)^m.

The p_lm and N_lm tables are numpy (the same numbers the CUDA kernels of
the packed order CVs upload).  ``SteinhardtQl`` is the particle-order CV:
a global Q_l over every bond within r_cut, swept over all pairs in row
blocks; its bias force comes from autograd through
:func:`ylm_bond_sums`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..core.box import minimum_image


@lru_cache(maxsize=None)
def _plm_over_sinm_coeffs(l: int) -> tuple:
    """Coefficients (ascending powers of cosθ) of P_l^m(cosθ)/sin^mθ for
    m = 0..l: P_l^m/sin^m = (−1)^m · d^m/dx^m P_l(x)."""
    p = np.zeros(l + 1)
    for k in range(l // 2 + 1):
        c = ((-1) ** k * math.factorial(2 * l - 2 * k)
             / (2 ** l * math.factorial(k) * math.factorial(l - k)
                * math.factorial(l - 2 * k)))
        p[l - 2 * k] = c
    out = []
    d = p.copy()
    for m in range(l + 1):
        out.append(((-1) ** m) * d.copy())
        d = np.asarray([d[i] * i for i in range(1, d.shape[0])] or [0.0])
    return tuple(out)


@lru_cache(maxsize=None)
def _dcoeffs(l: int) -> tuple:
    """Coefficients of d/dx of each p_lm (``[0.0]`` for a constant)."""
    return tuple(np.asarray([c[i] * i for i in range(1, c.shape[0])] or [0.0])
                 for c in _plm_over_sinm_coeffs(l))


@lru_cache(maxsize=None)
def _norms(l: int) -> np.ndarray:
    """N_lm for m = 0..l, f32 (read-only: the array is cached)."""
    out = np.asarray([
        math.sqrt((2 * l + 1) / (4 * math.pi)
                  * math.factorial(l - m) / math.factorial(l + m))
        for m in range(l + 1)
    ], np.float32)
    out.flags.writeable = False
    return out


def ql_from_sums(re: torch.Tensor, im: torch.Tensor, n_bonds: torch.Tensor,
                 l: int) -> torch.Tensor:
    """Q_l from Σ Y_lm (m = 0..l) and the bond count (|Y_{l,−m}| = |Y_lm|)."""
    q2 = (re[0] ** 2 + im[0] ** 2) + 2.0 * torch.sum(re[1:] ** 2 + im[1:] ** 2)
    nb = torch.clamp(n_bonds, min=1.0)
    return torch.sqrt(4.0 * math.pi / (2 * l + 1) * q2) / nb


def ylm_bond_sums(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
                  weight: torch.Tensor, l: int):
    """Σ_bonds w·Y_lm for m = 0..l as (re, im), each (l + 1,).  ``dx``,
    ``dy``, ``dz`` and ``weight`` are (B,)."""
    r2 = dx * dx + dy * dy + dz * dz
    # the guard comes before the sqrt: d√0 is inf, and a zero weight does
    # not keep an inf out of the gradient
    r = torch.sqrt(torch.where(r2 > 1e-12, r2, 1.0))
    c = dz / r                                       # cosθ
    ux, uy = dx / r, dy / r
    coeffs = _plm_over_sinm_coeffs(l)
    norms = _norms(l)
    re, im = [], []
    pr, pi = torch.ones_like(c), torch.zeros_like(c)  # ((x + iy)/r)^0
    for m in range(l + 1):
        pl = torch.zeros_like(c)
        for a in coeffs[m][::-1]:
            pl = pl * c + float(a)
        re.append(torch.sum(weight * float(norms[m]) * pl * pr))
        im.append(torch.sum(weight * float(norms[m]) * pl * pi))
        pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
    return torch.stack(re), torch.stack(im)


@dataclass(frozen=True)
class SteinhardtQl:
    """Global Q_l over all pair bonds within ``r_cut`` (both directions of
    a bond counted, as a full neighbour list counts them), in blocks of
    ``row_block`` rows."""

    r_cut: float = 1.5
    l: int = 6
    row_block: int = 512
    name: str = "q6"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state, system) -> torch.Tensor:
        pos = state.pos
        n = pos.shape[0]
        rb = min(self.row_block, n)
        n_blocks = -(-n // rb)
        pos_p = torch.cat([pos, pos.new_zeros((n_blocks * rb - n, 3))])
        cols = torch.arange(n, device=pos.device)
        re_t = im_t = nb = 0.0
        for b in range(n_blocks):
            rid = torch.arange(b * rb, (b + 1) * rb, device=pos.device)
            dr = minimum_image(pos_p[b * rb:(b + 1) * rb, None, :]
                               - pos[None, :, :], state.box)
            r2 = torch.sum(dr * dr, dim=-1)
            ok = ((r2 < self.r_cut ** 2) & (rid[:, None] != cols[None, :])
                  & (rid[:, None] < n))
            w = ok.to(torch.float32).reshape(-1)
            re, im = ylm_bond_sums(dr[..., 0].reshape(-1),
                                   dr[..., 1].reshape(-1),
                                   dr[..., 2].reshape(-1), w, self.l)
            re_t, im_t, nb = re_t + re, im_t + im, nb + torch.sum(w)
        return ql_from_sums(re_t, im_t, nb, self.l)
