"""Steinhardt Q_l helpers (counterpart of ``metadyn_tpu/cv/steinhardt.py``).

    Q_l = sqrt( 4π/(2l+1) · Σ_{m=−l..l} | ⟨Y_lm(r̂_ij)⟩_bonds |² )

Spherical harmonics are evaluated singularity-free in Cartesian form:
Y_lm = N_lm · p_lm(cosθ) · (sinθ e^{iφ})^m, where p_lm = P_l^m / sin^mθ is
a polynomial in cosθ and (sinθ e^{iφ})^m = ((x+iy)/r)^m.

Only the helpers the packed order CVs need are ported: the p_lm and N_lm
tables (numpy, the same numbers the CUDA kernels upload) and
:func:`ql_from_sums`.  The particle-order ``SteinhardtQl`` waits for the
particle-order engines.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


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
