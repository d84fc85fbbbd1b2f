"""Homogeneous-monomial form of the Y_lm bond-order math (counterpart of
``metadyn_tpu/cv/ylm_mono.py``).

Each N_m·(P_lm/sin^m)(cosθ)·Re/Im(u^m) term is a polynomial on the unit
sphere; homogenising with powers of (ux² + uy² + uz²) = 1 writes it as one
homogeneous degree-l polynomial in the unit bond vector u = d/|d|:

    Y-term_m(u) = Σ_k C[m, k] · mono_l[k](u)

with mono_l the canonical degree-l monomial list.  The monomial mode of the
fused LJ + CV kernel (``csrc/order_cv.cuh``, ``Mono``) uses it:

* **values**: Σ_pairs w·Y-term_m = C @ (Σ_pairs w·mono_l), so a pair only
  builds its monomials and adds them; the C contraction runs once per
  evaluation (:meth:`PackedSteinhardtQl.mono_value_decode`);
* **forces**: the per-pair bias scalar φ(u) = a·mono_l(u) with a = Cᵀ·aux;
  its u-gradient is ∂φ/∂u_α = (D_α a)·mono_{l−1}(u) with the static
  differentiation matrices D_α (:meth:`PackedSteinhardtQl.mono_force_vecs`).

The radial projector (I − uuᵀ)/r makes any homogenisation equivalent:
radial gradient components are projected out, so the added (u·u)^p factors
never change the force.

The matrices are numpy float64, as in the reference; :func:`build_monomials`
works on tensors (or numpy arrays) and follows the reference's build plan
(:func:`_split_plan`), so its products round as the reference's do.
"""
from __future__ import annotations

from functools import lru_cache
from math import comb, factorial

import numpy as np

from .steinhardt import _norms, _plm_over_sinm_coeffs


@lru_cache(maxsize=None)
def mono_powers(deg: int) -> tuple:
    """Canonical monomial exponent list for homogeneous degree ``deg``:
    tuples (i, j, k) with i + j + k = deg, lexicographically descending in
    (i, j).  n_mono(deg) = (deg + 1)(deg + 2)/2."""
    out = []
    for i in range(deg, -1, -1):
        for j in range(deg - i, -1, -1):
            out.append((i, j, deg - i - j))
    return tuple(out)


@lru_cache(maxsize=None)
def _mono_index(deg: int) -> dict:
    return {p: k for k, p in enumerate(mono_powers(deg))}


def n_mono(deg: int) -> int:
    return (deg + 1) * (deg + 2) // 2


@lru_cache(maxsize=None)
def ylm_mono_matrix(l: int) -> np.ndarray:
    """(2(l+1), n_mono(l)) f64 matrix C: row m holds the Re-term
    coefficients, row l+1+m the Im-term ones, such that

        N_m·p_m(uz)·Re(u^m) = Σ_k C[m, k]·mono_l[k](ux, uy, uz)

    on the unit sphere (homogenised by (ux² + uy² + uz²)^p factors)."""
    idx = _mono_index(l)
    C = np.zeros((2 * (l + 1), n_mono(l)))
    coeffs = _plm_over_sinm_coeffs(l)
    norms = _norms(l).astype(np.float64)
    for m in range(l + 1):
        poly = coeffs[m]                      # p_m coefficients in uz^k
        for k in range(poly.shape[0]):
            a_k = poly[k]
            if a_k == 0.0:
                continue
            # (ux + i·uy)^m = Σ_t binom(m, t) i^t ux^{m−t} uy^t
            for t in range(m + 1):
                c_t = comb(m, t) * (-1) ** (t // 2)
                row = m if t % 2 == 0 else l + 1 + m
                # uz^k · ux^{m−t} uy^t · (u·u)^p, p = (l − k − m)/2
                rem = l - k - m
                assert rem >= 0 and rem % 2 == 0, (l, m, k)
                p = rem // 2
                for a in range(p + 1):
                    for b in range(p + 1 - a):
                        g = p - a - b
                        mult = factorial(p) // (
                            factorial(a) * factorial(b) * factorial(g))
                        pw = (m - t + 2 * a, t + 2 * b, k + 2 * g)
                        C[row, idx[pw]] += norms[m] * a_k * c_t * mult
    return C


@lru_cache(maxsize=None)
def diff_matrices(l: int) -> tuple:
    """(Dx, Dy, Dz), each (n_mono(l−1), n_mono(l)) f64, mapping a degree-l
    coefficient vector a to the coefficients of ∂(a·mono_l)/∂u_α in the
    degree-(l−1) basis."""
    src = mono_powers(l)
    dst = _mono_index(l - 1)
    mats = []
    for axis in range(3):
        D = np.zeros((n_mono(l - 1), n_mono(l)))
        for k, pw in enumerate(src):
            e = pw[axis]
            if e == 0:
                continue
            low = list(pw)
            low[axis] -= 1
            D[dst[tuple(low)], k] = e
        mats.append(D)
    return tuple(mats)


@lru_cache(maxsize=None)
def _split_plan(deg: int) -> tuple:
    """Static build plan: mono_deg[k] = mono_hi[ki]·mono_lo[kj] with hi =
    deg − deg//2, lo = deg//2 (greedy exponent split).  The CUDA kernel's
    ``order_cv::build_mono`` takes the same split."""
    hi, lo = deg - deg // 2, deg // 2
    ih, il = _mono_index(hi), _mono_index(lo)
    plan = []
    for (i, j, k) in mono_powers(deg):
        i2 = min(i, hi)
        j2 = min(j, hi - i2)
        k2 = hi - i2 - j2
        assert k2 <= k, (deg, i, j, k)
        plan.append((ih[(i2, j2, k2)], il[(i - i2, j - j2, k - k2)]))
    return hi, lo, tuple(plan)


def build_monomials(deg: int, ux, uy, uz, _cache=None) -> list:
    """All degree-``deg`` monomials of (ux, uy, uz) in ``mono_powers``
    order, built by recursive degree-halving (~n_mono products per level).
    Works on tensors or numpy arrays; ``_cache`` shares the lower degrees
    between calls on the same (ux, uy, uz)."""
    if _cache is None:
        _cache = {}
    if deg in _cache:
        return _cache[deg]
    if deg == 0:
        out = [ux * 0.0 + 1.0]
    elif deg == 1:
        out = [ux, uy, uz]
    else:
        hi, lo, plan = _split_plan(deg)
        mh = build_monomials(hi, ux, uy, uz, _cache)
        ml = build_monomials(lo, ux, uy, uz, _cache)
        out = [mh[a] * ml[b] for a, b in plan]
    _cache[deg] = out
    return out
