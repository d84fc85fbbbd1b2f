"""Bias grid on the device: Gaussian hill deposition and multilinear
interpolation of V and ∂V/∂s (counterpart of ``metadyn_tpu/bias/grid.py``).

V(s) lives on a regular N-d grid; every deposit adds a Gaussian to every
grid point.  Beside V the grid keeps the analytic derivative grids ∂V/∂s_d,
so bias forces are multilinear interpolations of those.

A CV point is (d,), or (W, d) for W walkers: the interpolation then gives
(W,) values and (W, d) gradients, and :func:`hill_field` one field per
walker.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class GridSpec:
    """Per-CV grid registration ``(cv_min, cv_max, num_points, sigma)``."""

    lo: torch.Tensor      # (d,) f32
    hi: torch.Tensor      # (d,) f32
    sigma: torch.Tensor   # (d,) f32 hill widths
    shape: tuple          # (n_1, ..., n_d)
    periodic: tuple       # (bool, ...) per dim

    @classmethod
    def create(cls, lo: Sequence[float], hi: Sequence[float],
               num_points: Sequence[int], sigma: Sequence[float], device,
               periodic: Sequence[bool] | None = None) -> "GridSpec":
        lo = np.atleast_1d(np.asarray(lo, np.float32))
        hi = np.atleast_1d(np.asarray(hi, np.float32))
        num_points = tuple(int(n) for n in np.atleast_1d(num_points))
        sigma = np.atleast_1d(np.asarray(sigma, np.float32))
        periodic = tuple(bool(p) for p in
                         (periodic or [False] * len(num_points)))
        if not (len(lo) == len(hi) == len(num_points) == len(sigma)
                == len(periodic)):
            raise ValueError("GridSpec: lo, hi, num_points, sigma and "
                             "periodic need one entry per CV")

        def t(a):
            return torch.as_tensor(a, device=device)

        return cls(lo=t(lo), hi=t(hi), sigma=t(sigma), shape=num_points,
                   periodic=periodic)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def axis_coords(self, d: int) -> torch.Tensor:
        """Grid-point coordinates along dimension d, (n_d,)."""
        n = self.shape[d]
        idx = torch.arange(n, dtype=torch.float32, device=self.device)
        denom = n if self.periodic[d] else n - 1
        return self.lo[d] + (self.hi[d] - self.lo[d]) * idx / denom

    def spacing(self, d: int) -> torch.Tensor:
        n = self.shape[d]
        denom = n if self.periodic[d] else (n - 1)
        return (self.hi[d] - self.lo[d]) / denom


@dataclass(frozen=True)
class BiasGrid:
    """V(s) plus the analytic derivative grids, dense f32 on the device."""

    spec: GridSpec
    V: torch.Tensor   # (*shape,)
    dV: torch.Tensor  # (d, *shape) — ∂V/∂s_d at each grid point

    @classmethod
    def zeros(cls, spec: GridSpec) -> "BiasGrid":
        return cls(spec=spec,
                   V=torch.zeros(spec.shape, dtype=torch.float32,
                                 device=spec.device),
                   dV=torch.zeros((spec.ndim, *spec.shape),
                                  dtype=torch.float32, device=spec.device))

    def replace(self, **changes) -> "BiasGrid":
        return dataclasses.replace(self, **changes)


def _hill_factors(spec: GridSpec, s: torch.Tensor):
    """Per-dimension Gaussian factors g_d = exp(−Δ²/2σ²) and derivative
    prefactors h_d = −Δ/σ² (∂/∂x_d of the hill is h_d · hill).  Periodic
    dims use the nearest image only."""
    gs, hs = [], []
    for d in range(spec.ndim):
        delta = spec.axis_coords(d) - s[..., d, None]
        if spec.periodic[d]:
            period = spec.hi[d] - spec.lo[d]
            delta = delta - period * torch.round(delta / period)
        sig = spec.sigma[d]
        gs.append(torch.exp(-0.5 * (delta / sig) ** 2))
        hs.append(-delta / (sig * sig))
    return gs, hs


def _along(v: torch.Tensor, d: int, ndim: int) -> torch.Tensor:
    """(..., n_d) → broadcastable along grid axis d (after the leading
    walker dimension, if any)."""
    lead = v.shape[:-1]
    shape = [1] * ndim
    shape[d] = -1
    return v.reshape(*lead, *shape)


def hill_field(spec: GridSpec, s: torch.Tensor, height: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-grid (ΔV, ΔdV) of one Gaussian hill of ``height`` at s: (*shape,)
    and (d, *shape); for W walkers' s (W, d) and heights (W,), one field
    each, (W, *shape) and (W, d, *shape)."""
    gs, hs = _hill_factors(spec, s)
    lead = s.shape[:-1]
    hill = height.reshape(*lead, *([1] * spec.ndim))
    for d, g in enumerate(gs):
        hill = hill * _along(g, d, spec.ndim)
    dV = [hill * _along(hs[d], d, spec.ndim) for d in range(spec.ndim)]
    return hill, torch.stack(dV, dim=len(lead))


def deposit_hill(grid: BiasGrid, s: torch.Tensor,
                 height: torch.Tensor) -> BiasGrid:
    """Add one Gaussian hill of the given height centred at s."""
    dV_hill, ddV = hill_field(grid.spec, s, height)
    return grid.replace(V=grid.V + dV_hill, dV=grid.dV + ddV)


def _interp_weights(spec: GridSpec, s: torch.Tensor):
    """Lower-corner indices and fractional offsets per dimension.  Out of
    range s is clamped to the grid; the sampler reports it."""
    idx, frac = [], []
    for d in range(spec.ndim):
        n = spec.shape[d]
        t = (s[..., d] - spec.lo[d]) / spec.spacing(d)
        if spec.periodic[d]:
            t = torch.remainder(t, n)
            i0 = torch.floor(t).to(torch.int64)
            f = t - i0
            i0 = torch.clamp(i0, 0, n - 1)
        else:
            # clamp the index so the upper corner i0 + 1 is a real point
            t = torch.clamp(t, 0.0, float(n - 1))
            i0 = torch.clamp(torch.floor(t).to(torch.int64), max=max(n - 2, 0))
            f = t - i0
        idx.append(i0)
        frac.append(f)
    return idx, frac


def _gather_corner(arr: torch.Tensor, spec: GridSpec, idx, corner):
    """``arr`` at one interpolation corner, by a flat device index.

    Subscripting with 0-d integer tensors (``arr[i, j]``) would read each
    index to the host, one sync per index; ``torch.take`` keeps it on the
    device."""
    flat = 0
    for d in range(spec.ndim):
        i = idx[d] + corner[d]
        n = spec.shape[d]
        i = (torch.remainder(i, n) if spec.periodic[d]
             else torch.clamp(i, max=n - 1))
        flat = flat * n + i
    return torch.take(arr, flat)


def interp(arr: torch.Tensor, spec: GridSpec, s: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of a (*shape,) grid array at point s (d,),
    or at W points (W, d)."""
    idx, frac = _interp_weights(spec, s)
    out = 0.0
    for corner in itertools.product((0, 1), repeat=spec.ndim):
        w = 1.0
        for d, c in enumerate(corner):
            w = w * (frac[d] if c else (1.0 - frac[d]))
        out = out + w * _gather_corner(arr, spec, idx, corner)
    return out


def value_and_grad(grid: BiasGrid, s: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(V(s), ∂V/∂s), both multilinearly interpolated: () and (d,), or
    (W,) and (W, d) at W points."""
    V = interp(grid.V, grid.spec, s)
    dV = torch.stack([interp(grid.dV[d], grid.spec, s)
                      for d in range(grid.spec.ndim)], dim=-1)
    return V, dV


def grad_fd(grid: BiasGrid, s: torch.Tensor) -> torch.Tensor:
    """The cross-check gradient: the derivative of the multilinear
    interpolant of V by a central difference over one grid spacing (the
    reference's finite-difference-on-grid option), (d,)."""
    out = []
    for d in range(grid.spec.ndim):
        dx = grid.spec.spacing(d)
        e = torch.zeros(grid.spec.ndim, dtype=torch.float32,
                        device=s.device)
        e[d] = 0.5 * dx
        out.append((interp(grid.V, grid.spec, s + e)
                    - interp(grid.V, grid.spec, s - e)) / dx)
    return torch.stack(out)
