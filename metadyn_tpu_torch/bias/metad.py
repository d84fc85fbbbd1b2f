"""Metadynamics bias: hill schedule, well-tempered scaling, walls, FES
(counterpart of ``metadyn_tpu/bias/metad.py``, grid mode only).

Every ``stride`` steps a hill of height

    W' = W                      (standard)
    W' = W · exp(−V(s)/ΔT)      (well-tempered)

is deposited on the grid.  Flux-tempered mode (``FLUX_TEMPERED``) deposits
no hills: ``bias/flux.py`` rebuilds its bias from histograms.  Hill-list
mode waits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .grid import BiasGrid, GridSpec, deposit_hill, value_and_grad

STANDARD = "standard"
WELL_TEMPERED = "well_tempered"
FLUX_TEMPERED = "flux_tempered"


@dataclass(frozen=True)
class HillSpec:
    """``mode_metadynamics(W=..., stride=..., deltaT=..., mode=...)``."""

    W: float
    stride: int = 500
    mode: str = STANDARD
    deltaT: float = 1.0

    @classmethod
    def create(cls, W: float, stride: int, mode: str = STANDARD,
               deltaT: float = 1.0) -> "HillSpec":
        if mode not in (STANDARD, WELL_TEMPERED, FLUX_TEMPERED):
            raise AssertionError(f"unknown hill mode {mode!r}")
        return cls(W=float(W), stride=int(stride), mode=mode,
                   deltaT=float(deltaT))


@dataclass(frozen=True)
class WallSpec:
    """Harmonic CV walls: u(s) = k·(s − hi)² above hi, k·(lo − s)² below lo."""

    k: torch.Tensor   # (d,)
    lo: torch.Tensor  # (d,)
    hi: torch.Tensor  # (d,)

    @classmethod
    def at_grid_edges(cls, grid_spec: GridSpec, k: float = 1000.0,
                      margin_frac: float = 0.05) -> "WallSpec":
        m = margin_frac * (grid_spec.hi - grid_spec.lo)
        return cls(k=torch.full_like(grid_spec.lo, k),
                   lo=grid_spec.lo + m, hi=grid_spec.hi - m)

    def energy_and_grad(self, s: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        over = torch.clamp(s - self.hi, min=0.0)
        under = torch.clamp(self.lo - s, min=0.0)
        e = torch.sum(self.k * (over * over + under * under), dim=-1)
        g = 2.0 * self.k * (over - under)
        return e, g


@dataclass(frozen=True)
class BiasState:
    """The grid bias and the number of hills deposited (a host count)."""

    grid: BiasGrid
    n_hills: int

    @classmethod
    def zeros(cls, spec: GridSpec) -> "BiasState":
        return cls(grid=BiasGrid.zeros(spec), n_hills=0)


class HillRecord(NamedTuple):
    """One hill-file row: step, centre s⃗, height W'."""

    step: int
    center: torch.Tensor  # (d,)
    height: torch.Tensor  # ()


def bias_value_and_grad(bias: BiasState, s: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(V(s), ∂V/∂s) of the grid bias."""
    return value_and_grad(bias.grid, s)


def hill_height(hills: HillSpec, bias: BiasState,
                s: torch.Tensor) -> torch.Tensor:
    """The deposit height W' given the existing bias at s; (W,) at W
    walkers' points (W, d)."""
    if hills.mode == WELL_TEMPERED:
        V, _ = bias_value_and_grad(bias, s)
        return hills.W * torch.exp(-V / hills.deltaT)
    return torch.full(s.shape[:-1], hills.W, dtype=torch.float32,
                      device=s.device)


def deposit(hills: HillSpec, bias: BiasState, s: torch.Tensor,
            step: int) -> tuple[BiasState, HillRecord]:
    h = hill_height(hills, bias, s)
    new = BiasState(grid=deposit_hill(bias.grid, s, h),
                    n_hills=bias.n_hills + 1)
    return new, HillRecord(step=step, center=s, height=h)


def free_energy(hills: HillSpec, bias: BiasState, kT: float) -> torch.Tensor:
    """FES on the grid: F = −V (standard) or −(T + ΔT)/ΔT · V
    (well-tempered), shifted so min F = 0."""
    if hills.mode == WELL_TEMPERED:
        F = -(kT + hills.deltaT) / hills.deltaT * bias.grid.V
    else:
        F = -bias.grid.V
    return F - torch.min(F)
