"""Simple CVs (counterpart of ``metadyn_tpu/cv/simple.py``): the
coordinate of one particle, the one-particle metadynamics oracle's CV.
The energy CVs (``EnergyCV``, ``PotentialEnergyCV``) wait for the
well-tempered ensemble (ROADMAP queue 1, item 2)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.state import State, System


@dataclass(frozen=True)
class AxisPosition:
    """s = the unwrapped coordinate ``axis`` of particle ``particle``."""

    particle: int = 0
    axis: int = 0
    name: str = "x"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> torch.Tensor:
        # unwrapped, so the CV is smooth across the periodic boundary
        p, a = self.particle, self.axis
        return (state.pos[p, a]
                + state.image[p, a].to(state.pos.dtype) * state.box.L[a])
