"""Mean-squared-displacement CV on the particle-order state (counterpart of
``metadyn_tpu/cv/msd.py``):

    s = (1/N) Σ_i |r_i − r_i⁰|²

against stored unwrapped reference positions; the bias force
∂s/∂r_i = 2(r_i − r_i⁰)/N comes from the sampler's autograd.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.state import State, System


@dataclass(frozen=True)
class MSD:
    ref_pos: torch.Tensor  # (N, 3) unwrapped reference positions
    name: str = "msd"

    @classmethod
    def create(cls, ref_pos, name: str = "msd", device="cuda") -> "MSD":
        return cls(ref_pos=torch.as_tensor(np.asarray(ref_pos, np.float32),
                                           device=device), name=name)

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _unwrapped(self, state: State) -> torch.Tensor:
        return state.pos + state.image.to(state.pos.dtype) * state.box.L

    def value(self, state: State, system: System) -> torch.Tensor:
        d = self._unwrapped(state) - self.ref_pos
        return torch.sum(d * d) / state.pos.shape[0]

    def bias_virial(self, state: State, system: System,
                    dVds: torch.Tensor) -> torch.Tensor:
        """Per-axis W_d = −dVds·ds/dε_d under the axis strain (r_d scales,
        the stored reference positions do not): ds/dε_d = (2/N)·Σ
        (r_d − r⁰_d)·r_d."""
        u = self._unwrapped(state)
        d = u - self.ref_pos
        return -dVds * 2.0 * torch.sum(d * u, dim=0) / state.pos.shape[0]
