"""Lamellar order parameter on the particle-order state (counterpart of
``metadyn_tpu/cv/lamellar.py``; the reference plugin's
``LamellarOrderParameter``):

    s = (1/N) Σ_j Σ_i a(type_i) · cos(k_j·r_i + φ_j),

with k_j = 2π n_j / L for integer Miller rows n_j, or 2π n_j h⁻¹ in a tilted
box.  The products k·r are written out elementwise, never as a matmul, so
no reduced-precision product can enter; the bias force comes from
autograd.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.box import reciprocal_matrix
from ..core.state import State, System


def wave_vectors(n: torch.Tensor, box) -> torch.Tensor:
    """(M, 3) k_j = 2π n_j h⁻¹ (2π n_j / L when orthorhombic) as an
    elementwise sum of products: no matmul precision mode involved (the
    packed lamellar CV's wave vectors too)."""
    B = reciprocal_matrix(box)
    return 2.0 * math.pi * (n[:, :, None] * B[None, :, :]).sum(dim=1)


@dataclass(frozen=True)
class LamellarOP:
    """``cv.lamellar(mode={type: coef}, lattice_vectors=[...], phi=[...])``."""

    mode: torch.Tensor             # (n_types,) per-type amplitude
    lattice_vectors: torch.Tensor  # (M, 3) integer Miller rows, f32
    phases: torch.Tensor           # (M,)
    name: str = "lamellar"

    @classmethod
    def create(cls, mode, lattice_vectors, phases=None, name="lamellar",
               device="cuda") -> "LamellarOP":
        lv = np.asarray(lattice_vectors, np.float32).reshape(-1, 3)
        phases = (np.zeros(lv.shape[0], np.float32) if phases is None
                  else np.asarray(phases, np.float32))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(mode=t(mode), lattice_vectors=t(lv), phases=t(phases),
                   name=name)

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> torch.Tensor:
        k = wave_vectors(self.lattice_vectors, state.box)             # (M, 3)
        r = state.pos
        phase = (r[:, 0:1] * k[None, :, 0] + r[:, 1:2] * k[None, :, 1]
                 + r[:, 2:3] * k[None, :, 2] + self.phases[None, :])  # (N, M)
        amp = self.mode[system.types]
        return torch.sum(amp[:, None] * torch.cos(phase)) / r.shape[0]
