"""Collective variables over the packed (slot-layout) state (counterpart of
``metadyn_tpu/cv/packed.py``).  Only the lamellar CV is ported; the MSD and
mesh CVs wait.

Per-particle amplitudes are per-slot attributes, scattered with the slots
at pack and repack time, so vacant slots contribute exactly zero.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.box import reciprocal_matrix
from ..core.state import System
from ..ops.packed import PackedState


class PackedLamellar(nn.Module):
    """Lamellar order parameter on the packed state:

        s = (1/N) Σ_slots amp_slot · cos(k_j·r_slot + φ_j)

    ``amp`` must be registered as the per-slot attribute ``lam_<name>`` at
    pack time (0 on vacant slots).  The Miller indices and phases are
    buffers, so they follow ``.to(device)``."""

    lattice_vectors: torch.Tensor  # (M, 3) f32 integer Miller indices
    phases: torch.Tensor           # (M,) f32

    def __init__(self, lattice_vectors, n_real: int, device, phases=None,
                 name: str = "lamellar"):
        super().__init__()
        lv = np.array(lattice_vectors, np.float32).reshape(-1, 3)
        ph = (np.zeros(lv.shape[0], np.float32) if phases is None
              else np.array(phases, np.float32).reshape(-1))
        self.register_buffer("lattice_vectors",
                             torch.as_tensor(lv, device=device))
        self.register_buffer("phases", torch.as_tensor(ph, device=device))
        self.n_real = n_real
        self.name = name

    @classmethod
    def create(cls, lattice_vectors, n_real: int, device, phases=None,
               name: str = "lamellar") -> "PackedLamellar":
        return cls(lattice_vectors, n_real, device, phases=phases, name=name)

    @property
    def attr_name(self) -> str:
        return f"lam_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def wave_vectors(self, state: PackedState) -> torch.Tensor:
        """(M, 3) k = 2π n @ h⁻¹, as an elementwise sum of products (exact
        f32 for the diagonal orthorhombic h⁻¹; no matmul precision mode
        involved)."""
        B = reciprocal_matrix(state.box)
        k = (self.lattice_vectors[:, :, None] * B[None, :, :]).sum(dim=1)
        return 2.0 * math.pi * k

    def value(self, state: PackedState, system: System) -> torch.Tensor:
        amp = state.attrs[self.attr_name]
        k = self.wave_vectors(state)
        s = torch.zeros((), dtype=torch.float32, device=amp.device)
        for m in range(k.shape[0]):
            phase = (k[m, 0] * state.r[0] + k[m, 1] * state.r[1]
                     + k[m, 2] * state.r[2] + self.phases[m])
            s = s + torch.sum(amp * torch.cos(phase))
        return s / self.n_real

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: torch.Tensor, f_acc: torch.Tensor
                         ) -> torch.Tensor:
        """Analytic bias force: f_acc + (−dVds · ∂s/∂r).

        ∂s/∂r_d = −amp·sin(k·r + φ)·k_d / N, so the contribution is
        +dVds·amp·sin(phase)·k_d / N."""
        amp = state.attrs[self.attr_name]
        k = self.wave_vectors(state)
        coef = dVds / self.n_real
        for m in range(k.shape[0]):
            phase = (k[m, 0] * state.r[0] + k[m, 1] * state.r[1]
                     + k[m, 2] * state.r[2] + self.phases[m])
            w = coef * amp * torch.sin(phase)
            f_acc = f_acc + w[None, :] * k[m, :, None]
        return f_acc
