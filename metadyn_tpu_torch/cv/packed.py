"""Collective variables over the packed (slot-layout) state (counterpart of
``metadyn_tpu/cv/packed.py``).  The lamellar CV (analytic bias force) and
the mesh S(k) CV (bias force by autograd in the sampler) are ported; the
MSD CV waits.

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
from ..ops.packed import PackedState, _frac3
from .mesh import axis_stencil


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


class PackedMesh:
    """Mesh order parameter / structure factor S(k) on the packed state:

        s = (1/N) Σ_k |ρ̂(k)|² u(k),   ρ = Σ_slots w_slot · W(r_slot)

    with W the CIC (``assign_order`` 2) or TSC (3) assignment on a
    fractional (lattice-aligned) mesh, ρ̂ its FFT, and u a Gaussian window
    exp(−(|k| − k0)²/2w²) at the current box's wave vectors with the k = 0
    mode excluded, or an explicit box-fixed ``u_k``.  The per-slot
    coefficients ``w`` are the attribute ``mesh_<name>`` (0 on vacant
    slots).

    The value is differentiable in ``state.r`` through torch autograd: the
    class has no ``accum_bias_force``, so the sampler takes its bias force
    by autograd, as the reference takes it by ``jax.vjp``.  Its
    ``bias_virial`` is the k-space virial of the bias."""

    def __init__(self, mesh_shape, n_real: int, k0=None, width: float = 0.5,
                 u_k=None, name: str = "mesh", assign_order: int = 2,
                 device=None):
        if u_k is None and k0 is None:
            raise ValueError("give k0 (the target |k|) or an explicit u_k")
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.n_real = n_real
        self.k0 = None if k0 is None else float(k0)
        self.width = float(width)
        self.name = name
        self.assign_order = int(assign_order)
        self.u_k = (None if u_k is None else torch.as_tensor(
            np.asarray(u_k, np.float32), device=device))
        # the integer mode grid (3, nx, ny, nz) per device: static
        self._modes = {}

    @classmethod
    def create(cls, mesh_shape, box_L, n_real: int, k0=None,
               width: float = 0.5, u_k=None, name: str = "mesh",
               assign_order: int = 2, device=None) -> "PackedMesh":
        """The reference's signature; ``box_L`` is unused (the window is
        evaluated at the current box), ``device`` places an explicit
        ``u_k``."""
        return cls(mesh_shape, n_real, k0=k0, width=width, u_k=u_k,
                   name=name, assign_order=assign_order, device=device)

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _kernels(self, box):
        """(u, vir) at ``box``, vir the per-axis stack (3, nx, ny, nz) of
        u'(|k|)·k_d²/|k|."""
        dev = box.L.device
        if self.u_k is not None:
            return self.u_k.to(dev), torch.zeros(
                (3,) + self.mesh_shape, dtype=torch.float32, device=dev)
        mg = self._modes.get(dev)
        if mg is None:
            mgrid = np.meshgrid(*[np.fft.fftfreq(n_) * n_
                                  for n_ in self.mesh_shape], indexing="ij")
            mg = self._modes[dev] = torch.as_tensor(
                np.stack(mgrid).astype(np.float32), device=dev)
        if box.tilt is None:
            kd2 = (2.0 * math.pi * mg / box.L[:, None, None, None]) ** 2
        else:
            B = reciprocal_matrix(box)
            kd2 = torch.stack([
                (2.0 * math.pi * (mg[0] * B[0, d] + mg[1] * B[1, d]
                                  + mg[2] * B[2, d])) ** 2
                for d in range(3)])
        kmag = torch.sqrt(torch.sum(kd2, dim=0))
        u = torch.exp(-0.5 * ((kmag - self.k0) / self.width) ** 2)
        uprime = -((kmag - self.k0) / self.width ** 2) * u
        safe = torch.where(kmag > 0.0, kmag, 1.0)
        vir = uprime[None] * kd2 / safe
        u = torch.where(kmag == 0.0, 0.0, u)
        vir = torch.where(kmag[None] == 0.0, 0.0, vir)
        return u, vir

    def _rho_k2(self, state: PackedState) -> torch.Tensor:
        """|ρ̂(k)|² on the (nx, ny, nz) mesh.  All stencil nodes go into the
        flat mesh in one ``index_add``."""
        nx, ny, nz = self.mesh_shape
        w = state.attrs[self.attr_name]
        f3 = _frac3(state.r, state.box)
        ax = [axis_stencil((f3[d] + 0.5) * n_d, self.assign_order)
              for d, n_d in enumerate((nx, ny, nz))]
        idx, val = [], []
        for cx_, wx in ax[0][1]:
            for cy_, wy in ax[1][1]:
                for cz_, wz in ax[2][1]:
                    ix = torch.remainder(ax[0][0] + cx_, nx)
                    iy = torch.remainder(ax[1][0] + cy_, ny)
                    iz = torch.remainder(ax[2][0] + cz_, nz)
                    idx.append((ix * ny + iy) * nz + iz)
                    val.append(w * wx * wy * wz)
        rho = torch.zeros(nx * ny * nz, dtype=torch.float32,
                          device=w.device).index_add(
            0, torch.cat(idx), torch.cat(val))
        rho_k = torch.fft.fftn(rho.reshape(nx, ny, nz))
        return rho_k.real * rho_k.real + rho_k.imag * rho_k.imag

    def value(self, state: PackedState, system: System) -> torch.Tensor:
        u, _ = self._kernels(state.box)
        return torch.sum(self._rho_k2(state) * u) / self.n_real

    def bias_virial(self, state: PackedState, system: System,
                    dVds: torch.Tensor) -> torch.Tensor:
        """Per-axis (3,) k-space virial of the bias force:
        W_d = dVds·(1/N)·Σ_k |ρ̂|²·u'(|k|)·k_d²/|k|."""
        _, vir = self._kernels(state.box)
        return dVds * torch.sum(self._rho_k2(state)[None] * vir,
                                dim=(1, 2, 3)) / self.n_real
