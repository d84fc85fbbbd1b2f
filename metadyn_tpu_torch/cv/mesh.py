"""Mesh order parameter / structure factor S(k) on the particle-order state,
and the mesh math it shares with the packed mesh CV (counterpart of
``metadyn_tpu/cv/mesh.py``; the reference plugin's ``OrderParameterMesh``):

    assign:  ρ(mesh) ← Σ_i a(type_i)·W(r_i)    (CIC or TSC, fractional mesh)
    FFT:     ρ̂(k) = FFT[ρ]
    value:   s = (1/N)·Σ_k |ρ̂(k)|²·u(k)

with u(k) a Gaussian window around |k₀| at the current box's wave vectors
(the k = 0 mode excluded), or an explicit box-fixed array.  The bias force
comes from autograd through the assignment weights.  ``cv/packed.
PackedMesh`` uses the same stencils, scatter and window
(:func:`axis_stencil`, :func:`assign`, :func:`window`).

The scatter of :func:`assign` sums in 64-bit fixed point
(:class:`FixedPointScatter`): integer additions give the same bits in any
order, where a float ``index_add``'s atomic adds on a GPU land in a
different order on every call, so ρ, S(k) and a whole trajectory would
differ in their last bits from run to run.  The sharded mesh CVs
(``parallel/mesh.py``, ``parallel/mesh2d.py``) sum with it too.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.box import fractional, reciprocal_matrix
from ..core.state import State, System


# the fixed-point scale of the deterministic scatter: a step of 2^-40
# (9e-13) against |rho| up to 2^23, far below the f32 rounding of rho
_FIXED = 2.0 ** 40


class FixedPointScatter(torch.autograd.Function):
    """rho (size,) = the sum of ``val`` at ``idx``, added as 64-bit
    integers of ``val`` · 2^40: integer additions give the same bits in any
    order, where ``index_add``'s float atomic adds on a GPU land in a
    different order every call.  The backward is ``index_add``'s: the
    gradient at each entry's node."""

    @staticmethod
    def forward(ctx, idx, val, size: int):
        ctx.save_for_backward(idx)
        # scaling by a power of 2 is exact in val's own precision, so the
        # integers are those of a float64 product, without its copy
        q = torch.round(val * _FIXED).to(torch.int64)
        acc = torch.zeros(size, dtype=torch.int64, device=val.device)
        return (acc.index_add_(0, idx, q).double() / _FIXED).to(
            torch.float32)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return None, grad[idx], None


def axis_stencil(f: torch.Tensor, order: int):
    """Per-axis assignment stencil at mesh coordinate ``f`` (grid node g
    sits at f = g + 0.5): ``(base_node, [(offset, weight), ...])`` with
    ``base_node`` an int64 tensor.

    Order 2 is CIC (trilinear), order 3 TSC (the quadratic B-spline).  The
    weights are polynomials of the fractional offset, so they are
    differentiable in ``f``."""
    if order == 2:
        base = torch.floor(f - 0.5)
        t = f - 0.5 - base                      # weight toward the +1 node
        return base.to(torch.int64), [(0, 1.0 - t), (1, t)]
    if order == 3:
        base = torch.floor(f)                   # nearest node, |d| ≤ 1/2
        d = f - 0.5 - base
        return base.to(torch.int64), [
            (-1, 0.5 * (0.5 - d) ** 2),
            (0, 0.75 - d * d),
            (1, 0.5 * (0.5 + d) ** 2)]
    raise ValueError(f"assign order {order} unsupported (2=CIC, 3=TSC)")


def assign(frac, w: torch.Tensor, mesh_shape: tuple, order: int,
           spread: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The flat mesh density (nx·ny·nz,) of weights ``w`` (N,) at
    fractional coordinates ``frac`` (three (N,) tensors in [−½, ½)), all
    stencil entries in one deterministic scatter
    (:class:`FixedPointScatter`).

    An entry of weight 0 adds nothing, but zero-weight entries that sit
    together (the vacant slots of the packed layout) would all land on one
    node and serialize the scatter's atomic adds on a GPU.  Entry i of a
    zero-weight item goes to node ``spread[i]`` instead (default i mod M),
    which changes no sum and no gradient.  The gate is the item's weight,
    not the entry's: an item on a mesh plane has a CIC entry of value 0
    whose derivative is not 0, and its gradient must read its own node."""
    nx, ny, nz = mesh_shape
    ax = [axis_stencil((frac[d] + 0.5) * n_d, order)
          for d, n_d in enumerate(mesh_shape)]
    live = w != 0.0
    if spread is None:
        spread = torch.remainder(torch.arange(w.shape[0], device=w.device),
                                 nx * ny * nz)
    idx, val = [], []
    for cx_, wx in ax[0][1]:
        for cy_, wy in ax[1][1]:
            for cz_, wz in ax[2][1]:
                ix = torch.remainder(ax[0][0] + cx_, nx)
                iy = torch.remainder(ax[1][0] + cy_, ny)
                iz = torch.remainder(ax[2][0] + cz_, nz)
                idx.append(torch.where(live, (ix * ny + iy) * nz + iz,
                                       spread))
                val.append(w * wx * wy * wz)
    return FixedPointScatter.apply(torch.cat(idx), torch.cat(val),
                                   nx * ny * nz)


def power(rho_flat: torch.Tensor, mesh_shape: tuple) -> torch.Tensor:
    """|ρ̂(k)|² on the (nx, ny, nz) mesh."""
    rho_k = torch.fft.fftn(rho_flat.reshape(mesh_shape))
    return rho_k.real * rho_k.real + rho_k.imag * rho_k.imag


@functools.lru_cache(maxsize=16)
def _mode_grid(mesh_shape: tuple, device: torch.device) -> torch.Tensor:
    """The integer FFT mode of every node, (3, nx, ny, nz) f32."""
    mgrid = np.meshgrid(*[np.fft.fftfreq(n_) * n_ for n_ in mesh_shape],
                        indexing="ij")
    return torch.as_tensor(np.stack(mgrid).astype(np.float32), device=device)


def window(mesh_shape: tuple, k0: float, width: float, box):
    """(u, vir) at ``box``: the Gaussian window u = exp(−(|k|−k₀)²/2w²)
    and the per-axis stack vir (3, nx, ny, nz) of u'(|k|)·k_d²/|k|, both 0
    at k = 0."""
    mg = _mode_grid(tuple(mesh_shape), box.L.device)
    if box.tilt is None:
        kd2 = (2.0 * math.pi * mg / box.L[:, None, None, None]) ** 2
    else:
        B = reciprocal_matrix(box)
        kd2 = torch.stack([
            (2.0 * math.pi * (mg[0] * B[0, d] + mg[1] * B[1, d]
                              + mg[2] * B[2, d])) ** 2
            for d in range(3)])
    kmag = torch.sqrt(torch.sum(kd2, dim=0))
    u = torch.exp(-0.5 * ((kmag - k0) / width) ** 2)
    uprime = -((kmag - k0) / width ** 2) * u
    safe = torch.where(kmag > 0.0, kmag, 1.0)
    vir = uprime[None] * kd2 / safe
    u = torch.where(kmag == 0.0, 0.0, u)
    vir = torch.where(kmag[None] == 0.0, 0.0, vir)
    return u, vir


def mesh_assign(pos: torch.Tensor, weights: torch.Tensor, box,
                mesh_shape, order: int = 2) -> torch.Tensor:
    """Particle → mesh assignment (CIC ``order`` 2, TSC 3) of (N, 3)
    positions on the box's fractional mesh, (nx, ny, nz); differentiable."""
    f = fractional(pos, box)
    rho = assign((f[:, 0], f[:, 1], f[:, 2]), weights, tuple(mesh_shape),
                 order)
    return rho.reshape(tuple(mesh_shape))


def cic_assign(pos: torch.Tensor, weights: torch.Tensor, box,
               mesh_shape) -> torch.Tensor:
    """Cloud-in-cell (trilinear) assignment."""
    return mesh_assign(pos, weights, box, mesh_shape, order=2)


def _k_vectors(mesh_shape, box_L) -> np.ndarray:
    """|k| of every node of an orthorhombic mesh (host numpy, f32)."""
    ks = [2.0 * np.pi * np.fft.fftfreq(n, d=1.0) * n / l
          for n, l in zip(mesh_shape, box_L)]
    kx, ky, kz = np.meshgrid(*ks, indexing="ij")
    return np.sqrt(kx ** 2 + ky ** 2 + kz ** 2).astype(np.float32)


@dataclass(frozen=True)
class MeshOrderParameter:
    """``cv.mesh(nx, ny, nz, mode={type: coef}, k0=..., width=...)``:
    s = (1/N) Σ_k |ρ̂(k)|² u(k)."""

    mode: torch.Tensor           # (n_types,) per-type assignment coefficient
    u_k: Optional[torch.Tensor]  # explicit (nx, ny, nz) window, box-fixed
    k0: Optional[float]
    width: float
    mesh_shape: tuple
    name: str = "mesh"
    assign_order: int = 2

    @classmethod
    def create(cls, mesh_shape, box_L, mode, k0: Optional[float] = None,
               width: float = 0.5, u_k=None, name: str = "mesh",
               assign_order: int = 2, device="cuda") -> "MeshOrderParameter":
        """With ``k0`` the window follows the current box (its k-space
        virial is analytic); an explicit ``u_k`` is box-fixed (zero
        virial).  ``box_L`` is unused (the reference's signature)."""
        if u_k is None and k0 is None:
            raise ValueError("give k0 (the target |k|) or an explicit u_k")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(mode=t(mode), u_k=None if u_k is None else t(u_k),
                   k0=None if k0 is None else float(k0), width=float(width),
                   mesh_shape=tuple(int(x) for x in mesh_shape), name=name,
                   assign_order=int(assign_order))

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _kernels(self, box):
        if self.u_k is not None:
            return self.u_k, torch.zeros((3,) + self.mesh_shape,
                                         dtype=torch.float32,
                                         device=self.u_k.device)
        return window(self.mesh_shape, self.k0, self.width, box)

    def _rho_k2(self, state: State, system: System) -> torch.Tensor:
        w = self.mode[system.types]
        rho = mesh_assign(state.pos, w, state.box, self.mesh_shape,
                          order=self.assign_order)
        return power(rho, self.mesh_shape)

    def value(self, state: State, system: System) -> torch.Tensor:
        u, _ = self._kernels(state.box)
        return torch.sum(self._rho_k2(state, system) * u) / state.pos.shape[0]

    def bias_virial(self, state: State, system: System,
                    dVds: torch.Tensor) -> torch.Tensor:
        """Per-axis (3,) k-space virial of the bias force,
        W_d = dVds·(1/N)·Σ_k |ρ̂|²·u'(|k|)·k_d²/|k|; orthorhombic boxes
        only (a tilted cell's strain mixes the tilt into k)."""
        if state.box.tilt is not None:
            raise ValueError("mesh bias_virial (NPT coupling) needs an "
                             "orthorhombic box")
        _, vir = self._kernels(state.box)
        return dVds * torch.sum(self._rho_k2(state, system)[None] * vir,
                                dim=(1, 2, 3)) / state.pos.shape[0]
