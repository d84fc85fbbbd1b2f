"""The distributed particle-mesh S(k) CV on the x-slabs (counterpart of
``metadyn_tpu/parallel/mesh.py``, the reference's dfftlib analog): at
Config 5's 1M beads the assignment, the 3-D FFT and the k-space reduction
run on a partitioned mesh, one x-slab of columns per shard, beside the
cell slabs of ``parallel/spatial.py``.

Per shard k (its device ``devices[k]``; shards may share one):

1. **Assignment with halo columns.**  The slots of the shard's cell slab
   are assigned (CIC, ``assign_order`` 2, or TSC, 3) into its ρ slab of
   ``nx / n_dev`` x columns extended by ``halo`` columns per side, at the
   Cartesian mesh coordinate (r_d / L_d + ½)·n_d of the current box, with
   no wrap along x: a slot that drifted past the seam lands in a halo.
   ``halo`` = 1 + ⌈½·skin / spacing⌉ covers the stencil's reach and the
   drift between repacks.  The scatter entries of zero-weight slots (the
   vacant ones) go to node j mod M of their slot j, not to one node (at
   Config 5's 1M beads the piled scatter took most of the device time,
   ``cv/mesh.assign``).  The scatter sums in 64-bit fixed point
   (:class:`_FixedPointScatter`), so its result does not depend on the
   order in which a GPU's atomic adds land: a resumed run repeats the
   straight one bit for bit.
2. **Halo fold.**  Each halo block is added into the ring neighbour's
   interior columns it overlaps (the reference's two ``ppermute``): after
   the fold each shard holds its slab of the global ρ exactly.
3. **Slab FFT.**  An FFT over (y, z) per shard, one transpose (the
   reference's ``all_to_all``: shard j gathers every shard's j-th y slab,
   concatenated along x) and an FFT over x: ρ̂ comes out in y slabs.
4. **k-space reduction.**  Σ |ρ̂|²·u(|k|) over each shard's y slab of
   wave vectors, u the Gaussian window at the current box (the NPT-correct
   mode), then the shards' partial sums added in shard order (the
   reference's ``psum``), so repeats are bit for bit.

The value is differentiable in ``state.r`` through the whole pipeline
(the device moves, the FFTs and the transpose are all torch operations),
so the sampler takes the bias force by autograd, as the reference takes
it by ``jax.vjp`` through its islands.  ``bias_virial`` is the k-space
virial.  Plain PyTorch on every device: the reference runs its mesh CV as
XLA, not as a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.state import System
from ..cv.mesh import axis_stencil
from ..ops.packed import PackedSpec, PackedState


# the fixed-point scale of the deterministic scatter: a step of 2^-40
# (9e-13) against |rho| up to 2^23, far below the f32 rounding of rho
_FIXED = 2.0 ** 40


class _FixedPointScatter(torch.autograd.Function):
    """rho (size,) = the sum of ``val`` at ``idx``, added as 64-bit
    integers of ``val`` · 2^40: integer additions give the same bits in any
    order, where ``index_add``'s float atomic adds on a GPU land in a
    different order every call.  The backward is ``index_add``'s: the
    gradient at each entry's node."""

    @staticmethod
    def forward(ctx, idx, val, size: int):
        ctx.save_for_backward(idx)
        q = torch.round(val.double() * _FIXED).to(torch.int64)
        acc = torch.zeros(size, dtype=torch.int64, device=val.device)
        return (acc.index_add_(0, idx, q).double() / _FIXED).to(
            torch.float32)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return None, grad[idx], None


class ShardedPackedMesh:
    """Mesh order parameter s = (1/N) Σ_k |ρ̂(k)|² u(k) on the x-sharded
    packed state (``cv/packed.PackedMesh``'s math, partitioned).

    Use with ``parallel.spatial.SpatialPackedEngine`` on the same
    ``devices``: the slot slabs and the ρ slabs share the shards.
    Gaussian-window mode only; orthorhombic boxes (it assigns on
    Cartesian axis fractions)."""

    def __init__(self, mesh_shape, spec: PackedSpec, devices: Sequence,
                 n_real: int, k0: float, width: float = 0.5, halo: int = 2,
                 name: str = "mesh", assign_order: int = 2):
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.spec = spec
        self.devices = [torch.device(d) for d in devices]
        self.n_real = n_real
        self.k0 = float(k0)
        self.width = float(width)
        self.halo = int(halo)
        self.name = name
        self.assign_order = int(assign_order)
        nx, ny, _ = self.mesh_shape
        n_dev = len(self.devices)
        if nx % n_dev or ny % n_dev:
            raise ValueError(f"mesh dims ({nx}, {ny}) must divide over "
                             f"{n_dev} shards")
        if spec.cells_per_dim[0] % n_dev:
            raise ValueError(f"x cell count {spec.cells_per_dim[0]} must "
                             f"divide over {n_dev} shards")
        if self.halo > nx // n_dev:
            raise ValueError(f"halo {self.halo} exceeds the local slab "
                             f"{nx // n_dev}; use a coarser mesh or fewer "
                             "shards")
        self._modes = {}

    @classmethod
    def create(cls, mesh_shape, spec: PackedSpec, devices: Sequence,
               n_real: int, k0: float, width: float = 0.5, box_L=None,
               name: str = "mesh",
               assign_order: int = 2) -> "ShardedPackedMesh":
        """The reference's ``create`` (its ``nested`` needs no counterpart:
        on the walkers × space product the walkers' states reach the CV one
        at a time): the halo is 1 + ⌈½·skin / spacing⌉ columns with
        ``box_L`` (the stencil's one column of reach, CIC or TSC, plus the
        drift between repacks), 2 without."""
        nx = int(mesh_shape[0])
        if box_L is not None:
            spacing = float(np.asarray(box_L).reshape(-1)[0]) / nx
            halo = 1 + int(math.ceil((0.5 * spec.skin) / spacing))
        else:
            halo = 2
        return cls(mesh_shape, spec, devices, n_real, k0, width=width,
                   halo=halo, name=name, assign_order=assign_order)

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _modes_of(self, k: int):
        """Shard k's integer modes (mx (nx,), my its y slab, mz (nz,)) and
        the spread nodes of its zero-weight entries, cached per shard."""
        hit = self._modes.get(k)
        if hit is None:
            nx, ny, nz = self.mesh_shape
            n_dev = len(self.devices)
            ny_l = ny // n_dev
            dev = self.devices[k]

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            my = np.fft.fftfreq(ny) * ny
            n_slots = self.spec.n_pad // n_dev
            m_ext = (nx // n_dev + 2 * self.halo) * ny * nz
            hit = self._modes[k] = (
                t(np.fft.fftfreq(nx) * nx), t(my[k * ny_l:(k + 1) * ny_l]),
                t(np.fft.fftfreq(nz) * nz),
                torch.remainder(torch.arange(n_slots, device=dev), m_ext))
        return hit

    def _slab(self, state: PackedState, k: int):
        """Shard k's slots: positions (3, n) and coefficients (n,) of the
        cells of its x planes, on its device."""
        n_dev = len(self.devices)
        cap, (cx, cy, cz) = self.spec.cap, self.spec.cells_per_dim
        cx_l = cx // n_dev
        sl = slice(k * cx_l, (k + 1) * cx_l)
        r = state.r.reshape(3, cap, cx, cy * cz)[:, :, sl].reshape(3, -1)
        w = state.attrs[self.attr_name].reshape(cap, cx, cy * cz)[:, sl]
        dev = self.devices[k]
        return r.to(dev), w.reshape(-1).to(dev)

    def _assign(self, r: torch.Tensor, w: torch.Tensor, L: torch.Tensor,
                k: int) -> torch.Tensor:
        """Shard k's halo-extended ρ slab, (nx_l + 2·halo, ny, nz)."""
        nx, ny, nz = self.mesh_shape
        nx_e = nx // len(self.devices) + 2 * self.halo
        x0 = k * (nx // len(self.devices))
        spread = self._modes_of(k)[3]
        ax = [axis_stencil((r[d] / L[d] + 0.5) * n_d, self.assign_order)
              for d, n_d in enumerate(self.mesh_shape)]
        live = w != 0.0
        idx, val = [], []
        for cx_, wx in ax[0][1]:
            lx = ax[0][0] + cx_ - x0 + self.halo
            inside = live & (lx >= 0) & (lx < nx_e)
            for cy_, wy in ax[1][1]:
                iy = torch.remainder(ax[1][0] + cy_, ny)
                for cz_, wz in ax[2][1]:
                    iz = torch.remainder(ax[2][0] + cz_, nz)
                    # a live entry past the extended slab would be a drift
                    # beyond the halo: dropped, as the reference drops it
                    idx.append(torch.where(inside, (lx * ny + iy) * nz + iz,
                                           spread))
                    val.append(torch.where(inside, w * wx * wy * wz, 0.0))
        rho = _FixedPointScatter.apply(torch.cat(idx), torch.cat(val),
                                       nx_e * ny * nz)
        return rho.reshape(nx_e, ny, nz)

    def _spectrum(self, state: PackedState) -> list:
        """Every shard's |ρ̂|² over its y slab, (nx, ny_l, nz), with the
        box's L on its device."""
        n_dev = len(self.devices)
        h = self.halo
        ny_l = self.mesh_shape[1] // n_dev
        ext = []
        for k in range(n_dev):
            r, w = self._slab(state, k)
            ext.append(self._assign(r, w, state.box.L.to(self.devices[k]),
                                    k))
        # fold: the left neighbour's right halo onto my first h columns,
        # the right neighbour's left halo onto my last h (they may overlap
        # on a slab narrower than 2 h)
        slabs = []
        for k in range(n_dev):
            dev = self.devices[k]
            left, right = ext[(k - 1) % n_dev], ext[(k + 1) % n_dev]
            rho = ext[k][h:-h]
            n = rho.shape[0]
            rho = (rho + F.pad(left[-h:].to(dev), (0, 0, 0, 0, 0, n - h))
                   + F.pad(right[:h].to(dev), (0, 0, 0, 0, n - h, 0)))
            slabs.append(torch.fft.fftn(rho.to(torch.complex64), dim=(1, 2)))
        out = []
        for j in range(n_dev):
            dev = self.devices[j]
            rk = torch.cat([s[:, j * ny_l:(j + 1) * ny_l].to(dev)
                            for s in slabs])
            rk = torch.fft.fft(rk, dim=0)
            out.append(rk.real * rk.real + rk.imag * rk.imag)
        return out

    def _kd2(self, L: torch.Tensor, k: int) -> torch.Tensor:
        """(3, nx, ny_l, nz) (2π m_d / L_d)² of shard k's wave vectors."""
        mx, my, mz = self._modes_of(k)[:3]
        g = torch.meshgrid(mx, my, mz, indexing="ij")
        return torch.stack([(2.0 * math.pi * g[d] / L[d]) ** 2
                            for d in range(3)])

    def _sharded_sum(self, state: PackedState, kind: str) -> torch.Tensor:
        if state.box.tilt is not None:
            raise ValueError("ShardedPackedMesh assigns on Cartesian axis "
                             "fractions: a tilted box needs PackedMesh")
        total = None
        for k, p in enumerate(self._spectrum(state)):
            L = state.box.L.to(self.devices[k])
            kd2 = self._kd2(L, k)
            kmag = torch.sqrt(torch.sum(kd2, dim=0))
            u = torch.exp(-0.5 * ((kmag - self.k0) / self.width) ** 2)
            if kind == "virial":
                safe = torch.where(kmag > 0.0, kmag, 1.0)
                wgt = (-((kmag - self.k0) / self.width ** 2) * u
                       / safe)[None] * kd2
                wgt = torch.where(kmag[None] == 0.0, 0.0, wgt)
                part = torch.sum(p[None] * wgt, dim=(1, 2, 3))
            else:
                part = torch.sum(p * torch.where(kmag == 0.0, 0.0, u))
            part = part.to(self.devices[0])
            total = part if total is None else total + part
        return total / self.n_real

    def value(self, state: PackedState, system: System) -> torch.Tensor:
        return self._sharded_sum(state, "value")

    def bias_virial(self, state: PackedState, system: System,
                    dVds: torch.Tensor) -> torch.Tensor:
        """Per-axis k-space virial W_d = dVds·(1/N)·Σ |ρ̂|²·u'(|k|)·k_d²/|k|
        (``cv/mesh.py``)."""
        return dVds * self._sharded_sum(state, "virial")

