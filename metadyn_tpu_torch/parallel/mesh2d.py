"""The pencil-decomposed particle-mesh S(k) CV on the 2-D blocks
(counterpart of ``metadyn_tpu/parallel/mesh2d.py``): the twin of
``parallel/mesh.ShardedPackedMesh`` beside the (n_x, n_y) cell blocks of
``parallel/spatial2d.py``.

Per shard (ix, iy) (its device ``devices[ix·n_y + iy]``; shards may share
one):

1. **Assignment with halo shells.**  The slots of the shard's cell block
   are assigned (CIC, ``assign_order`` 2, or TSC, 3) into its ρ block of
   ``nx / n_x`` × ``ny / n_y`` columns extended by ``halo = (hx, hy)``
   columns per side on x and y (z whole), at the mesh coordinate (r_d /
   L_d + ½)·n_d of the current box, with no wrap along x or y: a slot that
   drifted past a seam lands in a halo.  The zero-weight (vacant) slots'
   entries go to node j mod M of their slot j, and the scatter sums in
   64-bit fixed point (``cv/mesh.FixedPointScatter``), so two runs agree to
   the bit.
2. **Two-hop halo fold.**  The x halos (over the whole extended y extent,
   so corner mass rides into the x neighbour's y halo) are added into the
   ring neighbours' interior columns, then the y halos of the x interior:
   after the folds each shard holds its block of the global ρ exactly.
3. **Pencil FFT.**  An FFT over z per shard; the first transpose (the
   reference's ``all_to_all`` over ``spacey``: shard (ix, jy) gathers the
   y blocks of its row of shards and keeps its jy-th z slab), an FFT over
   y; the second transpose (over ``spacex``: shard (jx, jy) gathers the x
   blocks of its column and keeps its jx-th y slab), an FFT over x.
4. **k-space reduction.**  Σ |ρ̂|²·u(|k|) over each shard's (y, z) k-tile,
   the shards' partial sums added in shard order (the reference's
   ``psum``), so repeats are bit for bit.

The value is differentiable in ``state.r`` through the whole pipeline, so
the sampler takes the bias force by autograd (the reference differentiates
its island by ``jax.vjp``), and ``bias_virial`` is the k-space virial.
Plain PyTorch on every device, as the reference runs its mesh CV as XLA.
Gaussian-window mode only; orthorhombic boxes.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..core.state import System
from ..cv.mesh import FixedPointScatter, axis_stencil
from ..ops.packed import PackedSpec, PackedState


class ShardedPackedMesh2D:
    """Mesh order parameter s = (1/N) Σ_k |ρ̂(k)|² u(k) on the (x, y)-
    sharded packed state (``cv/packed.PackedMesh``'s math, in pencils).

    Use with ``parallel.spatial2d.SpatialPackedEngine2D`` on the same
    ``devices`` and ``shape``: the slot blocks and the ρ pencils share the
    shards.  On the walkers × 2-D space product the walkers' states reach
    the CV one at a time, so the reference's ``nested`` needs no
    counterpart."""

    def __init__(self, mesh_shape, spec: PackedSpec, devices: Sequence,
                 shape, n_real: int, k0: float, width: float = 0.5,
                 halo=(2, 2), name: str = "mesh", assign_order: int = 2):
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.spec = spec
        self.devices = [torch.device(d) for d in devices]
        self.shape = tuple(int(n) for n in shape)
        self.n_real = n_real
        self.k0 = float(k0)
        self.width = float(width)
        self.halo = tuple(int(h) for h in halo)
        self.name = name
        self.assign_order = int(assign_order)
        nx, ny, nz = self.mesh_shape
        n_x, n_y = self.shape
        cx, cy, _ = spec.cells_per_dim
        if len(self.devices) != n_x * n_y:
            raise ValueError(f"a ({n_x}, {n_y}) mesh needs {n_x * n_y} "
                             f"devices, got {len(self.devices)}")
        if nx % n_x or ny % n_y:
            raise ValueError(f"mesh dims ({nx},{ny}) must divide over the "
                             f"({n_x},{n_y}) mesh")
        # the transposes split z over n_y and y over n_x
        if nz % n_y or ny % n_x:
            raise ValueError(f"pencil transposes need nz % {n_y} == 0 and "
                             f"ny % {n_x} == 0 (got nz={nz}, ny={ny})")
        if cx % n_x or cy % n_y:
            raise ValueError(f"cells ({cx},{cy}) must divide over the "
                             f"({n_x},{n_y}) mesh")
        for d, (h, n_d, n_dev) in enumerate(zip(self.halo, (nx, ny),
                                                 self.shape)):
            if h > n_d // n_dev:
                raise ValueError(f"halo {h} exceeds local extent "
                                 f"{n_d // n_dev} on axis {d}; use a "
                                 "coarser mesh or fewer devices")
        self._cache = {}

    @classmethod
    def create(cls, mesh_shape, spec: PackedSpec, devices: Sequence, shape,
               n_real: int, k0: float, width: float = 0.5, box_L=None,
               name: str = "mesh",
               assign_order: int = 2) -> "ShardedPackedMesh2D":
        """The reference's ``create``: the halo on each sharded axis d is
        1 + ⌈½·skin / spacing_d⌉ columns with ``box_L`` (a scalar, or one
        length per axis), 2 without."""
        mesh_shape = tuple(int(x) for x in mesh_shape)
        halos = []
        for d in range(2):
            if box_L is not None:
                bl = np.asarray(box_L, np.float64).reshape(-1)
                spacing = float(bl[d] if bl.size > 1 else bl[0]) \
                    / mesh_shape[d]
                halos.append(1 + int(math.ceil((0.5 * spec.skin) / spacing)))
            else:
                halos.append(2)
        return cls(mesh_shape, spec, devices, shape, n_real, k0, width=width,
                   halo=tuple(halos), name=name, assign_order=assign_order)

    @property
    def attr_name(self) -> str:
        return f"mesh_{self.name}"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _of(self, k: int):
        """Shard k's (mx (nx,), my its y k-slab, mz its z k-slab) and the
        spread nodes of its zero-weight entries, cached per shard."""
        hit = self._cache.get(k)
        if hit is None:
            nx, ny, nz = self.mesh_shape
            n_x, n_y = self.shape
            jx, jy = divmod(k, n_y)
            hx, hy = self.halo
            dev = self.devices[k]

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            my = np.fft.fftfreq(ny) * ny
            mz = np.fft.fftfreq(nz) * nz
            ty, tz = ny // n_x, nz // n_y
            n_slots = self.spec.n_pad // (n_x * n_y)
            m_ext = (nx // n_x + 2 * hx) * (ny // n_y + 2 * hy) * nz
            hit = self._cache[k] = (
                t(np.fft.fftfreq(nx) * nx), t(my[jx * ty:(jx + 1) * ty]),
                t(mz[jy * tz:(jy + 1) * tz]),
                torch.remainder(torch.arange(n_slots, device=dev), m_ext))
        return hit

    def _block(self, state: PackedState, k: int):
        """Shard k's slots: positions (3, n) and coefficients (n,) of the
        cells of its block, on its device."""
        n_x, n_y = self.shape
        ix, iy = divmod(k, n_y)
        cap, (cx, cy, cz) = self.spec.cap, self.spec.cells_per_dim
        cx_l, cy_l = cx // n_x, cy // n_y
        sx = slice(ix * cx_l, (ix + 1) * cx_l)
        sy = slice(iy * cy_l, (iy + 1) * cy_l)
        r = state.r.reshape(3, cap, cx, cy, cz)[:, :, sx, sy].reshape(3, -1)
        w = state.attrs[self.attr_name].reshape(cap, cx, cy, cz)[:, sx, sy]
        dev = self.devices[k]
        return r.to(dev), w.reshape(-1).to(dev)

    def _assign(self, r: torch.Tensor, w: torch.Tensor, L: torch.Tensor,
                k: int) -> torch.Tensor:
        """Shard k's halo-extended ρ block, (nx_l + 2hx, ny_l + 2hy, nz)."""
        nx, ny, nz = self.mesh_shape
        n_x, n_y = self.shape
        ix, iy = divmod(k, n_y)
        hx, hy = self.halo
        nx_e, ny_e = nx // n_x + 2 * hx, ny // n_y + 2 * hy
        x0, y0 = ix * (nx // n_x), iy * (ny // n_y)
        spread = self._of(k)[3]
        ax = [axis_stencil((r[d] / L[d] + 0.5) * n_d, self.assign_order)
              for d, n_d in enumerate(self.mesh_shape)]
        live = w != 0.0
        idx, val = [], []
        for cx_, wx in ax[0][1]:
            lx = ax[0][0] + cx_ - x0 + hx
            in_x = live & (lx >= 0) & (lx < nx_e)
            for cy_, wy in ax[1][1]:
                ly = ax[1][0] + cy_ - y0 + hy
                inside = in_x & (ly >= 0) & (ly < ny_e)
                for cz_, wz in ax[2][1]:
                    iz = torch.remainder(ax[2][0] + cz_, nz)
                    # a live entry past the extended block would be a drift
                    # beyond the halo: dropped, as the reference drops it
                    idx.append(torch.where(
                        inside, (lx * ny_e + ly) * nz + iz, spread))
                    val.append(torch.where(inside, w * wx * wy * wz, 0.0))
        rho = FixedPointScatter.apply(torch.cat(idx), torch.cat(val),
                                      nx_e * ny_e * nz)
        return rho.reshape(nx_e, ny_e, nz)

    @staticmethod
    def _fold(ext: list, h: int, axis: int, ring) -> list:
        """Each block's halos of width ``h`` on ``axis`` added into its
        ring neighbours' interiors (``ring(k)`` = (left, right) shard):
        the left neighbour's high halo onto my first h columns, the right
        neighbour's low halo onto my last h (they may overlap on a block
        narrower than 2h)."""
        out = []
        for k, e in enumerate(ext):
            left, right = ring(k)
            rho = e.narrow(axis, h, e.shape[axis] - 2 * h)
            n = rho.shape[axis]
            lo = ext[left].narrow(axis, e.shape[axis] - h, h).to(rho.device)
            hi = ext[right].narrow(axis, 0, h).to(rho.device)
            pad_lo = [0, 0] * (2 - axis) + [0, n - h]
            pad_hi = [0, 0] * (2 - axis) + [n - h, 0]
            out.append(rho + torch.nn.functional.pad(lo, pad_lo)
                       + torch.nn.functional.pad(hi, pad_hi))
        return out

    def _spectrum(self, state: PackedState) -> list:
        """Every shard's |ρ̂|² over its (y, z) k-tile, (nx, ny/n_x,
        nz/n_y)."""
        n_x, n_y = self.shape
        hx, hy = self.halo
        nx, ny, nz = self.mesh_shape
        ext = []
        for k in range(n_x * n_y):
            r, w = self._block(state, k)
            ext.append(self._assign(r, w, state.box.L.to(self.devices[k]),
                                    k))

        def ring_x(k):
            ix, iy = divmod(k, n_y)
            return ((ix - 1) % n_x) * n_y + iy, ((ix + 1) % n_x) * n_y + iy

        def ring_y(k):
            ix, iy = divmod(k, n_y)
            return ix * n_y + (iy - 1) % n_y, ix * n_y + (iy + 1) % n_y

        rho = self._fold(self._fold(ext, hx, 0, ring_x), hy, 1, ring_y)
        # z pencils → y pencils: gather y along my row, keep my z slab
        tz, ty = nz // n_y, ny // n_x
        zk = [torch.fft.fft(p.to(torch.complex64), dim=2) for p in rho]
        yk = []
        for k in range(n_x * n_y):
            ix, jy = divmod(k, n_y)
            dev = self.devices[k]
            yk.append(torch.fft.fft(torch.cat(
                [zk[ix * n_y + j][:, :, jy * tz:(jy + 1) * tz].to(dev)
                 for j in range(n_y)], dim=1), dim=1))
        # y pencils → x pencils: gather x along my column, keep my y slab
        out = []
        for k in range(n_x * n_y):
            jx, jy = divmod(k, n_y)
            dev = self.devices[k]
            rk = torch.fft.fft(torch.cat(
                [yk[i * n_y + jy][:, jx * ty:(jx + 1) * ty].to(dev)
                 for i in range(n_x)], dim=0), dim=0)
            out.append(rk.real * rk.real + rk.imag * rk.imag)
        return out

    def _kd2(self, L: torch.Tensor, k: int) -> torch.Tensor:
        """(3, nx, ny/n_x, nz/n_y) (2π m_d / L_d)² of shard k's wave
        vectors."""
        g = torch.meshgrid(*self._of(k)[:3], indexing="ij")
        return torch.stack([(2.0 * math.pi * g[d] / L[d]) ** 2
                            for d in range(3)])

    def _sharded_sum(self, state: PackedState, kind: str) -> torch.Tensor:
        if state.box.tilt is not None:
            raise ValueError("ShardedPackedMesh2D assigns on Cartesian axis "
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
