"""The 2-D spatial decomposition: the packed cell grid cut over x and y
(counterpart of ``metadyn_tpu/parallel/spatial2d.py``).

The reference shards the x and y cell axes over a ``("spacex",
"spacey")`` mesh, so the shard count grows to cx·cy and the ghost share
falls toward the blocks' surface over their volume.  Here, as in the
x-slab module (``parallel/spatial.py``), the mesh is an explicit list of
n_x·n_y torch devices (shard (ix, iy) is ``devices[ix·n_y + iy]``, the
reference's row-major mesh; shards may share a device), the state stays
global on ``devices[0]``, and an island runs a kernel on each shard's
halo-extended grid and writes the interior back:

- **The extended grid** of shard (ix, iy) is its (cx_l, cy_l, cz) block of
  cells with one ghost plane per side on x and on y: (cx_l + 2, cy_l + 2,
  cz), gathered in one ``index_select`` per axis from the global columns.
  The reference moves the ghosts in two hops (x halos, then the y halos of
  the x-extended arrays, which carry the corners); one gather of the
  global x planes, then of the global y planes, is the same grid, corners
  included.  Across the periodic seams the x row shifts by ∓Lx and the y
  row by ∓Ly, so a corner ghost takes both shifts.
- **The kernels** run unchanged on ``spec_ext``: they wrap every axis by
  cell index with a shift h·u, and on the extended grid the wrapped pairs
  join ghost planes only, whose rows are dropped and whose cells are
  masked (the x-slab module's argument, on both sharded axes).  Values and
  energies weight each ordered pair by its i cell (``cell_mask``: 1 on the
  interior, 0 on the ghost planes of x and y), so the shards' sums add to
  the global ones.
- **Migration** is the slab module's sharded repack on the blocks: z wraps
  first, x and y in transit across their seams with the paired image
  updates, and the 27-offset arrival ranking on the extended grid keeps
  the single-device order, so the slots equal
  ``ops.packed.repack_incremental``'s bit for bit.

Orthorhombic boxes only, as in the reference (``:205``): the y seam
shifts by (0, Ly, 0), which a tilted cell's a2 is not.

Islands (reference line numbers in ``metadyn_tpu/parallel/spatial2d.py``):
:func:`make_sharded_lj_force_2d` (``:79``), :func:`make_sharded_order_
parts_2d` (``:224``), :func:`make_sharded_repack_2d` (``:343``), and
:class:`SpatialPackedEngine2D` (``:533``) behind the packed engine's
protocol.  The engine has no lagged islands, as the reference's has none:
``mts_lag`` on it runs the fused kernel on the global state.  The pencil-
FFT mesh CV on the same blocks is ``parallel/mesh2d.ShardedPackedMesh2D``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.packed_engine import PackedEngine
from ..ops.packed import PackedSpec, PackedState
from .spatial import (
    Slabs, make_sharded_lj_force, make_sharded_order_parts,
    make_sharded_repack,
)


class Blocks(Slabs):
    """The (n_x, n_y) block geometry of ``spec`` over ``devices`` (n_x·n_y
    of them, one per shard, row-major).  ``cx % n_x == 0`` and ``cy % n_y
    == 0`` are required, as in the reference.  The interface is
    :class:`parallel.spatial.Slabs`'s, so the slab module's islands run on
    the blocks unchanged."""

    # the sharded cell axes: x and y
    sharded = (0, 1)

    def __init__(self, spec: PackedSpec, devices: Sequence, shape):
        n_x, n_y = (int(n) for n in shape)
        self.devices = [torch.device(d) for d in devices]
        if n_x < 1 or n_y < 1 or len(self.devices) != n_x * n_y:
            raise ValueError(f"a ({n_x}, {n_y}) mesh needs {n_x * n_y} "
                             f"devices, got {len(self.devices)}")
        cx, cy, cz = spec.cells_per_dim
        if cx % n_x or cy % n_y:
            raise ValueError(f"cells ({cx},{cy}) must divide over the "
                             f"({n_x},{n_y}) mesh")
        self.spec = spec
        self.shape = (n_x, n_y)
        self.n_dev = n_x * n_y
        self.cx_l, self.cy_l = cx // n_x, cy // n_y
        self.C_l = self.cx_l * self.cy_l * cz
        self.C_e = (self.cx_l + 2) * (self.cy_l + 2) * cz
        self.ext_dims = (self.cx_l + 2, self.cy_l + 2, cz)
        self.loc_dims = (self.cx_l, self.cy_l, cz)
        self.spec_ext = dataclasses.replace(spec, cells_per_dim=self.ext_dims)
        self.planes, self.rows, self.interior = [], [], []
        m = np.zeros(self.ext_dims, np.float32)
        m[1:-1, 1:-1] = 1.0
        for k, dev in enumerate(self.devices):
            ix, iy = divmod(k, n_y)
            for idx, n, n_l, i in ((self.planes, cx, self.cx_l, ix),
                                   (self.rows, cy, self.cy_l, iy)):
                lo = i * n_l
                idx.append(torch.tensor(
                    [(lo - 1) % n, *range(lo, lo + n_l), (lo + n_l) % n],
                    device=self.devices[0]))
            self.interior.append(torch.as_tensor(m.reshape(-1), device=dev))

    @staticmethod
    def seam_lengths(box):
        """The box lengths :meth:`extend` shifts by: (…, 3), Lx and Ly."""
        return box.L

    def local_cells(self, f3: torch.Tensor, k: int) -> tuple:
        """The cells of fractional rows ``f3`` (3, …) in shard k's frame:
        extended-local x and y (interiors 1 .. cx_l, 1 .. cy_l), z
        clamped."""
        ix, iy = divmod(k, self.shape[1])
        cx, cy, cz = self.spec.cells_per_dim
        return (
            torch.floor((f3[0] + 0.5) * cx).to(torch.int32)
            - ix * self.cx_l + 1,
            torch.floor((f3[1] + 0.5) * cy).to(torch.int32)
            - iy * self.cy_l + 1,
            torch.clamp(torch.floor((f3[2] + 0.5) * cz).to(torch.int32),
                        0, cz - 1))

    def extend(self, cols: torch.Tensor, k: int, L,
               image_row=None) -> torch.Tensor:
        """Shard k's halo-extended columns: (…, R, Npad) f32 global columns
        (rows 0 and 1 the x and y coordinates; a leading walker dimension
        where the state is a walker batch) → (…, R, cap·C_e) on
        ``devices[k]``.  Across the periodic seams the x row shifts by ∓Lx
        and the y row by ∓Ly (``L`` (…, 3), a device tensor: one box per
        walker), and, with ``image_row`` (the x image counter, as f32; the
        y counter follows it), the image counters by ±1."""
        lead, R = cols.shape[:-2], cols.shape[-2]
        cap, (cx, cy, cz) = self.spec.cap, self.spec.cells_per_dim
        ext = (cols.reshape(*lead, R, cap, cx, cy, cz)
               .index_select(-3, self.planes[k])
               .index_select(-2, self.rows[k]))
        L = torch.as_tensor(L, dtype=cols.dtype, device=cols.device)
        L = L.reshape(*lead, 1, 1, 1, 3)
        ix, iy = divmod(k, self.shape[1])
        n_x, n_y = self.shape
        for a, i, n in ((0, ix, n_x), (1, iy, n_y)):
            ghost = [(0, -1.0)] if i == 0 else []
            if i == n - 1:
                ghost.append((-1, 1.0))
            for plane, sign in ghost:
                # (…, row, cap, x, y, z): the ghost plane of axis a
                at = ((slice(None),) * (a + 1) + (plane,)
                      + (slice(None),) * (2 - a))
                ext[(..., a) + at] += sign * L[..., a]
                if image_row is not None:
                    ext[(..., image_row + a) + at] -= sign
        return ext.reshape(*lead, R, -1).to(self.devices[k])

    def interior_of(self, ext: torch.Tensor) -> torch.Tensor:
        """(…, cap·C_e) → the interior cells, (…, cap, cx_l, cy_l, cz)."""
        return ext.reshape(*ext.shape[:-1], self.spec.cap,
                           *self.ext_dims)[..., 1:-1, 1:-1, :]

    def gather(self, parts: list, extended: bool = True) -> torch.Tensor:
        """Shards' outputs → one global (…, Npad) tensor on ``devices[0]``,
        each shard's interior written in place: extended (…, cap·C_e)
        outputs, or with ``extended=False`` interiors already cut,
        (…, cap·C_l)."""
        lead = parts[0].shape[:-1]
        cap = self.spec.cap
        out = torch.empty((*lead, cap, *self.spec.cells_per_dim),
                          dtype=parts[0].dtype, device=self.devices[0])
        for k, p in enumerate(parts):
            ix, iy = divmod(k, self.shape[1])
            loc = (self.interior_of(p) if extended
                   else p.reshape(*lead, cap, *self.loc_dims))
            out[..., ix * self.cx_l:(ix + 1) * self.cx_l,
                iy * self.cy_l:(iy + 1) * self.cy_l, :] = \
                loc.to(self.devices[0])
        return out.reshape(*lead, -1)


def _orthorhombic(fn):
    """``fn(state, …)`` that refuses a tilted box, as the reference's 2-D
    islands assert (``:205``)."""
    def checked(state, *args):
        if state.box.tilt is not None:
            raise ValueError("2-D DD: orthorhombic only")
        return fn(state, *args)

    return checked


def make_sharded_lj_force_2d(spec: PackedSpec, devices: Sequence, shape,
                             with_energy: bool = False):
    """``force(state) -> state`` with the cell grid cut into (n_x, n_y)
    blocks: kernel 1 on each extended grid, forces only, or with the energy
    and virial under the interior mask summed over the shards in order
    (the reference's ``:79-221``; the contract of
    ``parallel.spatial.make_sharded_lj_force``)."""
    return _orthorhombic(make_sharded_lj_force(
        spec, devices, with_energy=with_energy,
        geometry=Blocks(spec, devices, shape)))


def make_sharded_order_parts_2d(cvs, spec: PackedSpec, devices: Sequence,
                                shape):
    """The fused order-CV path's ``(values_fn, force_fn)`` on the blocks:
    kernel 2 under the interior mask, kernel 3 with the ghost rows dropped
    (the reference's ``:224-323``)."""
    values_fn, force_fn = make_sharded_order_parts(
        cvs, spec, devices, geometry=Blocks(spec, devices, shape))
    return _orthorhombic(values_fn), _orthorhombic(force_fn)


def make_sharded_repack_2d(spec: PackedSpec, devices: Sequence, shape):
    """``repack(state) -> (state, bad)`` on the blocks, bit for bit
    ``ops.packed.repack_incremental`` (the reference's ``:343-530``)."""
    return _orthorhombic(make_sharded_repack(
        spec, devices, geometry=Blocks(spec, devices, shape)))


class SpatialPackedEngine2D(PackedEngine):
    """PackedEngine with the cell grid cut into (n_x, n_y) blocks over
    ``devices`` (n_x·n_y torch devices, row-major, which may repeat): the
    pair force and the migration as islands, and through
    :meth:`make_order_parts` the order-CV sweeps, so ``MetadSampler``,
    ``WalkerSampler``, ``FluxTemperedSampler`` and the packed CVs run on
    the global state on ``devices[0]`` unchanged.

    As on ``parallel.spatial.SpatialPackedEngine``: the inner-step pair
    force runs forces only and the energy and virial at the stride-end
    refresh (every call with ``with_energy``), each shard's under the
    interior mask; ``order_pallas`` (default on) runs the order sweeps as
    islands; ``nested=True`` (walkers × 2-D space) takes a walker batch,
    every shard's extended grid holding all W walkers, so kernel 1 runs
    once per shard for the whole batch, and the repack runs walker by
    walker after one read of the (W,) repack flags.  There are no lagged
    islands (the reference's engine has none): ``mts_lag`` runs the fused
    kernel on the global state."""

    def __init__(self, spec: PackedSpec, devices: Sequence, shape,
                 rebuild_every: int = 1, mass: float = 1.0,
                 nested: bool = False, always_repack: bool = False,
                 with_energy: bool = False, order_pallas: bool = True):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("SpatialPackedEngine2D: no devices")
        super().__init__(spec, devices[0], rebuild_every=rebuild_every,
                         mass=mass, with_energy=with_energy,
                         always_repack=always_repack)
        self.devices = devices
        self.shape = tuple(int(n) for n in shape)
        self._force = make_sharded_lj_force_2d(spec, devices, self.shape,
                                               with_energy=with_energy)
        self._force_e = make_sharded_lj_force_2d(spec, devices, self.shape,
                                                 with_energy=True)
        self._sharded_repack = make_sharded_repack_2d(spec, devices,
                                                      self.shape)
        self.order_pallas = bool(order_pallas)
        self.nested = bool(nested)
        # a walker batch only on the product mesh, as in the reference
        self.walker_batch = self.nested

    def _pair_force(self, state: PackedState,
                    with_energy: bool) -> PackedState:
        return (self._force_e if with_energy else self._force)(state)

    def make_order_parts(self, cvs):
        """(values_fn, force_fn) of the order-CV islands, or None to keep
        the sweeps on the global state."""
        if not self.order_pallas:
            return None
        return make_sharded_order_parts_2d(list(cvs), self.spec,
                                           self.devices, self.shape)

    def _repack_one(self, state: PackedState):
        return self._sharded_repack(state)
