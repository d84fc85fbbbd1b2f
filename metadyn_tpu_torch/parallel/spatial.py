"""Spatial domain decomposition: the packed cell grid cut into x-slabs
(counterpart of ``metadyn_tpu/parallel/spatial.py``, the 1-D slab half of
the reference's decomposition).

The reference shards the (cap, cx, cy, cz) slot layout along the x cell
axis over a ``"space"`` mesh axis and runs the halo-structured operations
as ``shard_map`` islands; everything else (the integrator, the CV
reductions, the bias grid) stays global and GSPMD shards it.  Here the
mesh is an explicit list of ``n_dev`` torch devices, and:

- **The state stays global.**  It keeps its (3, Npad) layout on
  ``devices[0]``, so the integrator, the CVs, the bias and the sampler run
  on it unchanged.
- **An island** cuts the (cap, C) view into ``n_dev`` contiguous x-slabs of
  ``cx_l = cx / n_dev`` planes, extends slab k with its ring neighbours'
  boundary planes (the reference's two ``ppermute`` per side) into a
  (cap, cx_l + 2, cy, cz) grid on ``devices[k]``, runs the kernel there on
  ``spec_ext`` (the global box with ``cx_l + 2`` x planes), keeps the
  interior planes and writes them back in place.  Coordinates crossing the
  periodic seam shift by ∓Lx in transit (the x lattice vector a1 = (Lx, 0,
  0) under the upper-triangular cell matrix, tilted or not), so the pair
  math stays absolute.  Lx is read from the device box: an NPT box moves
  every step, and its host floats are gone.
- **A ``psum``** becomes the sum of the shards' partial sums in shard
  order, so repeats are bit for bit.
- **Shards may share a device.**  The card's count is 1, and the reference
  tests its islands on virtual CPU devices; here any shard may sit on any
  device, so one card runs the halo exchange, the seam shifts, the
  interior masks, the sharded migration and the masked kernels with 1 or 2
  shards.  Each extended grid is one gather of the global columns; on one
  device nothing crosses devices.

Why the ghost discards are exact here (the reference's proofs rest on its
Newton-halved kernels, which these are not): the port's staged kernels
visit every ordered pair from its i row.  A row on an interior plane has
all its partners in the extended grid, so its force is complete; ghost
rows are dropped.  The pairs that wrap x on the extended grid (its x axis
is not periodic: the kernels wrap it with a shift of Lx all the same) join
the two ghost planes only, whose rows are dropped and whose cells are
masked.  Values and energies weight each ordered pair by its i cell
(``cell_mask``: 1 on the interior, 0 on the ghost planes), so each pair
counts on exactly one shard and the shards' sums add to the global ones.

Islands (reference line numbers in ``metadyn_tpu/parallel/spatial.py``):

1. :func:`make_sharded_lj_force` (``:141``): kernel 1 on each extended grid,
   forces only, or with the energy and virial under the interior mask.
2. :func:`make_sharded_order_parts` (``:324``): kernel 2 with the mask and
   kernel 3 on each extended grid, the fused order-CV path's
   ``(values_fn, force_fn)``.
3. :func:`make_sharded_lagged_parts` (``:486``): kernel 4 in its monomial
   mode with the mask, the lagged multiple-time-stepping path.
4. :func:`make_sharded_repack` (``:601``): migration with ghost-plane
   ownership hand-off, bit for bit the single-device ``repack_incremental``.

:class:`SpatialPackedEngine` (``:813``) packages them behind the packed
engine's protocol.  On a CUDA device every island runs the kernels through
their wrappers, which launch or raise; on the CPU the wrappers run the
plain versions (``--device cpu`` runs virtual shards of the CPU, as the
reference's tests run virtual CPU devices).

With ``nested=True`` (the walkers × space product, ``parallel/
walkers.py`` on the slab engine) the pair-force island and the migration
take a walker batch: every shard's extended grid holds all W walkers,
each in its own box, and kernel 1 runs once per shard for the whole
batch.  The distributed mesh CV on the same slabs is ``parallel/
mesh.ShardedPackedMesh``.  The 2-D decomposition (``parallel/
spatial2d.py``) runs these islands on its blocks through their
``geometry`` argument: a ``Blocks`` in place of :class:`Slabs`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..bias.metad import bias_value_and_grad
from ..core.packed_engine import PackedEngine
from ..cv.packed_order import _tree_add
from ..ops.packed import (
    OFFSETS, VACANT_X, PackedSpec, PackedState, _cart3, _frac3,
)
from ..ops.packed_cuda import packed_lj_force_cuda
from ..ops.packed_fused_cuda import fused_lj_order_force_cuda
from ..ops.packed_order_cuda import order_force_cuda, order_values_cuda


def _tree_to(t, device):
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_to(x, device) for x in t)
    return t.to(device) if isinstance(t, torch.Tensor) else t


class Slabs:
    """The x-slab geometry of ``spec`` over ``devices`` (one shard each).

    ``cx % n_dev == 0`` is required, as in the reference.  Shard k owns the
    global x planes ``k·cx_l .. (k+1)·cx_l − 1``; its extended grid adds the
    plane before and the plane after (mod cx)."""

    def __init__(self, spec: PackedSpec, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        n_dev = len(self.devices)
        cx, cy, cz = spec.cells_per_dim
        if n_dev < 1 or cx % n_dev:
            raise ValueError(f"x cell count {cx} must divide over {n_dev} "
                             "devices")
        self.spec = spec
        self.n_dev = n_dev
        self.cx_l = cx // n_dev
        self.plane = cy * cz
        self.C_l = self.cx_l * self.plane
        self.C_e = (self.cx_l + 2) * self.plane
        self.spec_ext = dataclasses.replace(
            spec, cells_per_dim=(self.cx_l + 2, cy, cz))
        self.ext_dims = (self.cx_l + 2, cy, cz)
        self.loc_dims = (self.cx_l, cy, cz)
        self.planes = []
        self.interior = []
        for k, dev in enumerate(self.devices):
            lo = k * self.cx_l
            idx = [(lo - 1) % cx, *range(lo, lo + self.cx_l),
                   (lo + self.cx_l) % cx]
            self.planes.append(torch.tensor(idx, device=self.devices[0]))
            m = np.zeros((self.cx_l + 2, self.plane), np.float32)
            m[1:-1] = 1.0
            self.interior.append(torch.as_tensor(m.reshape(-1), device=dev))

    def extend(self, cols: torch.Tensor, k: int, Lx,
               image_row: Optional[int] = None) -> torch.Tensor:
        """Shard k's halo-extended columns: (…, R, Npad) f32 global columns
        (row 0 the x coordinate; a leading walker dimension where the
        state is a walker batch) → (…, R, cap·C_e) on ``devices[k]``, its
        x planes between its ring neighbours' boundary planes.  Across the
        periodic seam the x row shifts by ∓Lx (a device tensor, one per
        walker: the box may move), and ``image_row`` (the x image counter,
        as f32) by ±1, so unwrapped coordinates stay put."""
        lead, R = cols.shape[:-2], cols.shape[-2]
        cx = self.spec.cells_per_dim[0]
        ext = cols.reshape(*lead, R, self.spec.cap, cx,
                           self.plane).index_select(-2, self.planes[k])
        Lx = torch.as_tensor(Lx, dtype=cols.dtype,
                             device=cols.device).reshape(*lead, 1, 1)
        if k == 0:
            ext[..., 0, :, 0, :] -= Lx
            if image_row is not None:
                ext[..., image_row, :, 0, :] += 1.0
        if k == self.n_dev - 1:
            ext[..., 0, :, -1, :] += Lx
            if image_row is not None:
                ext[..., image_row, :, -1, :] -= 1.0
        return ext.reshape(*lead, R, -1).to(self.devices[k])

    # the sharded cell axes: x
    sharded = (0,)

    def local_cells(self, f3: torch.Tensor, k: int) -> tuple:
        """The cells of fractional rows ``f3`` (3, …) in shard k's frame:
        the extended-local x plane (interior 1 .. cx_l), y and z clamped."""
        cx, cy, cz = self.spec.cells_per_dim
        lx = (torch.floor((f3[0] + 0.5) * cx).to(torch.int32)
              - k * self.cx_l + 1)
        return (lx,) + tuple(
            torch.clamp(torch.floor((f3[a] + 0.5) * c).to(torch.int32),
                        0, c - 1) for a, c in ((1, cy), (2, cz)))

    @staticmethod
    def seam_lengths(box):
        """The box lengths :meth:`extend` shifts by across the seam: Lx."""
        return box.L[..., 0]

    def interior_of(self, ext: torch.Tensor) -> torch.Tensor:
        """(…, cap·C_e) → the interior planes, (…, cap, cx_l, plane)."""
        return ext.reshape(*ext.shape[:-1], self.spec.cap, self.cx_l + 2,
                           self.plane)[..., 1:-1, :]

    def gather(self, parts: list, extended: bool = True) -> torch.Tensor:
        """Shards' outputs → one global (…, Npad) tensor on
        ``devices[0]``, each shard's interior written in place: extended
        (…, cap·C_e) outputs, or with ``extended=False`` interiors already
        cut, (…, cap·C_l)."""
        lead = parts[0].shape[:-1]
        cap, cx = self.spec.cap, self.spec.cells_per_dim[0]
        out = torch.empty((*lead, cap, cx, self.plane), dtype=parts[0].dtype,
                          device=self.devices[0])
        for k, p in enumerate(parts):
            loc = (self.interior_of(p) if extended
                   else p.reshape(*lead, cap, self.cx_l, self.plane))
            out[..., k * self.cx_l:(k + 1) * self.cx_l, :] = \
                loc.to(self.devices[0])
        return out.reshape(*lead, -1)

    def halo_states(self, state: PackedState, pid: bool = False,
                    typ: bool = False, attrs=()) -> list:
        """Every shard's PackedState on its extended grid, on its device:
        the positions and, as asked, pid, typ and the named attrs, stacked
        into one column set and extended once per shard (for a walker
        batch, every walker's at once).  Where pid or typ is not asked
        for, vacant pids and zero types fill them: the kernels of that
        layout do not read them."""
        cols = [state.r]
        if pid:
            cols.append(state.pid.to(torch.float32)[..., None, :])
        if typ:
            cols.append(state.typ.to(torch.float32)[..., None, :])
        cols = torch.cat(cols + [state.attrs[n][..., None, :]
                                 for n in attrs], dim=-2)
        out = []
        for k in range(self.n_dev):
            ext = self.extend(cols, k, self.seam_lengths(state.box))
            shape, dev = ext[..., 0, :].shape, ext.device
            r = ext[..., :3, :].contiguous()
            i = 3
            pid_k = torch.full(shape, self.spec.n_real, dtype=torch.int32,
                               device=dev)
            typ_k = torch.zeros(shape, dtype=torch.int32, device=dev)
            if pid:
                pid_k = ext[..., i, :].to(torch.int32)
                i += 1
            if typ:
                typ_k = ext[..., i, :].to(torch.int32)
                i += 1
            out.append(PackedState(
                r=r, v=r, f=r, image=r, ref_r=r, pid=pid_k, typ=typ_k,
                slot_of=torch.zeros((*shape[:-1], 0), dtype=torch.int32,
                                    device=dev),
                attrs={a: ext[..., i + j, :].contiguous()
                       for j, a in enumerate(attrs)},
                box=state.box.to(dev),
                potential_energy=state.potential_energy,
                virial=state.virial))
        return out


def _force_columns(spec: PackedSpec, plain: bool) -> dict:
    """The halo_states columns the pair force reads: the kernel's layout on
    the card (the reference's Pallas island, ``:190-204``), everything the
    plain sweep reads on the CPU."""
    bonds = [f"bp{k}" for k in range(spec.bond_slots)] if spec.has_bonds \
        else []
    attrs = (["se", "hs"] if plain else
             [k for k, need in (("se", spec.uniform_eps is None),
                                ("hs", spec.uniform_sigma is None)) if need])
    return dict(pid=spec.has_bonds, typ=spec.has_pair_table,
                attrs=attrs + bonds)


def make_sharded_lj_force(spec: PackedSpec, devices: Sequence,
                          with_energy: bool = False, geometry=None):
    """``force(state) -> state`` with the cell grid cut into x-slabs.

    Each shard runs kernel 1 (``packed_lj_force_cuda``) on its extended
    grid and keeps its interior rows.  ``with_energy``: the energy and
    virial too, each shard's under the interior mask, summed over the
    shards in order (the reference's XLA island, ``:270-278``); without,
    they keep their old values (the inner-step mode).  ``geometry``: the
    shards' halo geometry, :class:`Slabs` of ``devices`` by default (the
    2-D decomposition passes its ``spatial2d.Blocks``)."""
    slabs = geometry or Slabs(spec, devices)

    def force(state: PackedState) -> PackedState:
        cols = _force_columns(spec, state.r.device.type == "cpu")
        fs, es, ws = [], [], []
        for k, st in enumerate(slabs.halo_states(state, **cols)):
            out = packed_lj_force_cuda(
                st, slabs.spec_ext, with_energy=with_energy,
                cell_mask=slabs.interior[k] if with_energy else None)
            fs.append(out.f)
            if with_energy:
                es.append(out.potential_energy.to(slabs.devices[0]))
                ws.append(out.virial.to(slabs.devices[0]))
        f = slabs.gather(fs)
        if not with_energy:
            return state.replace(f=f)
        e, w = es[0], ws[0]
        for e_k, w_k in zip(es[1:], ws[1:]):
            e, w = e + e_k, w + w_k
        return state.replace(f=f, potential_energy=e, virial=w)

    return force


def _order_columns(state: PackedState, spec: PackedSpec,
                   pair: bool = False) -> dict:
    """The halo_states columns of the order sweeps: pid where they read it
    (the validity layout, and the plain sweeps in every layout); with
    ``pair`` (the fused kernel's plain version runs the plain pair force)
    se and hs on the CPU too."""
    plain = state.r.device.type == "cpu"
    return dict(pid=plain or not spec.sentinel,
                attrs=("se", "hs") if pair and plain else ())


def make_sharded_order_parts(cvs, spec: PackedSpec, devices: Sequence,
                             geometry=None):
    """The fused order-CV path's ``(values_fn, force_fn)`` (the contract of
    ``cv.packed_order.make_fused_order_force``) on the slabs:

      values_fn(state) -> (s_stack, (terms, None))  # kernel 2, masked
      force_fn(state, ctx, dVds) -> g               # kernel 3

    The value sums weight every ordered pair by its i cell's interior mask
    and add over the shards; the bias force keeps each shard's interior
    rows.  ``geometry``: as in :func:`make_sharded_lj_force`."""
    cvs = list(cvs)
    slabs = geometry or Slabs(spec, devices)

    def values_fn(state: PackedState):
        terms = None
        sts = slabs.halo_states(state, **_order_columns(state, spec))
        for k, st in enumerate(sts):
            t = _tree_to(order_values_cuda(st, slabs.spec_ext, cvs,
                                           cell_mask=slabs.interior[k]),
                         slabs.devices[0])
            terms = t if terms is None else _tree_add(terms, t)
        s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        return s, (terms, None)

    def force_fn(state: PackedState, ctx, dVds):
        terms, _ = ctx
        auxs = [cv.grad_aux(t, dVds[i])
                for i, (cv, t) in enumerate(zip(cvs, terms))]
        sts = slabs.halo_states(state, **_order_columns(state, spec))
        return slabs.gather([order_force_cuda(st, slabs.spec_ext, cvs,
                                              _tree_to(auxs, st.r.device))
                             for st in sts])

    return values_fn, force_fn


def make_sharded_lagged_parts(cvs, spec: PackedSpec, devices: Sequence,
                              walls=None):
    """The lagged multiple-time-stepping parts ``(seed_eval, fused_force)``
    (the contract of ``sampler.make_lagged_parts``) on the slabs.

    ``fused_force`` runs kernel 4 on each extended grid in its monomial
    mode with the interior mask (the reference's rule: the mask needs the
    monomial mode): the LJ and bias forces keep each shard's interior rows,
    the value sums add over the shards.  ``seed_eval``, the exact
    evaluation that seeds the lag, runs the order islands of
    :func:`make_sharded_order_parts`."""
    if not spec.sentinel or spec.has_bonds:
        raise ValueError("sharded mts_lag needs the lean sentinel layout")
    cvs = list(cvs)
    slabs = Slabs(spec, devices)
    values_fn, force_fn = make_sharded_order_parts(cvs, spec, devices)

    def grad_with_walls(bias, s):
        _, dVds = bias_value_and_grad(bias, s)
        if walls is not None:
            _, gw = walls.energy_and_grad(s)
            dVds = dVds + gw
        return dVds

    def seed_eval(state, bias):
        s, ctx = values_fn(state)
        return force_fn(state, ctx, grad_with_walls(bias, s)), ctx[0]

    def fused_force(state, bias, terms):
        s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        dVds = grad_with_walls(bias, s)
        auxs = tuple(cv.grad_aux(t, dVds[i])
                     for i, (cv, t) in enumerate(zip(cvs, terms)))
        fs, gs, new = [], [], None
        sts = slabs.halo_states(state, **_order_columns(state, spec,
                                                        pair=True))
        for k, st in enumerate(sts):
            f, g, t = fused_lj_order_force_cuda(
                st, slabs.spec_ext, cvs, _tree_to(auxs, st.r.device),
                mono=True, cell_mask=slabs.interior[k])
            fs.append(f)
            gs.append(g)
            t = _tree_to(t, slabs.devices[0])
            new = t if new is None else _tree_add(new, t)
        return slabs.gather(fs), slabs.gather(gs), new

    return seed_eval, fused_force


@dataclasses.dataclass(frozen=True)
class _RepackTables:
    """Static tables of the 27-offset assignment on one extended grid."""

    tgt: torch.Tensor      # (3, 27, C_e) i32 cell of c + o: extended-local
    #                        on a sharded axis, periodic on a whole one
    in_int: torch.Tensor   # (27, C_e) bool: c + o in the interior
    dest: torch.Tensor     # (27, C_e) i64 interior linear cell of c + o (0
    #                        off the interior)
    src: torch.Tensor      # (27, C_l) i64 extended linear cell of d − o


def _repack_tables(geom, device) -> _RepackTables:
    """The tables of ``geom`` (:class:`Slabs`, or the 2-D decomposition's
    ``Blocks``): an axis in ``geom.sharded`` has one ghost plane per side
    and an interior 1 .. n_l; a whole axis wraps periodically."""
    ext, loc = geom.ext_dims, geom.loc_dims
    e = np.unravel_index(np.arange(int(np.prod(ext))), ext)
    d = np.unravel_index(np.arange(int(np.prod(loc))), loc)
    o = np.asarray(OFFSETS, np.int64)
    tgt, in_int, dest, src = [], True, 0, 0
    for a in range(3):
        h = 1 if a in geom.sharded else 0
        t_a = e[a][None] + o[:, a, None]
        s_a = d[a][None] + h - o[:, a, None]
        if h:
            in_int = in_int & (t_a >= 1) & (t_a <= loc[a])
        else:
            t_a, s_a = t_a % loc[a], s_a % loc[a]
        tgt.append(t_a)
        dest = dest * loc[a] + (t_a - h)
        src = src * ext[a] + s_a
    dest = np.where(in_int, dest, 0)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return _RepackTables(t(np.stack(tgt), torch.int32), t(in_int, torch.bool),
                         t(dest, torch.int64), t(src, torch.int64))


def make_sharded_repack(spec: PackedSpec, devices: Sequence, geometry=None):
    """``repack(state) -> (state, bad)``: slot migration with ghost-plane
    ownership hand-off, no global repack (the reference's ``:601-810``).

    The whole axes (y and z of the slabs) wrap first (elementwise); then
    every column (positions, velocities, forces, images, pid + 1 with 0 for
    vacant, type and every attr, the held bias force of the lagged path
    among them) is extended by one ghost plane per side of each sharded
    axis, the coordinate row shifted across the seam with the paired image
    adjustment.  Each shard runs the 27-offset sort-free assignment on its
    extended grid and keeps only arrivals into its interior: a particle
    leaving a shard lands in its neighbour's ghost plane and is claimed by
    the neighbour's interior.  The arrival ranking is the single-device one
    (offset, then source column, then rank), so the slot assignment equals
    ``ops.packed.repack_incremental``'s bit for bit.  ``bad`` (a device
    bool) is True iff the particle count changed (a particle moved more
    than one cell, or a cell overflowed).  ``geometry``: as in
    :func:`make_sharded_lj_force` (the 2-D blocks shard x and y, so only z
    wraps first, and x and y in transit)."""
    slabs = geometry or Slabs(spec, devices)
    tables = [_repack_tables(slabs, d) for d in slabs.devices]
    cap = spec.cap
    n_pad_l = cap * slabs.C_l

    def assign(ext: torch.Tensor, k: int, box) -> torch.Tensor:
        """Shard k's new local slot (n_pad_l: dropped) of every extended
        row."""
        tab = tables[k]
        valid2 = (ext[12] > 0).reshape(1, cap, slabs.C_e)
        f3 = _frac3(ext[:3], box).reshape(3, 1, cap, slabs.C_e)
        m = valid2 & tab.in_int[:, None]
        for a, cell in enumerate(slabs.local_cells(f3, k)):
            m = m & (cell == tab.tgt[a][:, None])
        m_i = m.to(torch.int32)                          # (27, cap, C_e)
        grp_rank = torch.cumsum(m_i, dim=1, dtype=torch.int32) - m_i
        col_cnt = m_i.sum(dim=1, dtype=torch.int32)      # (27, C_e)
        arrivals = torch.gather(col_cnt, 1, tab.src)     # (27, C_l)
        base_incl = torch.cumsum(arrivals, dim=0, dtype=torch.int32)
        base_src = torch.gather(base_incl - arrivals, 1, tab.dest)
        r_new = base_src[:, None, :] + grp_rank
        ok = m & (r_new < cap)
        s = r_new * slabs.C_l + tab.dest[:, None, :].to(torch.int32)
        return torch.where(ok.any(dim=0),
                           (s * ok).sum(dim=0, dtype=torch.int32),
                           n_pad_l).reshape(-1)

    def repack(state: PackedState):
        box = state.box
        names = sorted(state.attrs.keys())
        # wrap the whole axes now (such a wrap leaves the fractional
        # coordinates of the sharded axes, and so the shard, unchanged);
        # the sharded axes wrap in transit across the seam
        fr = _frac3(state.r, box)
        shv = torch.floor(fr + 0.5)
        for a in slabs.sharded:
            shv[a] = 0.0
        r = state.r - _cart3(shv, box)
        im = state.image.to(torch.float32) + shv
        valid = state.pid < spec.n_real
        cols = torch.cat([
            r, state.v, state.f, im,
            torch.where(valid, state.pid + 1, 0).to(torch.float32)[None],
            state.typ.to(torch.float32)[None],
            *(state.attrs[k].to(torch.float32)[None] for k in names)])
        seam = slabs.seam_lengths(box)
        parts = []
        for k in range(slabs.n_dev):
            ext = slabs.extend(cols, k, seam, image_row=9)
            slot = assign(ext, k, box.to(slabs.devices[k]))
            out = torch.zeros((n_pad_l + 1, ext.shape[0]),
                              dtype=torch.float32, device=ext.device)
            out[slot.long()] = ext.T
            parts.append(out[:n_pad_l].T)
        out = slabs.gather(parts, extended=False)
        r_n = out[0:3]
        im_n = out[9:12]
        valid_new = out[12] > 0
        # the sharded coordinates of the migrated seam particles: the paired
        # image update keeps unwrapped coordinates exact (a1 = (Lx, 0, 0)
        # in any box; the blocks' a2 = (0, Ly, 0) in their orthorhombic one)
        f_n = _frac3(r_n, box)
        r_rows, im_rows = list(r_n.unbind(0)), list(im_n.unbind(0))
        for a in slabs.sharded:
            sh = torch.floor(f_n[a] + 0.5)
            r_rows[a] = r_rows[a] - box.L[a] * sh
            im_rows[a] = im_rows[a] + sh
        r_n, im_n = torch.stack(r_rows), torch.stack(im_rows)
        if spec.uniform_eps is not None:
            r_n = torch.where(valid_new[None, :], r_n, VACANT_X)
        pid_n = torch.where(valid_new, out[12] - 1.0,
                            float(spec.n_real)).to(torch.int32)
        typ_n = torch.where(valid_new, out[13].to(torch.int32),
                            torch.max(state.typ))
        bad = valid_new.sum() != spec.n_real
        slot_of = torch.zeros(spec.n_real + 1, dtype=torch.int32,
                              device=r_n.device)
        slot_of[pid_n.long()] = torch.arange(spec.n_pad, dtype=torch.int32,
                                             device=r_n.device)
        return state.replace(
            r=r_n, v=out[3:6], f=out[6:9], image=im_n.to(torch.int32),
            ref_r=r_n, pid=pid_n, typ=typ_n, slot_of=slot_of[:spec.n_real],
            attrs={k: out[14 + i].to(state.attrs[k].dtype)
                   for i, k in enumerate(names)},
        ), bad

    return repack


class SpatialPackedEngine(PackedEngine):
    """PackedEngine with the cell grid cut into x-slabs over ``devices``:
    the pair force and the migration as islands (and, through
    :meth:`make_order_parts` and :meth:`make_lagged_parts`, the order-CV
    sweeps), behind the engine protocol, so ``MetadSampler`` and the packed
    CVs run on the global state unchanged.

    ``devices``: one torch device per shard (shards may share one); the
    state lives on ``devices[0]``.  The inner-step pair force runs forces
    only, and the energy and virial only at the stride-end refresh, each
    shard's under the interior mask; ``with_energy=True`` makes every force
    call compute them, as on ``PackedEngine``.  ``order_pallas`` (default
    on) runs the order-CV sweeps and the lagged fused kernel as islands;
    off, the sampler runs them on the global state (the reference's GSPMD
    sweep).  On the CPU every island runs the plain versions.

    ``nested=True`` is the walkers × space product (the reference's
    ``:813-899``): the engine then also takes a walker batch (W, 3, Npad)
    on ``devices[0]``, every shard's extended grid holding all W walkers,
    so kernel 1 runs once per shard for the whole batch (under the
    interior mask where it computes the energy and the per-axis virial),
    each walker in its own box; the sharded repack runs walker by walker
    after one read of the (W,) repack flags, as ``PackedEngine``'s does.
    The order-CV islands take one walker at a time (their CVs do not take
    a batch, so ``parallel/walkers.py`` steps such walkers one by one)."""

    def __init__(self, spec: PackedSpec, devices: Sequence,
                 rebuild_every: int = 1, mass: float = 1.0,
                 nested: bool = False, always_repack: bool = False,
                 with_energy: bool = False, order_pallas: bool = True):
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("SpatialPackedEngine: no devices")
        super().__init__(spec, devices[0], rebuild_every=rebuild_every,
                         mass=mass, with_energy=with_energy,
                         always_repack=always_repack)
        self.devices = devices
        self._force = make_sharded_lj_force(spec, devices,
                                            with_energy=with_energy)
        self._force_e = make_sharded_lj_force(spec, devices, with_energy=True)
        self._sharded_repack = make_sharded_repack(spec, devices)
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
        return make_sharded_order_parts(list(cvs), self.spec, self.devices)

    def make_lagged_parts(self, cvs, walls=None):
        """(seed_eval, fused_force) of the lagged islands, or None where the
        layout or the CVs do not fit them (the sampler then takes the
        single-grid lagged parts or plain ``bias_every`` MTS)."""
        spec = self.spec
        if not (self.order_pallas and spec.sentinel and not spec.has_bonds
                and len(cvs) > 0
                and all(hasattr(cv, "pair_value_terms_flat")
                        and hasattr(cv, "pair_grad_terms") for cv in cvs)
                and not any(hasattr(cv, "bias_virial") for cv in cvs)):
            return None
        return make_sharded_lagged_parts(list(cvs), spec, self.devices,
                                         walls=walls)

    def _repack_one(self, state: PackedState):
        # one walker's migration (PackedEngine.rebuild and its batch
        # rebuild decide, one host read per rebuild block: the largest
        # displacement over all shards, per walker)
        return self._sharded_repack(state)
