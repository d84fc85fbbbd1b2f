"""Packed cell-major MD state, its repack, and the plain pair force.

Counterpart of ``metadyn_tpu/ops/packed.py``, with the same data contract so
the two packages compare array for array:

**Layout.**  Particles live in cell-major slot arrays: flat index
``slot = rank·C + cell`` viewed as (cap, C), with ``cell = (ix·cy + iy)·cz +
iz``.  Coordinates are (3, Npad) f32 rows.

**Vacancy.**  Vacant slots carry √ε = 0 in the ``se`` attribute, and in the
sentinel layout (``uniform_eps`` set) their coordinates sit at exactly
``VACANT_X``.  The plain force culls vacancy through ``se``; the CUDA kernel
(``ops/packed_cuda.py``) through the sentinel in that layout and through
``se`` in the per-slot ones, where vacant slots are not pinned and drift.

**Plain force.**  :func:`packed_lj_force` (LJ or the soft push-off pair,
optional per-type scale tables and bonds) is the 27-offset roll sweep: for
each neighbour-cell offset the partner rows are a ``torch.roll`` of the
(cap, cx, cy, cz) view plus a periodic shift, and pair terms are (cap_j,
cap_i, C) broadcasts reduced over cap_j.  It is the plain PyTorch version of
the pair-force kernel: the CPU path, and the oracle the kernel is held
against on the card.

**Build and repack.**  :func:`pack` (any device) and :func:`pack_host`
(numpy) build the slots from particle order by a stable sort of the cell
ids; :func:`repack` rebuilds them the same way from any state.
:func:`repack_incremental`, the production repack, migrates slots without a
sort: a particle moves at most one cell between repacks, so its new rank is
a sum of per-cell arrival counts over the 27 offsets plus its rank among the
particles leaving its old cell the same way.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.batch import batch_size, walkers
from ..core.box import Box, h_inverse, h_matrix

# Vacant-slot coordinate sentinel of the sentinel layout: far outside any box
# (f32-exact), so vacant pairs fail the r² cut-off.  Real coordinates never
# exceed ~1.5·L ≪ VACANT_THR.
VACANT_X = 1.0e7
VACANT_THR = 1.0e6

# The 27 neighbour-cell offsets, in the reference's order (ox, oy, oz
# nested, each over -1, 0, 1).
OFFSETS = tuple((ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                for oz in (-1, 0, 1))


def _box_cols(box: Box):
    """(Lx, Ly, Lz, xy, xz, yz) as (..., 1) columns that broadcast over a
    (..., M) row: one box, or one per walker of a stacked box."""
    L = box.L[..., None]
    t = box.tilt[..., None]
    return L[..., 0, :], L[..., 1, :], L[..., 2, :], t[..., 0, :], \
        t[..., 1, :], t[..., 2, :]


def _frac3(r: torch.Tensor, box: Box) -> torch.Tensor:
    """(..., 3, M) Cartesian → fractional rows (f = h⁻¹ r), elementwise;
    one box for every walker, or a stacked box with one per walker."""
    if box.tilt is None:
        return r / box.L[..., None]
    Lx, Ly, Lz, xy, xz, yz = _box_cols(box)
    x, y, z = r.unbind(-2)
    fz = z / Lz
    fy = (y - yz * z) / Ly
    fx = (x - xy * (y - yz * z) - xz * z) / Lx
    return torch.stack([fx, fy, fz], dim=-2)


def _cart3(f: torch.Tensor, box: Box) -> torch.Tensor:
    """(..., 3, M) fractional → Cartesian rows (r = h f), elementwise."""
    if box.tilt is None:
        return f * box.L[..., None]
    Lx, Ly, Lz, xy, xz, yz = _box_cols(box)
    f0, f1, f2 = f.unbind(-2)
    r2 = Lz * f2
    r1 = Ly * f1 + yz * Lz * f2
    r0 = Lx * f0 + xy * Ly * f1 + xz * Lz * f2
    return torch.stack([r0, r1, r2], dim=-2)


def shift_rows_cart(ushift: torch.Tensor, box: Box) -> torch.Tensor:
    """Lattice-unit wrap counts (..., 3, C) → Cartesian shift rows of the
    same shape: orthorhombic u_d·L_d, triclinic h @ u per column."""
    u = ushift.to(torch.float32)
    if box.tilt is None:
        return u * box.L.reshape((1,) * (u.ndim - 2) + (3, 1))
    Lx, Ly, Lz = box.L.unbind()
    xy, xz, yz = box.tilt.unbind()
    ux, uy, uz = u[..., 0, :], u[..., 1, :], u[..., 2, :]
    return torch.stack([Lx * ux + xy * Ly * uy + xz * Lz * uz,
                        Ly * uy + yz * Lz * uz,
                        Lz * uz], dim=-2)


@dataclass(frozen=True)
class PackedSpec:
    """Static geometry: cell grid and slot capacity.  Same fields, meaning
    and ``create`` sizing as the reference's ``PackedSpec``."""

    cells_per_dim: tuple           # (cx, cy, cz)
    cap: int
    n_real: int
    r_cut: float
    skin: float
    shift_energy: bool = True
    # uniform σ and/or ε; both set is the sentinel layout (vacancy by
    # coordinate)
    uniform_sigma: Optional[float] = None
    uniform_eps: Optional[float] = None
    # "lj" or "soft" (the DPD-conservative push-off pair, A = se_i·se_j)
    pair_kind: str = "lj"
    # symmetric (n_types, n_types) scale tables over the per-slot
    # Lorentz–Berthelot base: ε_ij = se_i·se_j·k_ε(ti, tj), σ_ij =
    # (hs_i + hs_j)·k_σ(ti, tj) (see pair_scale_tables)
    eps_scale: Optional[tuple] = None
    sigma_scale: Optional[tuple] = None
    # bonds (None = none): partners matched by pid through the per-slot
    # attrs bp0..bp{bond_slots-1} (partner pid + 1, 0 = none); a bonded
    # pair gets the bond term instead of the pair term.  "fene" is FENE +
    # WCA (k = fene_k, r0 = maximum extension), "harmonic" ½k(r − r0)².
    fene_k: Optional[float] = None
    fene_r0: Optional[float] = None
    bond_kind: str = "fene"
    bond_slots: int = 2

    @property
    def n_cells(self) -> int:
        cx, cy, cz = self.cells_per_dim
        return cx * cy * cz

    @property
    def n_pad(self) -> int:
        return self.cap * self.n_cells

    @property
    def r_list(self) -> float:
        return self.r_cut + self.skin

    @property
    def has_bonds(self) -> bool:
        return self.fene_k is not None

    @property
    def has_pair_table(self) -> bool:
        return self.eps_scale is not None or self.sigma_scale is not None

    @property
    def sentinel(self) -> bool:
        """The lean layout: uniform σ and ε, vacancy by coordinate."""
        return self.uniform_eps is not None and self.uniform_sigma is not None

    @classmethod
    def create(cls, box_L, n_particles: int, r_cut: float, skin: float = 0.5,
               cap: Optional[int] = None, shift_energy: bool = True,
               fene_k: Optional[float] = None,
               fene_r0: Optional[float] = None,
               uniform_sigma: Optional[float] = None,
               uniform_eps: Optional[float] = None,
               pair_kind: str = "lj",
               bond_kind: str = "fene",
               bond_slots: int = 2,
               eps_scale=None,
               sigma_scale=None,
               tilt=None) -> "PackedSpec":
        L = np.asarray(box_L, np.float64).reshape(-1)
        if L.size == 1:
            L = np.repeat(L, 3)
        r_list = r_cut + skin
        if tilt is not None:
            # a fractional cell layer of thickness 1/cpd_d has perpendicular
            # width w_perp_d / cpd_d; the 27-cell stencil covers r_list when
            # that width ≥ r_list
            xy, xz, yz = (float(t) for t in np.asarray(tilt).reshape(3))
            h = np.array([[L[0], xy * L[1], xz * L[2]],
                          [0.0, L[1], yz * L[2]],
                          [0.0, 0.0, L[2]]])
            a, b, c = h[:, 0], h[:, 1], h[:, 2]
            vol = abs(np.dot(a, np.cross(b, c)))
            w = np.array([vol / np.linalg.norm(np.cross(b, c)),
                          vol / np.linalg.norm(np.cross(c, a)),
                          vol / np.linalg.norm(np.cross(a, b))])
        else:
            w = L
        cpd = tuple(int(np.floor(wd / r_list)) for wd in w)
        if min(cpd) < 3:
            raise ValueError(f"box too small for cell decomposition: "
                             f"cells_per_dim={cpd}")
        n_cells = int(np.prod(cpd))
        if cap is None:
            # Poisson-tail sizing: mean + 5√mean + 4, rounded up to 4
            mean_occ = n_particles / n_cells
            est = mean_occ + 5.0 * np.sqrt(mean_occ) + 4.0
            cap = int(np.ceil(est / 4.0) * 4)
        if (eps_scale is not None or sigma_scale is not None) and (
                uniform_eps is not None or uniform_sigma is not None):
            raise ValueError("per-type-pair tables need the se/hs per-slot "
                             "layout (incompatible with uniform_eps/sigma)")

        def _tup(t):
            if t is None:
                return None
            a = np.asarray(t, np.float64)
            if a.ndim != 2 or a.shape[0] != a.shape[1] or not np.allclose(a, a.T):
                raise ValueError("pair tables must be square and symmetric")
            return tuple(tuple(float(x) for x in row) for row in a)

        if bond_kind not in ("fene", "harmonic"):
            raise ValueError(f"unknown bond_kind {bond_kind!r}")
        return cls(cells_per_dim=cpd, cap=cap, n_real=n_particles,
                   r_cut=r_cut, skin=skin, shift_energy=shift_energy,
                   fene_k=fene_k, fene_r0=fene_r0, bond_kind=bond_kind,
                   uniform_sigma=uniform_sigma, uniform_eps=uniform_eps,
                   pair_kind=pair_kind, bond_slots=bond_slots,
                   eps_scale=_tup(eps_scale), sigma_scale=_tup(sigma_scale))


@dataclass(frozen=True)
class PackedState:
    """MD state in slot layout.  (3, Npad) f32 rows and (Npad,) vectors;
    a walker batch (``core/batch.py``) stacks W of them: (W, 3, Npad) rows,
    (W, Npad) vectors, (W,) energies and a stacked box."""

    r: torch.Tensor        # (3, Npad) positions (vacant: VACANT_X or 0)
    v: torch.Tensor        # (3, Npad)
    f: torch.Tensor        # (3, Npad) forces at r
    image: torch.Tensor    # (3, Npad) i32 box-image counters
    ref_r: torch.Tensor    # (3, Npad) positions at the last repack
    pid: torch.Tensor      # (Npad,) i32 particle id; n_real = vacant
    typ: torch.Tensor      # (Npad,) i32 type; n_types = vacant
    slot_of: torch.Tensor  # (n_real,) i32 current slot of each particle id
    attrs: dict            # per-slot f32 attrs: 'se'=√ε, 'hs'=σ/2, CV coefs
    box: Box
    potential_energy: torch.Tensor  # () f32
    virial: torch.Tensor            # (3,) f32 diagonal virial

    @property
    def n_pad(self) -> int:
        return self.pid.shape[-1]

    def replace(self, **changes) -> "PackedState":
        return dataclasses.replace(self, **changes)


class _Tables(NamedTuple):
    """Static per-(spec, device) index tables of the 27-offset sweeps."""

    tgt: torch.Tensor     # (27, 3, C) i32 cell coords of c + o
    dest: torch.Tensor    # (27, C) i64 linear cell of c + o
    src: torch.Tensor     # (27, C) i64 linear cell of c − o
    ushift: torch.Tensor  # (27, 3, C) f32 lattice wrap count of c + o


def _cell_coords_static(spec: PackedSpec) -> np.ndarray:
    """Per-cell 3-D coordinates of each linear cell id, (3, C)."""
    ix, iy, iz = np.unravel_index(np.arange(spec.n_cells), spec.cells_per_dim)
    return np.stack([ix, iy, iz]).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _tables(spec: PackedSpec, device: torch.device) -> _Tables:
    dims = np.asarray(spec.cells_per_dim, np.int64)[:, None]
    coords = _cell_coords_static(spec)
    o = np.asarray(OFFSETS, np.int64)[:, :, None]           # (27, 3, 1)
    fwd = coords[None] + o                                  # (27, 3, C)
    tgt = fwd % dims
    back = (coords[None] - o) % dims

    def lin(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return _Tables(tgt=t(tgt, torch.int32), dest=t(lin(tgt), torch.int64),
                   src=t(lin(back), torch.int64),
                   ushift=t(np.floor_divide(fwd, dims), torch.float32))


def _cell_id_packed(r: torch.Tensor, box: Box, spec: PackedSpec) -> torch.Tensor:
    """Linear cell id per slot from (3, M) coordinates; fractional binning
    ``floor((f + 0.5)·c_d)`` clipped to the grid."""
    f = _frac3(r, box)
    out = torch.zeros(r.shape[1], dtype=torch.int32, device=r.device)
    for d, c in enumerate(spec.cells_per_dim):
        cd = torch.clamp(torch.floor((f[d] + 0.5) * c).to(torch.int32), 0, c - 1)
        out = out * c + cd
    return out


def _wrap_state(state: PackedState) -> PackedState:
    """Wrap coordinates into the box, updating the image counters.  Only
    pack/repack call it: between repacks coordinates drift continuously."""
    shift = torch.floor(_frac3(state.r, state.box) + 0.5)
    return state.replace(r=state.r - _cart3(shift, state.box),
                         image=state.image + shift.to(torch.int32))


def _scatter_rows(cols: list, slot: torch.Tensor, n_pad: int) -> list:
    """Permute many (M,) columns by one row scatter of an (M, W) matrix.

    Row ``n_pad`` of the (n_pad + 1, W) target is the drop row: entries
    whose slot is ``n_pad`` land there and are cut off.  Integer columns
    travel as f32 by value (exact below 2^24: pids, images, types)."""
    mat = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    out = torch.zeros((n_pad + 1, len(cols)), dtype=torch.float32,
                      device=mat.device)
    out[slot.long()] = mat
    rows = out[:n_pad].T.contiguous()
    return [rows[i].to(c.dtype) for i, c in enumerate(cols)]


def _slot_assignment(cid: torch.Tensor, valid: torch.Tensor,
                     spec: PackedSpec) -> tuple:
    """(slot, overflow): slot = rank·C + cell for a valid entry whose rank
    in its cell is below cap, ``n_pad`` (dropped) for the others; the rank
    from a stable sort of the cell ids and ``searchsorted``, so entries keep
    their input order within a cell (the reference's
    ``_slot_assignment``).  ``overflow``: a device bool."""
    C, cap = spec.n_cells, spec.cap
    m = cid.shape[0]
    key = torch.where(valid, cid.to(torch.int64), C)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    rank = torch.arange(m, device=cid.device) - torch.searchsorted(
        sorted_key, sorted_key, side="left")
    in_grid = sorted_key < C
    slot_sorted = torch.where(in_grid & (rank < cap), rank * C + sorted_key,
                              spec.n_pad)
    overflow = torch.any(in_grid & (rank >= cap))
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return slot.to(torch.int32), overflow


def pack(
    pos,
    box: Box,
    spec: PackedSpec,
    types,
    eps_i,
    sigma_i,
    device,
    vel=None,
    image=None,
    extra_attrs=None,
) -> tuple[PackedState, torch.Tensor]:
    """Initial build from particle-order arrays (numpy or tensors), on
    ``device``: the reference's ``pack`` (the wrap, the cell of each
    particle, a stable-sort slot assignment, one row scatter), with
    :func:`pack_host`'s arithmetic, so that both give the same arrays to
    the bit on an orthorhombic box (under tilt the wrap and the fractional
    coordinates are the elementwise :func:`_frac3` and :func:`_cart3`,
    where ``pack_host`` takes matrix products); its zero energy is 0-d, as
    the reference's, where ``pack_host``'s is (1,).  The cell of a fractional
    coordinate f is ``floor((f + 0.5)·c)`` with the product taken exactly,
    in f64.  Returns (state, overflow), overflow a device bool."""
    def t(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype)

    n = spec.n_real
    box = box.to(device)
    r = t(pos, torch.float32).reshape(n, 3).T.contiguous()     # (3, N)
    v = (torch.zeros_like(r) if vel is None
         else t(vel, torch.float32).reshape(n, 3).T.contiguous())
    im = (torch.zeros((3, n), dtype=torch.int32, device=device)
          if image is None else t(image, torch.int32).reshape(n, 3).T)
    if box.tilt is None:
        L = box.L[:, None]
        shift = torch.floor(r / L + 0.5)
        r = r - L * shift
        frac = r / L + 0.5
    else:
        shift = torch.floor(_frac3(r, box) + 0.5)
        r = r - _cart3(shift, box)
        frac = _frac3(r, box) + 0.5
    im = im + shift.to(torch.int32)
    cid = torch.zeros(n, dtype=torch.int64, device=device)
    for d, c in enumerate(spec.cells_per_dim):
        cd = torch.clamp(torch.floor(frac[d].double() * c).to(torch.int64),
                         0, c - 1)
        cid = cid * c + cd
    slot, overflow = _slot_assignment(
        cid, torch.ones(n, dtype=torch.bool, device=device), spec)

    types = t(types, torch.int32).reshape(n)
    names = sorted((extra_attrs or {}).keys())
    # the f32 root correctly rounded, as numpy's and XLA's (torch's CPU
    # sqrt is not): rounding the f64 root to f32 is exact rounding
    attr_cols = ([torch.sqrt(t(eps_i, torch.float32).reshape(n).double()
                             ).float(),
                  0.5 * t(sigma_i, torch.float32).reshape(n)]
                 + [t(extra_attrs[k], torch.float32).reshape(n)
                    for k in names])
    pid1 = torch.arange(1, n + 1, dtype=torch.int32, device=device)
    cols = ([r[d] for d in range(3)] + [v[d] for d in range(3)]
            + [im[d] for d in range(3)] + [pid1, types] + attr_cols)
    out = _scatter_rows(cols, slot, spec.n_pad)
    r_o = torch.stack(out[0:3])
    valid = out[9] > 0
    if spec.uniform_eps is not None:
        r_o = torch.where(valid[None, :], r_o, VACANT_X)
    n_types = int(types.max()) + 1 if n else 1
    state = PackedState(
        r=r_o,
        v=torch.stack(out[3:6]),
        f=torch.zeros_like(r_o),
        image=torch.stack(out[6:9]),
        ref_r=r_o,
        pid=torch.where(valid, out[9] - 1, n).to(torch.int32),
        typ=torch.where(valid, out[10], n_types).to(torch.int32),
        slot_of=slot,
        attrs=dict(zip(["se", "hs"] + names, out[11:])),
        box=box,
        potential_energy=torch.zeros((), dtype=torch.float32, device=device),
        virial=torch.zeros(3, dtype=torch.float32, device=device),
    )
    return state, overflow


def pack_host(
    pos: np.ndarray,
    box: Box,
    spec: PackedSpec,
    types,
    eps_i,
    sigma_i,
    device,
    vel=None,
    image=None,
    extra_attrs=None,
) -> tuple[PackedState, bool]:
    """Initial build from particle-order arrays, in numpy on the host (a
    copy of the reference's ``pack_host``, same f32 arithmetic and stable
    ordering); the result is moved to ``device`` once.  Returns (state,
    overflow)."""
    n = spec.n_real
    cpd = np.asarray(spec.cells_per_dim, np.int32)
    C, cap, npad = spec.n_cells, spec.cap, spec.n_pad
    r = np.asarray(pos, np.float32).T.copy()            # (3, N)
    v = (np.zeros_like(r) if vel is None
         else np.asarray(vel, np.float32).T)
    im = (np.zeros((3, n), np.int32) if image is None
          else np.asarray(image, np.int32).T)
    if box.tilt is None:
        L = np.asarray(box.L_host, np.float32)
        f = r / L[:, None]
    else:
        hmat = h_matrix(box).cpu().numpy().astype(np.float32)
        hinv = h_inverse(box).cpu().numpy().astype(np.float32)
        f = (hinv @ r).astype(np.float32)
    shift = np.floor(f + np.float32(0.5))
    if box.tilt is None:
        r = r - L[:, None] * shift
    else:
        r = (r - hmat @ shift).astype(np.float32)
        f = (hinv @ r).astype(np.float32)
    im = im + shift.astype(np.int32)
    cid = np.zeros(n, np.int64)
    for d in range(3):
        if box.tilt is None:
            frac = r[d] / L[d] + np.float32(0.5)
        else:
            frac = f[d] + np.float32(0.5)
        # the product in f64, exact for an f32 times a cell count (numpy 2
        # promotes f32 * np.int32 to f64; written out so numpy 1 agrees)
        c = np.clip(np.floor(frac.astype(np.float64) * cpd[d]
                             ).astype(np.int64), 0, cpd[d] - 1)
        cid = cid * cpd[d] + c
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    rank = np.arange(n) - np.searchsorted(sorted_cid, sorted_cid, "left")
    slot_sorted = np.where(rank < cap, rank * C + sorted_cid, npad)
    overflow = bool(np.any(rank >= cap))
    slot = np.empty(n, np.int64)
    slot[order] = slot_sorted

    types = np.asarray(types, np.int32)
    names = sorted((extra_attrs or {}).keys())
    attr_cols = ([np.sqrt(np.asarray(eps_i, np.float32)),
                  0.5 * np.asarray(sigma_i, np.float32)]
                 + [np.asarray((extra_attrs or {})[k], np.float32)
                    for k in names])

    def scat(col, fill=0.0, dtype=np.float32):
        out = np.full(npad + 1, fill, dtype)
        out[slot] = col
        return out[:npad]

    r_o = np.stack([scat(r[d]) for d in range(3)])
    pid1 = scat(np.arange(1, n + 1, dtype=np.int32), 0, np.int32)
    valid = pid1 > 0
    if spec.uniform_eps is not None:
        r_o = np.where(valid[None, :], r_o, np.float32(VACANT_X))
    n_types = int(types.max()) + 1 if n else 1

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    state = PackedState(
        r=t(r_o),
        v=t(np.stack([scat(v[d]) for d in range(3)])),
        f=t(np.zeros((3, npad), np.float32)),
        image=t(np.stack([scat(im[d], 0, np.int32) for d in range(3)])),
        ref_r=t(r_o),
        pid=t(np.where(valid, pid1 - 1, n).astype(np.int32)),
        typ=t(np.where(valid, scat(types, 0, np.int32),
                       n_types).astype(np.int32)),
        slot_of=t(slot.astype(np.int32)),
        attrs={k: t(scat(c)) for k, c in zip(["se", "hs"] + names, attr_cols)},
        box=box.to(device),
        potential_energy=t(np.float32(0.0)),
        virial=t(np.zeros(3, np.float32)),
    )
    return state, overflow


def repack(state: PackedState, spec: PackedSpec
           ) -> tuple[PackedState, torch.Tensor]:
    """The full sort-based rebuild (the reference's ``repack``): wrap, each
    slot's current cell, a stable-sort slot assignment and one row scatter
    of every per-slot array.  Unlike :func:`repack_incremental` it takes
    any displacement.  Returns (state, overflow), overflow a device bool."""
    state = _wrap_state(state)
    valid_in = state.pid < spec.n_real
    cid = _cell_id_packed(state.r, state.box, spec)
    slot, overflow = _slot_assignment(cid, valid_in, spec)
    attr_names = sorted(state.attrs.keys())
    cols = ([state.r[d] for d in range(3)] + [state.v[d] for d in range(3)]
            + [state.f[d] for d in range(3)]
            + [state.image[d] for d in range(3)]
            + [torch.where(valid_in, state.pid + 1, 0), state.typ]
            + [state.attrs[k] for k in attr_names])
    out = _scatter_rows(cols, slot, spec.n_pad)
    r = torch.stack(out[0:3])
    valid = out[12] > 0
    if spec.uniform_eps is not None:
        r = torch.where(valid[None, :], r, VACANT_X)
    # vacant slots have pid == n_real: their writes land in the drop entry
    slot_of = torch.zeros(spec.n_real + 1, dtype=torch.int32,
                          device=slot.device)
    slot_of[state.pid.long()] = slot
    return state.replace(
        r=r,
        v=torch.stack(out[3:6]),
        f=torch.stack(out[6:9]),
        image=torch.stack(out[9:12]),
        ref_r=r,
        pid=torch.where(valid, out[12] - 1, spec.n_real).to(torch.int32),
        typ=torch.where(valid, out[13], torch.max(state.typ)),
        slot_of=slot_of[:spec.n_real],
        attrs=dict(zip(attr_names, out[14:])),
    ), overflow


def repack_incremental(state: PackedState, spec: PackedSpec
                       ) -> tuple[PackedState, torch.Tensor]:
    """Sort-free slot migration (the production repack).

    For each of the 27 offsets o, a particle that moved from cell c to
    c + o gets the rank

      rank = Σ_{o' < o} arrivals_{o'}(c + o) + its rank among the particles
             leaving c via o,

    so the assignment is deterministic, ordered by (offset, old slot).  The
    27 offsets are processed as one batch: the reference's per-offset rolls
    of the (C,) count vectors are static gathers (``_tables``) and its
    running sum over offsets is a cumsum.  A particle that moved more than
    one cell is dropped and flagged.

    Returns (state, bad) where ``bad`` (a device bool) is capacity overflow
    or a lost particle."""
    state = _wrap_state(state)
    cap, C, n_pad = spec.cap, spec.n_cells, spec.n_pad
    tab = _tables(spec, state.r.device)
    valid = state.pid < spec.n_real
    valid2 = valid.reshape(cap, C)

    f3 = _frac3(state.r, state.box)
    m = valid2.unsqueeze(0)                                  # (1, cap, C)
    for d, c in enumerate(spec.cells_per_dim):
        new_c = torch.clamp(torch.floor((f3[d] + 0.5) * c).to(torch.int32),
                            0, c - 1).reshape(1, cap, C)
        m = m & (new_c == tab.tgt[:, d, None, :])            # (27, cap, C)
    # rank within the (offset, source cell) group
    m_i = m.to(torch.int32)
    grp_rank = torch.cumsum(m_i, dim=1, dtype=torch.int32) - m_i
    col_cnt = m_i.sum(dim=1, dtype=torch.int32)              # (27, C) by source
    arrivals = torch.gather(col_cnt, 1, tab.src)             # by destination
    base_incl = torch.cumsum(arrivals, dim=0, dtype=torch.int32)
    base_src = torch.gather(base_incl - arrivals, 1, tab.dest)
    r_new = base_src[:, None, :] + grp_rank                  # (27, cap, C)
    ok = m & (r_new < cap)
    s = r_new * C + tab.dest[:, None, :].to(torch.int32)
    slot = torch.where(ok.any(dim=0), (s * ok).sum(dim=0, dtype=torch.int32),
                       n_pad).reshape(-1)
    lost = torch.any(valid2 & ~m.any(dim=0))
    bad = torch.any(base_incl[-1] > cap) | lost

    attr_names = sorted(state.attrs.keys())
    cols = ([state.r[d] for d in range(3)] + [state.v[d] for d in range(3)]
            + [state.f[d] for d in range(3)]
            + [state.image[d] for d in range(3)]
            + [torch.where(valid, state.pid + 1, 0), state.typ]
            + [state.attrs[k] for k in attr_names])
    out = _scatter_rows(cols, slot, n_pad)
    r = torch.stack(out[0:3])
    pid1 = out[12]
    valid_new = pid1 > 0
    if spec.uniform_eps is not None:
        r = torch.where(valid_new[None, :], r, VACANT_X)
    # vacant slots have pid == n_real: their writes land in the drop entry
    slot_of = torch.zeros(spec.n_real + 1, dtype=torch.int32,
                          device=slot.device)
    slot_of[state.pid.long()] = slot
    return state.replace(
        r=r,
        v=torch.stack(out[3:6]),
        f=torch.stack(out[6:9]),
        image=torch.stack(out[9:12]),
        ref_r=r,
        pid=torch.where(valid_new, pid1 - 1, spec.n_real).to(torch.int32),
        typ=torch.where(valid_new, out[13], torch.max(state.typ)),
        slot_of=slot_of[:spec.n_real],
        attrs=dict(zip(attr_names, out[14:])),
    ), bad


def needs_repack(state: PackedState, spec: PackedSpec) -> torch.Tensor:
    """Half-skin displacement criterion over valid slots (minimum image by
    fractional rounding).  A device bool; (W,) for a walker batch."""
    box = state.box
    dr = state.r - state.ref_r
    dr = dr - _cart3(torch.round(_frac3(dr, box)), box)
    d2 = torch.sum(dr * dr, dim=-2)
    d2 = torch.where(state.pid < spec.n_real, d2, 0.0)
    return torch.amax(d2, dim=-1) > (0.5 * spec.skin) ** 2


def pair_scale_tables(eps_table, sigma_table=None):
    """Target per-type-pair tables → ``(eps_scale, sigma_scale, eps_diag,
    sigma_diag)``: the scale tables for :class:`PackedSpec` and the
    per-type diagonals to build ``eps_i``/``sigma_i`` from (``eps_i =
    eps_diag[types]``).  ε entries must be positive (use the soft pair for
    athermal species)."""
    e = np.asarray(eps_table, np.float64)
    if not np.all(e > 0):
        raise ValueError("eps table entries must be positive")
    se = np.sqrt(np.diag(e))
    eps_scale = e / np.outer(se, se)
    if sigma_table is None:
        return (eps_scale, None, np.diag(e).astype(np.float32), None)
    s = np.asarray(sigma_table, np.float64)
    hs = 0.5 * np.diag(s)
    sigma_scale = s / np.add.outer(hs, hs)
    return (eps_scale, sigma_scale, np.diag(e).astype(np.float32),
            np.diag(s).astype(np.float32))


def _scale_fn(table):
    """Symmetric (nt, nt) scale table → ``f(ti, tj) -> k`` on f32 type
    tensors, the reference's forms: a constant table is its value, two
    types the bilinear form c0 + c1·(ti + tj) + c2·ti·tj (exact on {0, 1}²),
    more types a one-hot sum.  The vacant type nt gives a finite value
    (bilinear) or 0 (one-hot); vacancy is culled by se = 0 either way."""
    t = np.asarray(table, np.float64)
    nt = t.shape[0]
    if np.allclose(t, t[0, 0]):
        c = float(t[0, 0])
        return lambda ti, tj: c
    if nt == 2:
        c0 = float(t[0, 0])
        c1 = float(t[0, 1] - t[0, 0])
        c2 = float(t[1, 1] - 2.0 * t[0, 1] + t[0, 0])
        return lambda ti, tj: c0 + c1 * (ti + tj) + c2 * (ti * tj)

    def one_hot(ti, tj):
        k = 0.0
        for a in range(nt):
            row = 0.0
            for b in range(nt):
                row = row + float(t[a, b]) * (tj == b).to(torch.float32)
            k = k + (ti == a).to(torch.float32) * row
        return k

    return one_hot


def pair_scales_for(spec: PackedSpec):
    """(k_eps(ti, tj), k_sig(ti, tj)) scale functions, None where absent."""
    ke = _scale_fn(spec.eps_scale) if spec.eps_scale is not None else None
    ks = (_scale_fn(spec.sigma_scale)
          if spec.sigma_scale is not None else None)
    return ke, ks


def _fene_wca_pair(r2s, eps, sig, spec: PackedSpec):
    """Bonded-pair (energy, coef), which replaces the pair term of a bonded
    pair: FENE + WCA (Kremer–Grest) or the harmonic spring ½k(r − r0)²,
    by ``spec.bond_kind``.  The force on i is coef·(r_i − r_j)."""
    r0 = spec.fene_r0
    k = spec.fene_k
    if spec.bond_kind == "harmonic":
        r = torch.sqrt(r2s)
        e = 0.5 * k * (r - r0) ** 2
        coef = -k * (r - r0) / r
        return e, coef
    x = torch.clamp(r2s / (r0 * r0), max=0.99)
    e_f = -0.5 * k * r0 * r0 * torch.log1p(-x)
    coef_f = -k / (1.0 - x)
    rc2w = (2.0 ** (1.0 / 3.0)) * sig * sig
    in_w = r2s < rc2w
    s2 = sig * sig / r2s
    s6 = s2 * s2 * s2
    e_w = torch.where(in_w, 4.0 * eps * (s6 * s6 - s6) + eps, 0.0)
    coef_w = torch.where(in_w, 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s,
                         0.0)
    return e_f + e_w, coef_f + coef_w


def bond_partner_attrs(bonds: np.ndarray, n: int, slots: int = 2) -> dict:
    """Per-particle bond-partner attrs ``bp0..bp{slots-1}`` for pack time:
    partner pid + 1, 0 = no partner (so zero-filled vacant slots never
    match particle 0).  ``slots`` must equal ``PackedSpec.bond_slots``."""
    bp = np.zeros((n, slots), np.float32)
    cnt = np.zeros(n, np.int32)
    for a, b in np.asarray(bonds):
        for x, y in ((a, b), (b, a)):
            if cnt[x] >= slots:
                raise ValueError(
                    f"particle {x} has more than {slots} bonds; raise "
                    "bond_slots (PackedSpec + bond_partner_attrs)")
            bp[x, cnt[x]] = y + 1
            cnt[x] += 1
    return {f"bp{k}": bp[:, k] for k in range(slots)}


def packed_lj_force(state: PackedState, spec: PackedSpec,
                    with_energy: bool = True, cell_mask=None,
                    j_block: Optional[int] = None) -> PackedState:
    """Pair forces by the 27-offset roll sweep (see the module docstring).

    Per-slot Lorentz–Berthelot parameters: ε_ij = se_i·se_j (se = √ε),
    σ_ij = hs_i + hs_j (hs = σ/2), each times its per-type-pair scale
    where the spec has tables; vacant slots have se = 0.  ``pair_kind``
    "lj" is Lennard-Jones (energy-shifted with ``shift_energy``), "soft"
    the DPD-conservative u = (A·rc/2)(1 − r/rc)² with A = ε_ij.  Bonded
    pairs (matched by partner pid, at any distance) get the bond term of
    :func:`_fene_wca_pair` instead.  The uniform σ/ε fields do not enter:
    this path reads ``se``/``hs`` in every layout.

    With ``with_energy`` the state also gets the potential energy and the
    diagonal virial; without, they keep their old values (as the kernels'
    forces-only mode does).  ``j_block`` bounds the (j_block, cap, C) pair
    temporaries; by default the whole cap is one block up to 2^26 elements.
    ``cell_mask`` ((C,) 0/1, the spatial decomposition's) weights the energy
    and virial sums by each pair's i cell; the forces stay unmasked.

    A walker batch runs each walker in turn and stacks the results."""
    if batch_size(state) is not None:
        outs = [packed_lj_force(st, spec, with_energy, cell_mask, j_block)
                for st in walkers(state)]
        f = torch.stack([o.f for o in outs])
        if not with_energy:
            return state.replace(f=f)
        return state.replace(
            f=f, potential_energy=torch.stack([o.potential_energy
                                               for o in outs]),
            virial=torch.stack([o.virial for o in outs]))
    if spec.pair_kind not in ("lj", "soft"):
        raise ValueError(f"unknown pair_kind {spec.pair_kind!r}")
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    if j_block is None and cap * cap * C > 2**26:
        j_block = max(8, (2**26 // (cap * C)) // 8 * 8)
    jb = cap if j_block is None else min(j_block, cap)

    dev = state.r.device
    k_eps, k_sig = pair_scales_for(spec)
    # positions, the two pair parameters and (where used) the type and
    # pid + 1, rolled together per offset
    rows = [state.r, state.attrs["se"][None], state.attrs["hs"][None]]
    if spec.has_pair_table:
        rows.append(state.typ.to(torch.float32)[None])
    if spec.has_bonds:
        rows.append((state.pid.to(torch.float32) + 1.0)[None])
    rows = torch.cat(rows)
    n_rows = rows.shape[0]
    rows = rows.reshape(n_rows, cap, cx, cy, cz)
    xi = state.r.reshape(3, 1, cap, C)
    se_i = state.attrs["se"].reshape(1, cap, C)
    hs_i = state.attrs["hs"].reshape(1, cap, C)
    ty_i = (state.typ.to(torch.float32).reshape(1, cap, C)
            if spec.has_pair_table else None)
    bp_i = [state.attrs[f"bp{k}"].reshape(1, cap, C)
            for k in range(spec.bond_slots)] if spec.has_bonds else []
    rc2 = float(spec.r_cut) ** 2
    shifts = shift_rows_cart(_tables(spec, dev).ushift, state.box)[:, :, None]
    if cell_mask is not None:
        cell_mask = torch.as_tensor(cell_mask, dtype=torch.float32,
                                    device=dev)

    force = torch.zeros((3, cap, C), dtype=torch.float32, device=dev)
    e_tot = torch.zeros((), dtype=torch.float32, device=dev)
    w_tot = torch.zeros(3, dtype=torch.float32, device=dev)
    for oi, o in enumerate(OFFSETS):
        part = torch.roll(rows, shifts=(-o[0], -o[1], -o[2]),
                          dims=(2, 3, 4)).reshape(n_rows, cap, C)
        xj = part[:3] + shifts[oi]                          # (3, cap, C)
        for j0 in range(0, cap, jb):
            blk = slice(j0, j0 + jb)
            dx = xi - xj[:, blk, None, :]                   # (3, B, cap, C)
            r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
            eps = se_i * part[3, blk, None, :]
            sig = hs_i + part[4, blk, None, :]
            if spec.has_pair_table:
                ty_j = part[5, blk, None, :]
                if k_eps is not None:
                    eps = eps * k_eps(ty_i, ty_j)
                if k_sig is not None:
                    sig = sig * k_sig(ty_i, ty_j)
            inside = (r2 < rc2) & (r2 > 1e-12)
            r2s = torch.where(inside, r2, 1.0)
            if spec.pair_kind == "soft":
                rc = float(spec.r_cut)
                rr = torch.sqrt(r2s)
                x = 1.0 - rr / rc
                coef = eps * x / rr
                e = 0.5 * eps * rc * x * x if with_energy else None
            else:
                s2 = sig * sig / r2s
                s6 = s2 * s2 * s2
                coef = 4.0 * eps * (12.0 * s6 * s6 - 6.0 * s6) / r2s
                e = None
                if with_energy:
                    e = 4.0 * eps * (s6 * s6 - s6)
                    if spec.shift_energy:
                        sc2 = sig * sig / rc2
                        sc6 = sc2 * sc2 * sc2
                        e = e - 4.0 * eps * (sc6 * sc6 - sc6)
            coef = torch.where(inside, coef, 0.0)
            if with_energy:
                e = torch.where(inside, e, 0.0)
            if spec.has_bonds:
                # not gated on r_cut: a bond stretched past the pair cut-off
                # keeps its full bond term
                pid_j = part[n_rows - 1, blk, None, :]
                match = bp_i[0] == pid_j
                for bpk in bp_i[1:]:
                    match = match | (bpk == pid_j)
                bonded = match & (r2 > 1e-12)
                e_b, coef_b = _fene_wca_pair(torch.where(bonded, r2, 1.0),
                                             eps, sig, spec)
                coef = torch.where(bonded, coef_b, coef)
                if with_energy:
                    e = torch.where(bonded, e_b, e)
            cdx = coef * dx
            force = force + cdx.sum(dim=1)
            if with_energy:
                wdx = cdx * dx
                if cell_mask is not None:
                    e = e * cell_mask
                    wdx = wdx * cell_mask
                e_tot = e_tot + torch.sum(e)
                w_tot = w_tot + wdx.sum(dim=(1, 2, 3))
    force = force.reshape(3, -1)
    if not with_energy:
        return state.replace(f=force)
    return state.replace(f=force, potential_energy=0.5 * e_tot,
                         virial=0.5 * w_tot)


def assert_no_vacant_drift(state: PackedState, spec: PackedSpec) -> None:
    """Check the sentinel layout's invariant: every vacant slot sits at
    exactly ``VACANT_X``, which the kernels' vacancy test relies on; every
    repack and packed integrator re-pins vacant slots.  Raises
    AssertionError naming the count of drifted coordinates; a no-op
    outside the sentinel layout.  Reads the state on the host."""
    if spec.uniform_eps is None:
        return
    vac = (state.pid >= spec.n_real).cpu()
    r = state.r.cpu()[..., vac]
    bad = int((r != VACANT_X).sum())
    if bad:
        raise AssertionError(
            f"{bad} vacant-slot coordinates drifted off the VACANT_X "
            f"sentinel: an integrator or repack did not re-pin them")


def unpack_positions(state: PackedState, spec: PackedSpec) -> torch.Tensor:
    """(N, 3) particle-order positions (a gather: diagnostics only)."""
    return state.r[:, state.slot_of.long()].T


def packed_temperature(state: PackedState, spec: PackedSpec,
                       mass: float = 1.0) -> torch.Tensor:
    """Kinetic temperature; (W,) for a walker batch."""
    valid = (state.pid < spec.n_real).to(torch.float32)
    ke = 0.5 * mass * torch.sum((state.v * state.v) * valid[..., None, :],
                                dim=(-2, -1))
    dof = max(3 * spec.n_real - 3, 3)
    return 2.0 * ke / dof
