"""Simulation box (orthorhombic or triclinic) and periodic-boundary math.

Counterpart of ``metadyn_tpu/core/box.py``: HOOMD's ``BoxDim`` convention,
with tilt factors ``(xy, xz, yz)`` defining the upper-triangular cell matrix

    h = [[Lx, xy*Ly, xz*Lz],
         [0,  Ly,    yz*Lz],
         [0,  0,     Lz   ]]

so a lattice point is ``r = h @ f`` with fractional ``f``.

The box lives on the device: ``L`` and the tilt as (3,) f32 tensors, and
one row of geometry ``geo`` (BOX_ROW,) f32 that every kernel reads from
device memory: the cell matrix's six entries ``h`` = (Lx, Ly, Lz, xy·Ly,
xz·Lz, yz·Lz), then the perpendicular ``widths`` and their sum (the order
kernels' prefilter scale).  A walker batch stacks them per walker: (W, 3)
and (W, BOX_ROW), one box each.

A box built from host numbers (``from_lengths``, ``cubic``,
``triclinic``) also keeps them as host floats (``L_host``, ``tilt_host``:
the same f32 values) for build-time checks (the cell grid against the
cut-off, the pack).  A box that a step made on the device (``moved``,
``rescaled``: the NPT barostat's) has none: reading its host floats
raises :class:`MovedBoxError`, so nothing can read a stale box and nothing
pays a device-to-host read to refresh one.

The triangular transforms are elementwise, never a matmul: a reduced
precision matrix product there once cost the reference ~1e-3 of relative
accuracy in wrapping and binning.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


class MovedBoxError(RuntimeError):
    """Raised on reading the host floats of a box that a step moved."""


# the stored value of a host-float field on a box that a step moved
_MOVED = type("MovedHostFloats", (), {"__repr__": lambda self: "<moved>"})()


class _HostFloats:
    """A host-float field of :class:`Box`: the stored tuple, or
    :class:`MovedBoxError` on a box that a step moved (its floats would be
    the old box's, and refreshing them would cost a device-to-host read)."""

    def __set_name__(self, owner, name):
        self.name = name
        self.slot = "_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return None           # the dataclass default
        v = obj.__dict__.get(self.slot)
        if v is _MOVED:
            raise MovedBoxError(
                f"Box.{self.name}: this box was moved on the device (an NPT "
                "step rescaled it); it has no host floats")
        return v

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value


# a box's row of device geometry, the kernels' input: the cell matrix's six
# entries, then the three perpendicular widths and their sum (the order
# kernels' prefilter scale); csrc/cell_geom.cuh kBoxRow
BOX_ROW = 10


def _geo_host(L_host, tilt_host) -> np.ndarray:
    """The geometry row(s) from host floats: the products of the cell
    matrix in f32, as the plain sweeps form them; the widths and their sum
    in float64, each rounded to f32 once."""
    if L_host and isinstance(L_host[0], tuple):
        return np.stack([_geo_host(L, None if tilt_host is None else t)
                         for L, t in zip(L_host, tilt_host or
                                         [None] * len(L_host))])
    L = np.asarray(L_host, np.float32)
    t = np.asarray(tilt_host or (0.0, 0.0, 0.0), np.float32)
    h = (*(float(x) for x in L), float(t[0] * L[1]), float(t[1] * L[2]),
         float(t[2] * L[2]))
    w = _widths_of(h)
    return np.asarray((*h, *w, sum(w)), np.float32)


def _geo_device(L: torch.Tensor, tilt: Optional[torch.Tensor]):
    """The geometry row(s) of a box that lives on the device, in f32
    there: (..., BOX_ROW)."""
    if tilt is None:
        return torch.cat([L, torch.zeros_like(L), L,
                          L.sum(-1, keepdim=True)], dim=-1).contiguous()
    Lx, Ly, Lz = L[..., 0], L[..., 1], L[..., 2]
    xyLy, xzLz, yzLz = tilt[..., 0] * Ly, tilt[..., 1] * Lz, tilt[..., 2] * Lz
    v = Lx * Ly * Lz
    bx, by, bz = Ly * Lz, -xyLy * Lz, xyLy * yzLz - Ly * xzLz
    w = torch.stack([v / torch.sqrt(bx * bx + by * by + bz * bz),
                     v / (Lx * torch.sqrt(Lz * Lz + yzLz * yzLz)), Lz], -1)
    return torch.cat([L, torch.stack([xyLy, xzLz, yzLz], -1), w,
                      w.sum(-1, keepdim=True)], dim=-1).contiguous()


@dataclass(frozen=True, eq=False)
class Box:
    """Periodic box: edge lengths ``L`` plus optional tilt (None ⇒
    orthorhombic), and the device geometry ``geo`` that every kernel
    reads: the cell matrix ``h`` and the perpendicular ``widths``.

    Build boxes with the constructors (``from_lengths``, ``cubic``,
    ``triclinic``, ``moved``, ``rescaled``, ``to``), not with
    ``dataclasses.replace``: ``geo`` is derived from the others."""

    L: torch.Tensor                       # (3,) f32; (W, 3) stacked
    L_host: tuple = _HostFloats()         # (Lx, Ly, Lz) host floats
    tilt: Optional[torch.Tensor] = None   # (3,) f32 = (xy, xz, yz), or None
    tilt_host: Optional[tuple] = _HostFloats()  # (xy, xz, yz), or None
    geo: Optional[torch.Tensor] = None    # (BOX_ROW,) f32; (W, BOX_ROW)

    def __post_init__(self):
        tilt_host = self.__dict__.get("_tilt_host")
        if self.tilt is None and tilt_host is not None:
            raise ValueError("Box: tilt_host without a tilt tensor")
        if (self.tilt is not None and tilt_host is None
                and self.__dict__.get("_L_host") is not _MOVED):
            raise ValueError("Box: the tilt tensor and its host floats "
                             "(tilt_host) must be given together")
        if self.geo is None:
            geo = (torch.as_tensor(_geo_host(self.L_host, self.tilt_host),
                                   device=self.L.device) if self.fixed
                   else _geo_device(self.L, self.tilt))
            object.__setattr__(self, "geo", geo)

    @classmethod
    def from_lengths(cls, Lx: float, Ly: float, Lz: float,
                     device) -> "Box":
        L = np.asarray([Lx, Ly, Lz], np.float32)
        return cls(L=torch.as_tensor(L, device=device),
                   L_host=tuple(float(x) for x in L))

    @classmethod
    def cubic(cls, L: float, device) -> "Box":
        return cls.from_lengths(L, L, L, device)

    @classmethod
    def triclinic(cls, Lx: float, Ly: float, Lz: float, device,
                  xy: float = 0.0, xz: float = 0.0, yz: float = 0.0) -> "Box":
        """HOOMD-convention triclinic box (dimensionless tilt factors)."""
        L = np.asarray([Lx, Ly, Lz], np.float32)
        tilt = np.asarray([xy, xz, yz], np.float32)
        return cls(L=torch.as_tensor(L, device=device),
                   L_host=tuple(float(x) for x in L),
                   tilt=torch.as_tensor(tilt, device=device),
                   tilt_host=tuple(float(x) for x in tilt))

    @classmethod
    def moved(cls, L: torch.Tensor,
              tilt: Optional[torch.Tensor] = None) -> "Box":
        """A box that lives on the device alone (a step made it): its
        host floats raise :class:`MovedBoxError`."""
        return cls(L=L, L_host=_MOVED, tilt=tilt,
                   tilt_host=None if tilt is None else _MOVED)

    def rescaled(self, scale: torch.Tensor) -> "Box":
        """The orthorhombic box with ``L · scale`` (scale (3,), (W, 3) or
        broadcastable), on the device: no host floats."""
        if self.tilt is not None:
            raise ValueError("Box.rescaled: a per-axis rescale of a tilted "
                             "box does not keep its tilt factors")
        return Box.moved(self.L * scale)

    @property
    def fixed(self) -> bool:
        """True when the box has its host floats (it was not moved)."""
        return self.__dict__.get("_L_host") is not _MOVED

    @property
    def volume(self) -> torch.Tensor:
        # det h = Lx*Ly*Lz regardless of tilt (upper triangular); (W,)
        # for a stacked box
        return torch.prod(self.L, dim=-1)

    @property
    def is_triclinic(self) -> bool:
        return self.tilt is not None

    def h_host(self) -> tuple:
        """The cell matrix's six entries as host floats, (Lx, Ly, Lz, xy·Ly,
        xz·Lz, yz·Lz), each product rounded to f32 as the plain sweeps form
        it (``ops.packed.shift_rows_cart``); zero tilt when orthorhombic.
        Build-time checks only: the kernels read ``h``."""
        L = np.asarray(self.L_host, np.float32)
        t = np.asarray(self.tilt_host or (0.0, 0.0, 0.0), np.float32)
        return (*(float(x) for x in L), float(t[0] * L[1]),
                float(t[1] * L[2]), float(t[2] * L[2]))

    def perpendicular_widths_host(self) -> tuple:
        """:func:`perpendicular_widths` as host floats (float64 from
        ``h_host``), for build-time checks."""
        return _widths_of(self.h_host())

    @property
    def h(self) -> torch.Tensor:
        """(6,) f32 the cell matrix's entries on the device, (Lx, Ly, Lz,
        xy·Ly, xz·Lz, yz·Lz); (W, 6) stacked."""
        return self.geo[..., :6]

    @property
    def widths(self) -> torch.Tensor:
        """(3,) f32 the perpendicular widths on the device: from the host
        floats of a fixed box (rounded to f32 once), computed in f32 there
        for a moved one; (W, 3) stacked."""
        return self.geo[..., 6:9]

    def to(self, device) -> "Box":
        L = self.L.to(device)
        if L is self.L:
            return self
        d = self.__dict__
        return Box(L=L, L_host=d.get("_L_host"),
                   tilt=None if self.tilt is None else self.tilt.to(device),
                   tilt_host=d.get("_tilt_host"), geo=self.geo.to(device))


@functools.lru_cache(maxsize=64)
def _widths_of(h: tuple) -> tuple:
    Lx, Ly, Lz, xyLy, xzLz, yzLz = h
    a = np.array([Lx, 0.0, 0.0])
    b = np.array([xyLy, Ly, 0.0])
    c = np.array([xzLz, yzLz, Lz])
    vol = abs(float(np.dot(a, np.cross(b, c))))
    return tuple(vol / float(np.linalg.norm(np.cross(u, v)))
                 for u, v in ((b, c), (c, a), (a, b)))


def h_matrix(box: Box) -> torch.Tensor:
    """(3, 3) upper-triangular cell matrix h (columns = lattice vectors)."""
    if box.tilt is None:
        return torch.diag(box.L)
    Lx, Ly, Lz = box.L.unbind()
    xy, xz, yz = box.tilt.unbind()
    z = torch.zeros_like(Lx)
    return torch.stack([
        torch.stack([Lx, xy * Ly, xz * Lz]),
        torch.stack([z, Ly, yz * Lz]),
        torch.stack([z, z, Lz]),
    ])


def h_inverse(box: Box) -> torch.Tensor:
    """Closed-form inverse of the upper-triangular cell matrix."""
    if box.tilt is None:
        return torch.diag(1.0 / box.L)
    Lx, Ly, Lz = box.L.unbind()
    xy, xz, yz = box.tilt.unbind()
    z = torch.zeros_like(Lx)
    return torch.stack([
        torch.stack([1.0 / Lx, -xy / Lx, (xy * yz - xz) / Lx]),
        torch.stack([z, 1.0 / Ly, -yz / Ly]),
        torch.stack([z, z, 1.0 / Lz]),
    ])


def perpendicular_widths(box: Box) -> torch.Tensor:
    """(3,) f32 distances between opposite faces of the cell: V/|b×c|,
    V/|c×a|, V/|a×b| for the columns a, b, c of h (``L`` when
    orthorhombic).  Cross and dot products written out elementwise, in f32,
    with no matrix product; (W, 3) for a stacked box."""
    if box.tilt is None:
        return box.L
    if box.L.dim() == 2:
        return torch.stack([perpendicular_widths(walker_box(box, w))
                            for w in range(box.L.shape[0])])
    h = h_matrix(box)
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    bc, ca, ab = (torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                  torch.linalg.cross(a, b))
    vol = torch.abs(torch.sum(a * bc))
    return vol / torch.sqrt(torch.stack([torch.sum(bc * bc),
                                         torch.sum(ca * ca),
                                         torch.sum(ab * ab)]))


def min_perpendicular_width(box: Box) -> torch.Tensor:
    """(3,) perpendicular widths of the cell (the distances between
    opposite faces), the reference's name for :func:`perpendicular_widths`.
    Interaction cut-offs must stay below half the smallest width for the
    fractional-rounding minimum image to be exact."""
    return perpendicular_widths(box)


def reciprocal_matrix(box: Box) -> torch.Tensor:
    """Reciprocal basis B = h⁻¹: ``k = 2π (n @ B)`` is the wave vector of
    integer Miller row(s) n.  Orthorhombic: B = diag(1/L)."""
    return h_inverse(box)


def fractional(pos: torch.Tensor, box: Box) -> torch.Tensor:
    """Cartesian (..., 3) → fractional f = h⁻¹ r (elementwise solve)."""
    if box.tilt is None:
        return pos / box.L
    Lx, Ly, Lz = box.L.unbind()
    xy, xz, yz = box.tilt.unbind()
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    fz = z / Lz
    fy = (y - yz * z) / Ly
    fx = (x - xy * (y - yz * z) - xz * z) / Lx
    return torch.stack([fx, fy, fz], dim=-1)


def from_fractional(frac: torch.Tensor, box: Box) -> torch.Tensor:
    """Fractional (..., 3) → Cartesian r = h f (elementwise product)."""
    if box.tilt is None:
        return frac * box.L
    Lx, Ly, Lz = box.L.unbind()
    xy, xz, yz = box.tilt.unbind()
    f0, f1, f2 = frac[..., 0], frac[..., 1], frac[..., 2]
    r2 = Lz * f2
    r1 = Ly * f1 + yz * Lz * f2
    r0 = Lx * f0 + xy * Ly * f1 + xz * Lz * f2
    return torch.stack([r0, r1, r2], dim=-1)


def minimum_image(dr: torch.Tensor, box: Box) -> torch.Tensor:
    """Minimum-image displacement vectors ``dr`` (..., 3).  A tilted box
    rounds in fractional coordinates, elementwise (HOOMD's convention:
    exact for ranges below half the smallest perpendicular width)."""
    if box.tilt is None:
        return dr - box.L * torch.round(dr / box.L)
    return dr - from_fractional(torch.round(fractional(dr, box)), box)


def wrap(pos: torch.Tensor, box: Box) -> tuple[torch.Tensor, torch.Tensor]:
    """Wrap positions into the primary cell (fractional [-1/2, 1/2) per
    lattice axis).  Returns (wrapped, image_shift) with the int32 count of
    lattice vectors removed."""
    if box.tilt is None:
        shift = torch.floor(pos / box.L + 0.5)
        return pos - box.L * shift, shift.to(torch.int32)
    shift = torch.floor(fractional(pos, box) + 0.5)
    return pos - from_fractional(shift, box), shift.to(torch.int32)


def unwrap(pos: torch.Tensor, image: torch.Tensor, box: Box) -> torch.Tensor:
    """Unwrapped coordinates from wrapped positions and int32 images (the
    images count lattice vectors)."""
    if box.tilt is None:
        return pos + image.to(pos.dtype) * box.L
    return pos + from_fractional(image.to(pos.dtype), box)


def stack_boxes(boxes) -> Box:
    """One box per walker, stacked: ``L`` and ``geo`` (W, 3) and (W,
    BOX_ROW), ``tilt`` (W, 3) or None; the host floats one tuple per
    walker, or none where a walker's box was moved."""
    tilted = {b.tilt is not None for b in boxes}
    if len(tilted) != 1:
        raise ValueError("stack_boxes: every walker's box must be tilted, "
                         "or none")
    tilt = (torch.stack([b.tilt for b in boxes]) if tilted == {True}
            else None)
    stacked = dict(L=torch.stack([b.L for b in boxes]), tilt=tilt,
                   geo=torch.stack([b.geo for b in boxes]))
    if not all(b.fixed for b in boxes):
        return Box(L_host=_MOVED, tilt_host=None if tilt is None else _MOVED,
                   **stacked)
    return Box(L_host=tuple(b.L_host for b in boxes),
               tilt_host=(tuple(b.tilt_host for b in boxes)
                          if tilt is not None else None), **stacked)


def box_from_tensors(L: torch.Tensor,
                     tilt: Optional[torch.Tensor] = None) -> Box:
    """A box of the given tensors (a stacked box for (W, 3) ones) with its
    host floats read from them: one device-to-host read, for loading a
    checkpoint, never inside a run."""
    def host(t):
        a = t.detach().cpu().numpy().astype(np.float32)
        return (tuple(float(x) for x in a) if a.ndim == 1
                else tuple(tuple(float(x) for x in row) for row in a))

    return Box(L=L, L_host=host(L), tilt=tilt,
               tilt_host=None if tilt is None else host(tilt))


def walker_box(box: Box, w: int) -> Box:
    """Walker ``w``'s box of a stacked box (views of its tensors)."""
    d = box.__dict__
    L_host, tilt_host = d.get("_L_host"), d.get("_tilt_host")
    return Box(L=box.L[w], L_host=L_host if L_host is _MOVED else L_host[w],
               tilt=None if box.tilt is None else box.tilt[w],
               tilt_host=(tilt_host if tilt_host in (None, _MOVED)
                          else tilt_host[w]), geo=box.geo[w])
