"""Simulation box (orthorhombic or triclinic) and periodic-boundary math.

Counterpart of ``metadyn_tpu/core/box.py``: HOOMD's ``BoxDim`` convention,
with tilt factors ``(xy, xz, yz)`` defining the upper-triangular cell matrix

    h = [[Lx, xy*Ly, xz*Lz],
         [0,  Ly,    yz*Lz],
         [0,  0,     Lz   ]]

so a lattice point is ``r = h @ f`` with fractional ``f``.

The box keeps ``L`` and the tilt twice: as (3,) f32 tensors on the device
for tensor math, and as host floats (``L_host``, ``tilt_host``: the same f32
values) so that a kernel launch gets the box without a device-to-host read.
The NVT box is constant, so the two never drift apart; a box whose tilt
tensor and host floats disagree in presence is refused at construction.

The triangular transforms are elementwise, never a matmul: a reduced
precision matrix product there once cost the reference ~1e-3 of relative
accuracy in wrapping and binning.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class Box:
    """Periodic box: edge lengths ``L`` plus optional tilt (None ⇒
    orthorhombic)."""

    L: torch.Tensor                       # (3,) f32
    L_host: tuple                         # (Lx, Ly, Lz) host floats
    tilt: Optional[torch.Tensor] = None   # (3,) f32 = (xy, xz, yz), or None
    tilt_host: Optional[tuple] = None     # (xy, xz, yz) host floats, or None

    def __post_init__(self):
        if (self.tilt is None) != (self.tilt_host is None):
            raise ValueError("Box: the tilt tensor and its host floats "
                             "(tilt_host) must be given together")

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
        box = cls.from_lengths(Lx, Ly, Lz, device)
        tilt = np.asarray([xy, xz, yz], np.float32)
        return dataclasses.replace(
            box, tilt=torch.as_tensor(tilt, device=device),
            tilt_host=tuple(float(x) for x in tilt))

    @property
    def volume(self) -> torch.Tensor:
        # det h = Lx*Ly*Lz regardless of tilt (upper triangular)
        return torch.prod(self.L)

    @property
    def is_triclinic(self) -> bool:
        return self.tilt is not None

    def h_host(self) -> tuple:
        """The cell matrix's six entries as host floats, (Lx, Ly, Lz, xy·Ly,
        xz·Lz, yz·Lz), each product rounded to f32 as the plain sweeps form
        it (``ops.packed.shift_rows_cart``); zero tilt when orthorhombic."""
        L = np.asarray(self.L_host, np.float32)
        t = np.asarray(self.tilt_host or (0.0, 0.0, 0.0), np.float32)
        return (*(float(x) for x in L), float(t[0] * L[1]),
                float(t[1] * L[2]), float(t[2] * L[2]))

    def perpendicular_widths_host(self) -> tuple:
        """:func:`perpendicular_widths` as host floats (float64 from
        ``h_host``): the distances between opposite faces, for kernel
        launches that must not read the device."""
        return _widths_of(self.h_host())

    def to(self, device) -> "Box":
        return dataclasses.replace(
            self, L=self.L.to(device),
            tilt=None if self.tilt is None else self.tilt.to(device))


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
    with no matrix product."""
    if box.tilt is None:
        return box.L
    h = h_matrix(box)
    a, b, c = h[:, 0], h[:, 1], h[:, 2]
    bc, ca, ab = (torch.linalg.cross(b, c), torch.linalg.cross(c, a),
                  torch.linalg.cross(a, b))
    vol = torch.abs(torch.sum(a * bc))
    return vol / torch.sqrt(torch.stack([torch.sum(bc * bc),
                                         torch.sum(ca * ca),
                                         torch.sum(ab * ab)]))


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
    """One box per walker, stacked: ``L`` (W, 3), ``tilt`` (W, 3) or None,
    and the host floats as one tuple per walker."""
    tilted = {b.tilt is not None for b in boxes}
    if len(tilted) != 1:
        raise ValueError("stack_boxes: every walker's box must be tilted, "
                         "or none")
    return Box(L=torch.stack([b.L for b in boxes]),
               L_host=tuple(b.L_host for b in boxes),
               tilt=(torch.stack([b.tilt for b in boxes])
                     if tilted == {True} else None),
               tilt_host=(tuple(b.tilt_host for b in boxes)
                          if tilted == {True} else None))


def walker_box(box: Box, w: int) -> Box:
    """Walker ``w``'s box of a stacked box (views of its tensors)."""
    return Box(L=box.L[w], L_host=box.L_host[w],
               tilt=None if box.tilt is None else box.tilt[w],
               tilt_host=None if box.tilt_host is None else box.tilt_host[w])


def shared_box(box: Box) -> Box:
    """The one box of a walker batch: ``box`` itself when it is not
    stacked, else walker 0's after checking, on the host floats, that every
    walker has the same box.  The batched pair kernel and the batched CVs
    take one cell matrix for all walkers; walkers with boxes of their own
    (NPT) would need one per walker."""
    if box.L.dim() == 1:
        return box
    if (len(set(box.L_host)) != 1
            or (box.tilt_host is not None and len(set(box.tilt_host)) != 1)):
        raise ValueError("the walkers' boxes differ: the walker batch takes "
                         "one box for all walkers (NPT walkers need a "
                         "per-walker cell matrix, ROADMAP queue 1 item 3)")
    return walker_box(box, 0)
