"""Hill-list (non-grid) bias mode (counterpart of
``metadyn_tpu/bias/hill_list.py``).

With no grid registered, V(s) is the list of deposited hills, and V and
∂V/∂s are an analytic sum over all of them at every evaluation.  The list
is a buffer of fixed capacity on the device (centres, heights), and the
sum a masked dense reduction over the whole buffer, so its shapes never
change and the hill count stays on the device: no host read per step.
When the buffer is full, a new hill goes onto a coarse spill grid where
one is configured (no bias is lost), or is dropped with the
``overflowed`` flag raised.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .grid import BiasGrid, GridSpec, hill_field
from .grid import value_and_grad as grid_value_and_grad


@dataclass(frozen=True)
class HillListBias:
    """The capped hill buffer (and an optional spill grid), on the device."""

    centers: torch.Tensor        # (capacity, d)
    heights: torch.Tensor        # (capacity,)
    sigma: torch.Tensor          # (d,) shared hill widths
    n_hills: torch.Tensor        # () i32: every hill deposited, spilled too
    overflowed: torch.Tensor     # () bool: a hill was dropped (no spill)
    spill: Optional[BiasGrid]    # the coarse grid of overflow hills, or None

    @property
    def capacity(self) -> int:
        return self.centers.shape[0]

    @classmethod
    def create(cls, sigma: Sequence[float], capacity: int = 4096,
               spill_spec: Optional[GridSpec] = None,
               device=None) -> "HillListBias":
        """An empty buffer on ``device`` (default: the spill grid's, else
        the CPU)."""
        if device is None:
            device = spill_spec.device if spill_spec is not None else "cpu"
        sig = torch.atleast_1d(torch.as_tensor(sigma, dtype=torch.float32,
                                               device=device))
        d = sig.shape[0]
        return cls(
            centers=torch.zeros((capacity, d), dtype=torch.float32,
                                device=device),
            heights=torch.zeros(capacity, dtype=torch.float32, device=device),
            sigma=sig,
            n_hills=torch.zeros((), dtype=torch.int32, device=device),
            overflowed=torch.zeros((), dtype=torch.bool, device=device),
            spill=(BiasGrid.zeros(spill_spec) if spill_spec is not None
                   else None))

    def replace(self, **changes) -> "HillListBias":
        return dataclasses.replace(self, **changes)


def value_and_grad(bias: HillListBias, s: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic V(s) and ∂V/∂s over the buffer (plus the spill grid's
    interpolation): () and (d,), or (W,) and (W, d) at W points (W, d)."""
    d = (s[..., None, :] - bias.centers) / bias.sigma           # (…, cap, d)
    g = torch.exp(-0.5 * torch.sum(d * d, dim=-1))              # (…, cap)
    k = torch.arange(bias.capacity, device=s.device)
    w = torch.where(k < torch.clamp(bias.n_hills, max=bias.capacity),
                    bias.heights * g, 0.0)
    V = torch.sum(w, dim=-1)
    grad = torch.sum(w[..., None] * (-d / bias.sigma), dim=-2)
    if bias.spill is not None:
        Vs, gs = grid_value_and_grad(bias.spill, s)
        V = V + Vs
        grad = grad + gs
    return V, grad


def deposit(bias: HillListBias, s: torch.Tensor,
            height: torch.Tensor) -> HillListBias:
    """Append one hill; past capacity, spill it onto the coarse grid (or
    drop it with the overflow flag raised).  Shapes never change and
    nothing is read to the host."""
    idx = torch.clamp(bias.n_hills, max=bias.capacity - 1).long()
    in_buf = bias.n_hills < bias.capacity
    # write slot idx: the new hill while the buffer has room, else the
    # entry already there
    hit = (torch.arange(bias.capacity, device=s.device) == idx) & in_buf
    centers = torch.where(hit[:, None], s[None, :], bias.centers)
    heights = torch.where(hit, height, bias.heights)
    spill, overflowed = bias.spill, bias.overflowed
    if spill is not None:
        dV, ddV = hill_field(spill.spec, s, torch.where(in_buf, 0.0, height))
        spill = spill.replace(V=spill.V + dV, dV=spill.dV + ddV)
    else:
        overflowed = overflowed | ~in_buf
    return bias.replace(centers=centers, heights=heights, spill=spill,
                        n_hills=bias.n_hills + 1, overflowed=overflowed)


def evaluate_on_grid(bias: HillListBias, spec: GridSpec) -> torch.Tensor:
    """Dense V(s) on a query grid (the FES reconstruction), (*shape,)."""
    axes = [spec.axis_coords(d) for d in range(spec.ndim)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    pts = torch.stack([m.reshape(-1) for m in mesh], dim=1)     # (P, d)
    # in blocks of points: a (P, capacity, d) temporary would be large
    V = torch.cat([value_and_grad(bias, p)[0]
                   for p in torch.split(pts, 1024)])
    return V.reshape(spec.shape)
