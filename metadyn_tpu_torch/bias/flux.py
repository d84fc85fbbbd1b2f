"""Flux-tempered metadynamics (counterpart of ``metadyn_tpu/bias/flux.py``).

One collective variable; no per-stride hill deposits.  A visit histogram
h(s) and a bin-crossing flux histogram f(s) accumulate on the device at
every CV evaluation, and at a fixed update period the bias is rebuilt from
them and the statistics reset.  The default rule (``FLUX``):

    V_new(s) = V_old(s) + gain·(kT/2)·ln[ (h+1)(f+1) / ((⟨h⟩+1)(⟨f⟩+1)) ]

drives sampling toward the round-trip-flux-optimal distribution
p ∝ 1/√D(s); ``VISITS`` is the plain half step gain·kT·ln[(h+1)/(⟨h⟩+1)].
The increment is smoothed by a 3-point binomial filter and the derivative
grid rebuilt from V by central differences (one-sided at the ends of a
non-periodic grid).  Everything is f32 on the grid's device; nothing here
reads a value to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .grid import BiasGrid, GridSpec
from .metad import BiasState

VISITS = "visits"
FLUX = "flux"


@dataclass(frozen=True)
class FluxState:
    """Per-update-period accumulators of a 1-D CV, on the grid's device."""

    hist: torch.Tensor       # (n,) f32 visit counts
    flux_up: torch.Tensor    # (n,) f32 rightward bin-boundary crossings
    flux_down: torch.Tensor  # (n,) f32 leftward crossings
    prev_bin: torch.Tensor   # () int32, -1 before the first visit

    @classmethod
    def zeros(cls, spec: GridSpec) -> "FluxState":
        if spec.ndim != 1:
            raise AssertionError("flux-tempered metadynamics supports 1 CV")
        z = torch.zeros(spec.shape[0], dtype=torch.float32,
                        device=spec.device)
        return cls(hist=z, flux_up=z, flux_down=z,
                   prev_bin=torch.full((), -1, dtype=torch.int32,
                                       device=spec.device))


def bin_of(spec: GridSpec, s: torch.Tensor) -> torch.Tensor:
    """The nearest grid node of s (a 0-d int32 tensor): bins are centred on
    the nodes the update writes V to.  ``torch.round`` rounds half to even,
    as ``jnp.round`` does; periodic grids wrap, others clip to the ends."""
    n = spec.shape[0]
    b = torch.round((s[0] - spec.lo[0]) / spec.spacing(0)).to(torch.int32)
    if spec.periodic[0]:
        return torch.remainder(b, n)
    return torch.clamp(b, 0, n - 1)


def accumulate(flux: FluxState, spec: GridSpec,
               s: torch.Tensor) -> FluxState:
    """One visit at s and the direction of its crossing from the last bin,
    on the device (fresh tensors: no host read)."""
    b = bin_of(spec, s)
    idx = b.reshape(1).to(torch.int64)
    seen = flux.prev_bin >= 0
    up = ((b > flux.prev_bin) & seen).to(torch.float32).reshape(1)
    down = ((b < flux.prev_bin) & seen).to(torch.float32).reshape(1)
    one = torch.ones(1, dtype=torch.float32, device=b.device)
    return FluxState(hist=flux.hist.index_add(0, idx, one),
                     flux_up=flux.flux_up.index_add(0, idx, up),
                     flux_down=flux.flux_down.index_add(0, idx, down),
                     prev_bin=b)


def _smooth(dV: torch.Tensor, periodic: bool) -> torch.Tensor:
    """3-point binomial smoothing (periodic, or with the ends repeated)."""
    if periodic:
        return (0.25 * torch.roll(dV, 1) + 0.5 * dV
                + 0.25 * torch.roll(dV, -1))
    pad = torch.cat([dV[:1], dV, dV[-1:]])
    return 0.25 * pad[:-2] + 0.5 * pad[1:-1] + 0.25 * pad[2:]


def update_bias(bias: BiasState, flux: FluxState, kT: float,
                gain: float = 0.5, rule: str = FLUX
                ) -> tuple[BiasState, FluxState]:
    """Histogram → bias rebuild and statistics reset (the periodic update).

    The +1 pseudocounts keep unvisited bins finite: they get a negative
    increment (become relatively attractive) rather than a cliff whose
    finite-difference force would trap the walker."""
    spec = bias.grid.spec
    h = flux.hist
    h_mean = torch.mean(h)
    if rule == FLUX:
        f = flux.flux_up + flux.flux_down
        f_mean = torch.mean(f)
        dV = gain * 0.5 * kT * (
            torch.log((h + 1.0) / (h_mean + 1.0))
            + torch.log((f + 1.0) / (f_mean + 1.0)))
    else:
        dV = gain * kT * torch.log((h + 1.0) / (h_mean + 1.0))
    V = bias.grid.V + _smooth(dV, spec.periodic[0])
    dx = spec.spacing(0)
    dVds = (torch.roll(V, -1) - torch.roll(V, 1)) / (2 * dx)
    if not spec.periodic[0]:
        dVds = torch.cat([((V[1] - V[0]) / dx).reshape(1), dVds[1:-1],
                          ((V[-1] - V[-2]) / dx).reshape(1)])
    grid = BiasGrid(spec=spec, V=V, dV=dVds[None, :])
    return (BiasState(grid=grid, n_hills=bias.n_hills + 1),
            FluxState.zeros(spec))


def round_trips(flux: FluxState) -> torch.Tensor:
    """Convergence diagnostic: the smaller directional flux through the mid
    bin (a 0-d device tensor)."""
    mid = flux.hist.shape[0] // 2
    return torch.minimum(flux.flux_up[mid], flux.flux_down[mid])
