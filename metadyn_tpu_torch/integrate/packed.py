"""Integrators for the packed (slot-layout) state — (3, Npad) math
(counterpart of ``metadyn_tpu/integrate/packed.py``).

A step is ``step(state, generator=None, noise=None)``: the Langevin step
draws its noise from ``generator`` (a ``torch.Generator`` on the state's
device), or takes it as a (3, Npad) tensor, as the tests do to feed both
packages the same numbers.  Uniform particle mass.

The packed integrators do not wrap per step: a wrap would move a
coordinate by ±L while its slot's cell still implies the old side.
Positions drift continuously and the repack wraps them.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops.packed import VACANT_THR, VACANT_X, PackedState

PackedStepFn = Callable[..., PackedState]


def _pin_vacant(r_new: torch.Tensor, r_old: torch.Tensor) -> torch.Tensor:
    """Pin vacant slots at the exact coordinate sentinel across the step.

    The CUDA pair kernel culls vacant slots by the r² tests alone, which
    holds only while every vacant coordinate is exactly VACANT_X; so every
    integrator re-pins them each step (a no-op outside the sentinel
    layout, where no coordinate exceeds VACANT_THR)."""
    return torch.where(r_old > VACANT_THR, VACANT_X, r_new)


def make_packed_langevin_step(
    force_fn: Callable[[PackedState], PackedState],
    dt: float, kT: float, gamma: float = 1.0, mass: float = 1.0,
) -> PackedStepFn:
    """BAOAB Langevin on the packed state.

    ``force_fn`` returns the state, or a ``(state, extras)`` tuple; then
    ``step`` returns ``(state, extras)`` too.  The lagged multiple-time-
    stepping path uses the tuple form to carry fresh CV terms out of its
    trailing force call (``sampler.make_stride_chunk``)."""
    c1 = math.exp(-gamma * dt)
    c2 = math.sqrt((1.0 - c1 * c1) * kT / mass)
    h = 0.5 * dt / mass

    def step(state: PackedState, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None):
        v = state.v + h * state.f
        r = state.r + 0.5 * dt * v
        if noise is None:
            noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                device=v.device)
        v = c1 * v + c2 * noise
        r = r + 0.5 * dt * v
        out = force_fn(state.replace(r=_pin_vacant(r, state.r)))
        if isinstance(out, tuple):
            state, extras = out
            return state.replace(v=v + h * state.f), extras
        return out.replace(v=v + h * out.f)

    return step


def make_packed_nve_step(
    force_fn: Callable[[PackedState], PackedState],
    dt: float, mass: float = 1.0,
) -> PackedStepFn:
    """Velocity Verlet on the packed state (``generator`` is unused)."""
    h = 0.5 * dt / mass

    def step(state: PackedState,
             generator: Optional[torch.Generator] = None) -> PackedState:
        v_half = state.v + h * state.f
        r = _pin_vacant(state.r + dt * v_half, state.r)
        state = force_fn(state.replace(r=r))
        return state.replace(v=v_half + h * state.f)

    return step
