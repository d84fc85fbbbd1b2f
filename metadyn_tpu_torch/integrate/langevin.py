"""Langevin dynamics (BAOAB) and NVE velocity Verlet on the particle-order
state (counterpart of ``metadyn_tpu/integrate/langevin.py``; HOOMD's
``TwoStepLangevin`` and ``TwoStepNVE``).

Positions are wrapped into the box every step and the image counters
carry the lattice vectors removed.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core.box import wrap
from ..core.state import State, System
from .base import StepFn

ForceApply = Callable[[State], State]


def _moved(state: State, x: torch.Tensor) -> State:
    x, shift = wrap(x, state.box)
    return state.replace(pos=x, image=state.image + shift)


def make_langevin_step(force_apply: ForceApply, system: System, dt: float,
                       kT: float, gamma: float = 1.0) -> StepFn:
    """BAOAB: B(dt/2) A(dt/2) O(dt) A(dt/2) [forces] B(dt/2).  ``noise``
    is the (N, 3) standard normal of the O step."""
    mass = system.mass[:, None]
    c1 = math.exp(-gamma * dt)
    c2 = math.sqrt(1.0 - c1 * c1)
    sigma = c2 * torch.sqrt(kT / mass)

    def step(state: State, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> State:
        v = state.vel + 0.5 * dt * state.force / mass               # B
        x = state.pos + 0.5 * dt * v                                 # A
        if noise is None:
            noise = torch.randn(v.shape, generator=generator,
                                dtype=v.dtype, device=v.device)
        v = c1 * v + sigma * noise                                   # O
        x = x + 0.5 * dt * v                                         # A
        new = force_apply(_moved(state, x))
        return new.replace(vel=v + 0.5 * dt * new.force / mass)      # B

    return step


def make_nve_step(force_apply: ForceApply, system: System,
                  dt: float) -> StepFn:
    """Velocity Verlet (``generator`` and ``noise`` unused)."""
    mass = system.mass[:, None]

    def step(state: State, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> State:
        v_half = state.vel + 0.5 * dt * state.force / mass
        new = force_apply(_moved(state, state.pos + dt * v_half))
        return new.replace(vel=v_half + 0.5 * dt * new.force / mass)

    return step
