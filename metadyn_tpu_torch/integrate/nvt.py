"""Nosé–Hoover and Bussi–Donadio–Parrinello NVT on the particle-order state
(counterpart of ``metadyn_tpu/integrate/nvt.py``; HOOMD's ``TwoStepNVT``).

- :func:`make_nvt_nh_step`: one Nosé–Hoover variable ξ (``State.xi``) in a
  velocity-Verlet splitting; deterministic.
- :func:`make_nvt_bdp_step`: velocity Verlet and a stochastic global
  rescale per step.  As in the reference, the χ² sum of the other dof − 1
  normals is approximated by one Gaussian, so a step draws two normals;
  ``noise`` is the pair (r1, r2) as a (2,) tensor.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.state import State, System, kinetic_energy
from .base import StepFn
from .langevin import ForceApply, _moved


def make_nvt_nh_step(force_apply: ForceApply, system: System, dt: float,
                     kT: float, tau: float = 0.5) -> StepFn:
    """Nosé–Hoover NVT (a single thermostat), ξ carried in the state."""
    mass = system.mass[:, None]
    dof = max(3 * system.n - 3, 3)
    Q = dof * kT * tau * tau

    def step(state: State, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> State:
        ke = kinetic_energy(state, system)
        xi = state.xi + 0.5 * dt * (2.0 * ke - dof * kT) / Q
        v = state.vel * torch.exp(-xi * 0.5 * dt)
        v = v + 0.5 * dt * state.force / mass
        new = force_apply(_moved(state, state.pos + dt * v))
        v = v + 0.5 * dt * new.force / mass
        v = v * torch.exp(-xi * 0.5 * dt)
        ke = 0.5 * torch.sum(mass * v * v)
        xi = xi + 0.5 * dt * (2.0 * ke - dof * kT) / Q
        return new.replace(vel=v, xi=xi)

    return step


def make_nvt_bdp_step(force_apply: ForceApply, system: System, dt: float,
                      kT: float, tau: float = 0.5) -> StepFn:
    """Canonical velocity rescaling (Bussi–Donadio–Parrinello 2007)."""
    mass = system.mass[:, None]
    dof = max(3 * system.n - 3, 3)
    c = math.exp(-dt / tau)
    kbar = 0.5 * dof * kT

    def step(state: State, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> State:
        v_half = state.vel + 0.5 * dt * state.force / mass
        new = force_apply(_moved(state, state.pos + dt * v_half))
        v = v_half + 0.5 * dt * new.force / mass
        ke = 0.5 * torch.sum(mass * v * v)
        if noise is None:
            noise = torch.randn(2, generator=generator, dtype=v.dtype,
                                device=v.device)
        r1 = noise[0]
        rsum = noise[1] * math.sqrt(2.0 * (dof - 1)) + (dof - 1)
        alpha2 = (c + (1 - c) * kbar / (dof * ke) * (r1 * r1 + rsum)
                  + 2.0 * r1 * torch.sqrt(c * (1 - c) * kbar / (dof * ke)))
        alpha2 = torch.clamp(alpha2, min=1e-8)
        return new.replace(vel=v * torch.sqrt(alpha2))

    return step
