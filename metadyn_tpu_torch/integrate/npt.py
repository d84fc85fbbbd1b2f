"""NPT on the particle-order state: BAOAB Langevin plus the stochastic cell
rescaling barostat (counterpart of ``metadyn_tpu/integrate/npt.py``;
Bernetti & Bussi, J. Chem. Phys. 153, 114107 (2020)), in plain PyTorch as
the reference runs it as XLA.

Anisotropic mode moves Lx, Ly, Lz on their own against the per-axis
internal pressure P_d = (Σ m v_d² + W_d)/V from the diagonal virial in
``state.virial``; ``box_bias_fn(state) -> ∂V/∂L`` lets a box CV's
metadynamics bias act on the box (``cv/aspect_ratio.py``).  The new box
is made on the device (``Box.rescaled``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..core.box import wrap
from ..core.state import State, System
from .base import StepFn
from .langevin import ForceApply


def make_npt_scr_step(
    force_apply: ForceApply,
    system: System,
    dt: float,
    kT: float,
    pressure: float,
    gamma: float = 1.0,
    tau_p: float = 2.0,
    anisotropic: bool = False,
    box_bias_fn: Optional[Callable[[State], torch.Tensor]] = None,
    kappa: float = 0.1,
) -> StepFn:
    """``step(state, generator=None, noise=None, baro_noise=None)``: the
    (N, 3) normal draw of the particles and the barostat's (() isotropic,
    (3,) anisotropic) come from ``generator`` or are given.  ``kappa``,
    the isothermal compressibility's estimate, sets the barostat's time
    scale, not the ensemble sampled."""
    mass = system.mass[:, None]
    c1 = math.exp(-gamma * dt)
    c2 = math.sqrt(1.0 - c1 * c1)
    sigma = c2 * torch.sqrt(kT / mass)

    def step(state: State, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             baro_noise: Optional[torch.Tensor] = None) -> State:
        if state.box.tilt is not None:
            raise ValueError("NPT cell rescaling takes an orthorhombic box: "
                             "a per-axis L scale at fixed tilt is not a "
                             "componentwise position map")
        v = state.vel + 0.5 * dt * state.force / mass               # B
        x = state.pos + 0.5 * dt * v                                 # A
        if noise is None:
            noise = torch.randn(v.shape, generator=generator,
                                dtype=v.dtype, device=v.device)
        v = c1 * v + sigma * noise                                   # O
        x = x + 0.5 * dt * v                                         # A
        if baro_noise is None:
            baro_noise = torch.randn((3,) if anisotropic else (),
                                     generator=generator, dtype=v.dtype,
                                     device=v.device)
        # --- the barostat: stochastic cell rescaling ---
        ke = 0.5 * torch.sum(mass * v * v)
        vol = state.box.volume
        if anisotropic:
            ke2_d = torch.sum(mass * v * v, dim=0)
            dP = (ke2_d + state.virial) / vol - pressure
            if box_bias_fn is not None:
                # the bias stress along axis d, −(∂V/∂L_d)·L_d / V
                dP = dP - box_bias_fn(state) * state.box.L / vol
            eps = (-(kappa * dt / (3.0 * tau_p)) * (-dP)
                   + torch.sqrt(2.0 * kT * kappa * dt / (3.0 * vol * tau_p))
                   * baro_noise)
        else:
            p_int = (2.0 * ke / 3.0 + torch.sum(state.virial) / 3.0) / vol
            eps = (-(kappa * dt / tau_p) * (pressure - p_int)
                   + torch.sqrt(2.0 * kT * kappa * dt / (vol * tau_p))
                   * baro_noise) / 3.0
        scale = torch.exp(eps)
        new_box = state.box.rescaled(scale)
        x, shift = wrap(x * scale, new_box)
        new = force_apply(state.replace(pos=x, image=state.image + shift,
                                        box=new_box))
        return new.replace(vel=v / scale + 0.5 * dt * new.force / mass)

    return step
