"""Integrators for the packed (slot-layout) state — (3, Npad) math
(counterpart of ``metadyn_tpu/integrate/packed.py``).

A step is ``step(state, generator=None, noise=None)``: the Langevin step
draws its noise from ``generator`` (a ``torch.Generator`` on the state's
device), or takes it as a (3, Npad) tensor, as the tests do to feed both
packages the same numbers.  Uniform particle mass.

The packed integrators do not wrap per step: a wrap would move a
coordinate by ±L while its slot's cell still implies the old side.
Positions drift continuously and the repack wraps them.

:func:`make_packed_npt_scr_step` adds the stochastic-cell-rescaling
barostat: its box moves on the device, step by step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops.packed import VACANT_THR, VACANT_X, PackedSpec, PackedState

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


def make_packed_npt_scr_step(
    force_fn: Callable[[PackedState], PackedState],
    spec: PackedSpec,
    dt: float, kT: float, pressure: float,
    gamma: float = 1.0, tau_p: float = 2.0,
    anisotropic: bool = False,
    box_bias_fn=None,
    kappa: float = 0.1, mass: float = 1.0,
    engine=None,
) -> PackedStepFn:
    """BAOAB Langevin plus the stochastic-cell-rescaling barostat
    (Bernetti & Bussi, J. Chem. Phys. 153, 114107 (2020)) on the packed
    state: the reference's ``make_packed_npt_scr_step``.

    ``step(state, generator=None, noise=None, baro_noise=None)``: the
    particles' (…, 3, Npad) normal draw and the barostat's (isotropic: one
    per box, anisotropic: three) come from ``generator`` or are given, as
    the tests give both packages the reference's draws.  A walker batch
    steps every walker's box on its own.

    The barostat reads the state's diagonal virial every step, so the
    engine must compute it on every force call (``with_energy=True``;
    pass ``engine`` for the check).  The box is rescaled on the device
    (``Box.rescaled``): it carries no host floats, and every kernel reads
    the new cell matrix from device memory.  The slots' cell assignment is
    fractional, so positions and box scale together and no slot changes
    cell; ``ref_r`` scales with them, keeping the half-skin trigger a pure
    drift measure.  The cell count per axis stays fixed while the width
    follows the box: the engine's repack check flags (and refuses) a cell
    narrower than ``r_list`` (``cell_width_violation``), so build the grid
    with headroom for the compression expected.

    ``box_bias_fn(state) -> ∂V/∂L`` (anisotropic only) couples the
    metadynamics bias of a box CV to the box (``cv/aspect_ratio.py``)."""
    if engine is not None and not getattr(engine, "virial_live", True):
        raise AssertionError(
            "make_packed_npt_scr_step: this engine's inner force path skips "
            "the energy/virial accumulation, so the barostat would read a "
            "stale virial every step. Construct the engine with "
            "with_energy=True.")
    c1 = math.exp(-gamma * dt)
    c2 = math.sqrt((1.0 - c1 * c1) * kT / mass)
    h = 0.5 * dt / mass

    def step(state: PackedState, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             baro_noise: Optional[torch.Tensor] = None):
        if state.box.tilt is not None:
            raise ValueError(
                "packed NPT/SCR takes orthorhombic boxes: the per-axis "
                "rescale does not commute with tilt factors")
        lead = state.box.L.shape[:-1]
        valid = (state.pid < spec.n_real).to(torch.float32)[..., None, :]
        # --- BAOAB on the particles ---
        v = state.v + h * state.f
        r = state.r + 0.5 * dt * v
        if noise is None:
            noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                device=v.device)
        v = c1 * v + c2 * noise
        r = r + 0.5 * dt * v
        if baro_noise is None:
            baro_noise = torch.randn((*lead, 3) if anisotropic else lead,
                                     generator=generator, dtype=v.dtype,
                                     device=v.device)
        # --- the barostat: stochastic cell rescaling ---
        ke2_d = mass * torch.sum(v * v * valid, dim=-1)    # (…, 3) Σ m v_d²
        vol = state.box.volume
        L = state.box.L
        if anisotropic:
            dP = (ke2_d + state.virial) / vol[..., None] - pressure
            if box_bias_fn is not None:
                dVdL = box_bias_fn(state.replace(r=r))
                dP = dP - dVdL * L / vol[..., None]
            eps = (-(kappa * dt / (3.0 * tau_p)) * (-dP)
                   + torch.sqrt(2.0 * kT * kappa * dt
                                / (3.0 * vol * tau_p))[..., None]
                   * baro_noise)
            scale = torch.exp(eps)
        else:
            p_int = (torch.sum(ke2_d, dim=-1) / 3.0
                     + torch.sum(state.virial, dim=-1) / 3.0) / vol
            eps = (-(kappa * dt / tau_p) * (pressure - p_int)
                   + torch.sqrt(2.0 * kT * kappa * dt / (vol * tau_p))
                   * baro_noise) / 3.0
            scale = torch.exp(eps)[..., None].expand(*lead, 3)
        scale3 = scale[..., None]
        r = r * scale3
        v = v / scale3
        ref_r = state.ref_r * scale3
        if spec.uniform_eps is not None:
            # vacant slots stay at the exact coordinate sentinel (the
            # rescale would walk them across VACANT_THR)
            r = torch.where(valid > 0, r, VACANT_X)
            ref_r = torch.where(valid > 0, ref_r, VACANT_X)
        out = force_fn(state.replace(r=r, ref_r=ref_r,
                                     box=state.box.rescaled(scale)))
        return out.replace(v=v + h * out.f)

    return step
