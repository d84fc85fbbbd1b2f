"""Simple CVs (counterpart of ``metadyn_tpu/cv/simple.py``): the
coordinate of one particle, the one-particle metadynamics oracle's CV, and
the energy CVs of the well-tempered ensemble.

``EnergyCV`` makes any potential-energy function a CV (the reference's
``CollectiveWrapper``): its bias force comes from the sampler's autograd
path, bias · F_wrapped.  ``PotentialEnergyCV`` is the total potential
energy of the engine's own force pass (``WellTemperedEnsemble``), biased
through the analytic force dU/dr = −F.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..core.state import State, System


@dataclass(frozen=True)
class AxisPosition:
    """s = the unwrapped coordinate ``axis`` of particle ``particle``."""

    particle: int = 0
    axis: int = 0
    name: str = "x"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> torch.Tensor:
        # unwrapped, so the CV is smooth across the periodic boundary
        p, a = self.particle, self.axis
        return (state.pos[p, a]
                + state.image[p, a].to(state.pos.dtype) * state.box.L[a])


@dataclass(frozen=True)
class EnergyCV:
    """s = U(state) for any energy function ``energy_fn(pos, state,
    system) -> ()``, differentiable in ``pos``: the sampler's autograd
    through it gives the bias force dV/ds · F_wrapped."""

    energy_fn: Callable
    name: str = "energy"

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state: State, system: System) -> torch.Tensor:
        return self.energy_fn(state.pos, state, system)


@dataclass(frozen=True)
class PotentialEnergyCV:
    """s = the total potential energy of the engine's last force pass, the
    well-tempered-ensemble CV, on any engine and on a walker batch.

    It reads ``state.potential_energy`` and adds the analytic bias force
    ``dVds · F`` (dU/dr = −F) with the state's force (``f`` on the packed
    state, ``force`` on the particle-order one), so it needs no autograd.
    The engine must compute the energy on every force call
    (``PackedEngine(with_energy=True)``; the particle-order engines always
    do), and every CV beside it must have ``accum_bias_force``, since the
    stored energy is not differentiable in the positions.

    Within a step the integrator hands the force call the new positions
    with the last call's force and energy, so s is U at the previous force
    call's positions and the bias force dVds · (F_pair + g) of that call,
    as in the reference."""

    name: str = "U"

    # the sampler's check: this CV reads the energy between stride ends
    needs_live_energy = True
    # the packed engine's walker batch gives (W,) energies: values (W,)
    walker_batch = True

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state, system: System) -> torch.Tensor:
        return state.potential_energy

    def accum_bias_force(self, state, system: System, dVds: torch.Tensor,
                         f_acc: torch.Tensor) -> torch.Tensor:
        f = state.f if hasattr(state, "f") else state.force
        # (W,) coefficients of a walker batch broadcast over its rows
        lead = dVds.dim()
        return f_acc + dVds.reshape(dVds.shape + (1,) * (f.dim() - lead)) * f
