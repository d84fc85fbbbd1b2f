"""Force-field composition on the particle-order state (counterpart of
``metadyn_tpu/core/forcefield.py``; HOOMD's net-force pass).

A ``ForceField`` names its terms: an all-pairs pair potential, harmonic or
FENE bonds, and an ``external(pos, state, system)`` energy whose force is
``−∇`` by ``torch.autograd.grad`` (the reference's ``jax.value_and_grad``).
``bind`` closes it over a ``System`` on its device; the metadynamics bias
force is added by the sampler on top.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .state import State, System, checked_device
from ..ops import bonds as bond_ops
from ..ops.pairs import (
    PairForceResult, PairKernel, PairParams, all_pairs_force,
)

ForceFn = Callable[[State], PairForceResult]


def external_force(external: Callable, state: State, system: System):
    """(energy, force) of ``external(pos, state, system)`` at ``state.pos``,
    the force −∂E/∂pos by autograd."""
    pos = state.pos.detach().requires_grad_(True)
    with torch.enable_grad():
        e = external(pos, state, system)
    (g,) = torch.autograd.grad(e, pos)
    return e.detach(), -g


@dataclass(frozen=True)
class ForceField:
    """Declarative force-field spec on ``device`` (default CUDA: raises
    when torch finds no CUDA device)."""

    pair_params: Optional[PairParams] = None
    pair_kernel: Optional[PairKernel] = None
    harmonic: Optional[bond_ops.HarmonicBondParams] = None
    fene: Optional[bond_ops.FENEBondParams] = None
    external: Optional[Callable] = None
    row_block: int = 1024
    device: str = "cuda"

    def bind(self, system: System) -> Callable[[State], State]:
        """Apply-style closure: evaluates every term and writes the force,
        energy and virial into the state."""
        raw = self.bind_raw(system)

        def force_apply(state: State) -> State:
            res = raw(state)
            return state.replace(force=res.force, potential_energy=res.energy,
                                 virial=res.virial)

        return force_apply

    def bind_raw(self, system: System) -> ForceFn:
        device = checked_device(self.device, "ForceField")
        if system.types.device != device:
            raise ValueError(f"ForceField on {device}, system on "
                             f"{system.types.device}")

        def force_fn(state: State) -> PairForceResult:
            e = state.pos.new_zeros(())
            f = torch.zeros_like(state.pos)
            w = torch.zeros_like(state.virial)
            if self.pair_params is not None:
                r = all_pairs_force(state.pos, system.types, state.box,
                                    self.pair_kernel, self.pair_params,
                                    self.row_block)
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.harmonic is not None:
                r = bond_ops.harmonic_bond_force(
                    state.pos, system.bonds, system.bond_types, state.box,
                    self.harmonic)
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.fene is not None:
                r = bond_ops.fene_bond_force(
                    state.pos, system.bonds, system.bond_types, state.box,
                    self.fene)
                e, f, w = e + r.energy, f + r.force, w + r.virial
            if self.external is not None:
                e_ext, f_ext = external_force(self.external, state, system)
                e, f = e + e_ext, f + f_ext
            return PairForceResult(e, f, w)

        return force_fn
