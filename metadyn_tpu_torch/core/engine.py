"""Particle-order force engines (counterpart of
``metadyn_tpu/core/engine.py``; HOOMD's ``ForceCompute`` and
``NeighborList``).

Every engine keeps the engine protocol the sampler drives (the packed
engine's too):

- ``init(state) -> (state, aux)``: build the aux, compute the forces;
- ``rebuild(state, aux) -> (state, aux)``: refresh neighbour structures;
- ``force_into(state, aux, extra_force=None) -> state``: forces (plus an
  additive bias force), energy and virial into the state;
- ``positions(state)`` / ``with_positions(state, r)``: the position leaf
  the CVs' autograd chain rule differentiates;
- ``refresh_energy(state, aux)``: the stride-end energy (these engines
  always carry it);
- ``metrics(state, aux)``: temperature, energy, the run-health flags.

``NeighborEngine`` rebuilds its list every ``rebuild_every`` steps; a
half-skin violation found at a rebuild (some steps of the block ran with a
stale list) and any capacity overflow set sticky flags that the stride
metrics report.  Each engine lives on ``device`` (default CUDA: it raises
when torch finds no CUDA device; the tests pass the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .forcefield import external_force
from .state import State, System, checked_device, temperature
from ..ops import bonds as bond_ops
from ..ops.cell_list import (
    CellSpec, NeighborList, build_neighbor_list, needs_rebuild,
)
from ..ops.neighbor_force import neighbor_pair_force
from ..ops.pairs import (
    PairForceResult, PairKernel, PairParams, all_pairs_force,
)


@dataclass(frozen=True)
class EngineAux:
    """An engine's carry: the neighbour list (None for all-pairs) and the
    sticky run-health flags."""

    overflow: torch.Tensor  # () bool
    stale: torch.Tensor     # () bool
    nbr: Optional[NeighborList] = None

    @classmethod
    def create(cls, device, nbr: Optional[NeighborList] = None
               ) -> "EngineAux":
        f = torch.zeros((), dtype=torch.bool, device=device)
        return cls(overflow=f if nbr is None else nbr.overflow, stale=f,
                   nbr=nbr)


def _add(a: PairForceResult, b: PairForceResult) -> PairForceResult:
    return PairForceResult(a.energy + b.energy, a.force + b.force,
                           a.virial + b.virial)


class ForceEngine:
    """Base of the particle-order engines: bonds, the external potential and
    the protocol."""

    rebuild_every: int = 10 ** 9  # all-pairs: never

    def __init__(self, system: System, harmonic=None, fene=None,
                 external=None, device="cuda"):
        self.device = checked_device(device, type(self).__name__)
        if system.types.device != self.device:
            raise ValueError(f"{type(self).__name__} on {self.device}, "
                             f"system on {system.types.device}")
        self.system = system
        self.harmonic = harmonic
        self.fene = fene
        self.external = external

    # --- protocol ---------------------------------------------------------
    def init(self, state: State):
        aux = self._make_aux(state)
        return self.force_into(state, aux), aux

    def rebuild(self, state: State, aux: EngineAux):
        return state, aux

    def force_into(self, state: State, aux: EngineAux,
                   extra_force: Optional[torch.Tensor] = None) -> State:
        res = self._net_force(state, aux)
        f = res.force if extra_force is None else res.force + extra_force
        return state.replace(force=f, potential_energy=res.energy,
                             virial=res.virial)

    def positions(self, state: State) -> torch.Tensor:
        return state.pos

    def with_positions(self, state: State, r: torch.Tensor) -> State:
        return state.replace(pos=r)

    def refresh_energy(self, state: State, aux) -> State:
        return state

    def metrics(self, state: State, aux: EngineAux) -> dict:
        return {
            "temperature": temperature(state, self.system),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
        }

    # --- internals --------------------------------------------------------
    def _make_aux(self, state: State) -> EngineAux:
        return EngineAux.create(self.device)

    def _common(self, state: State) -> PairForceResult:
        res = PairForceResult(state.pos.new_zeros(()),
                              torch.zeros_like(state.pos),
                              torch.zeros_like(state.virial))
        sys = self.system
        if self.harmonic is not None:
            res = _add(res, bond_ops.harmonic_bond_force(
                state.pos, sys.bonds, sys.bond_types, state.box,
                self.harmonic))
        if self.fene is not None:
            res = _add(res, bond_ops.fene_bond_force(
                state.pos, sys.bonds, sys.bond_types, state.box, self.fene))
        if self.external is not None:
            e_ext, f_ext = external_force(self.external, state, sys)
            res = PairForceResult(res.energy + e_ext, res.force + f_ext,
                                  res.virial)
        return res

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        return self._common(state)


class AllPairsEngine(ForceEngine):
    """The O(N²) engine in row blocks: small systems, and the oracle of the
    neighbour list."""

    def __init__(self, system: System,
                 pair_params: Optional[PairParams] = None,
                 pair_kernel: Optional[PairKernel] = None,
                 row_block: int = 1024, harmonic=None, fene=None,
                 external=None, device="cuda"):
        super().__init__(system, harmonic, fene, external, device)
        self.pair_params = pair_params
        self.pair_kernel = pair_kernel
        self.row_block = row_block

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        res = self._common(state)
        if self.pair_params is not None:
            res = _add(res, all_pairs_force(
                state.pos, self.system.types, state.box, self.pair_kernel,
                self.pair_params, self.row_block))
        return res


class NeighborEngine(ForceEngine):
    """Pair forces over a cell-built neighbour list, rebuilt every
    ``rebuild_every`` steps (orthorhombic boxes)."""

    def __init__(self, system: System, cell_spec: CellSpec,
                 pair_params: PairParams, pair_kernel: PairKernel,
                 rebuild_every: int = 10,
                 exclusions: Optional[torch.Tensor] = None,
                 harmonic=None, fene=None, external=None, device="cuda"):
        super().__init__(system, harmonic, fene, external, device)
        self.cell_spec = cell_spec
        self.pair_params = pair_params
        self.pair_kernel = pair_kernel
        self.rebuild_every = rebuild_every
        self.exclusions = exclusions

    def _make_aux(self, state: State) -> EngineAux:
        return EngineAux.create(self.device, build_neighbor_list(
            state.pos, state.box, self.cell_spec, self.exclusions))

    def rebuild(self, state: State, aux: EngineAux):
        # a half-skin violation found now means some steps of the block
        # that ends here ran with a stale list
        stale = aux.stale | needs_rebuild(aux.nbr, state.pos, state.box)
        nbr = build_neighbor_list(state.pos, state.box, self.cell_spec,
                                  self.exclusions)
        return state, EngineAux(overflow=aux.overflow | nbr.overflow,
                                stale=stale, nbr=nbr)

    def _net_force(self, state: State, aux: EngineAux) -> PairForceResult:
        return _add(self._common(state), neighbor_pair_force(
            state.pos, self.system.types, state.box, aux.nbr,
            self.pair_kernel, self.pair_params))


def run_md_blocks(engine, step_factory: Callable, state, aux,
                  generator: Optional[torch.Generator], n_steps: int):
    """``n_steps`` steps in blocks of ``rebuild_every``, rebuilding at each
    block's head."""
    r = min(engine.rebuild_every, n_steps)
    n_blocks, rem = divmod(n_steps, r)
    if rem:
        raise ValueError(f"n_steps={n_steps} must be a multiple of "
                         f"rebuild_every={r}")
    for _ in range(n_blocks):
        state, aux = engine.rebuild(state, aux)
        step = step_factory(lambda st, aux=aux: engine.force_into(st, aux))
        for _ in range(r):
            state = step(state, generator)
    return state, aux
