"""Particle state and static attributes (counterpart of
``metadyn_tpu/core/state.py``; HOOMD's ``ParticleData`` and
``SystemDefinition``).

``State`` is the particle-order state of the all-pairs and neighbour-list
engines: (N, 3) f32 positions, velocities and forces, int32 image counters,
the box, the potential energy, the diagonal virial and the Nosé–Hoover
variable.  The packed engine keeps its state in ``ops.packed.PackedState``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .box import Box, wrap


def checked_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``: CUDA (with its index) or the CPU.
    Raise when CUDA is asked for and torch finds none (no fallback to the
    CPU); on CUDA, keep TF32 off, as the reference runs f32 at full
    precision."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: a CUDA device was asked for, but "
                               "torch finds no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if device.index is None:
            # "cuda" names the current card: compare as "cuda:<index>"
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{who}: unsupported device {device}")
    return device


@dataclass(frozen=True)
class State:
    """Dynamic per-particle state carried through the MD loop; the forces
    at the current positions ride along, so a velocity-Verlet step makes
    one force call."""

    pos: torch.Tensor               # (N, 3) f32, wrapped into the box
    vel: torch.Tensor               # (N, 3) f32
    force: torch.Tensor             # (N, 3) f32
    image: torch.Tensor             # (N, 3) i32 lattice-vector counters
    box: Box
    potential_energy: torch.Tensor  # () f32
    virial: torch.Tensor            # (3,) f32 diagonal Σ_{i<j} f_ij,d r_ij,d
    xi: torch.Tensor                # () f32 Nosé–Hoover variable

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class System:
    """Per-run constant particle attributes and topology."""

    types: torch.Tensor       # (N,) i32
    mass: torch.Tensor        # (N,) f32
    charge: torch.Tensor      # (N,) f32
    bonds: torch.Tensor       # (B, 2) i32 — empty (0, 2) if none
    bond_types: torch.Tensor  # (B,) i32
    n_types: int = 1

    @property
    def n(self) -> int:
        return self.types.shape[0]


def make_system(
    n: int,
    device,
    types: Optional[np.ndarray] = None,
    mass: Optional[np.ndarray] = None,
    charge: Optional[np.ndarray] = None,
    bonds: Optional[np.ndarray] = None,
    bond_types: Optional[np.ndarray] = None,
    n_types: Optional[int] = None,
) -> System:
    types = (np.zeros(n, np.int32) if types is None
             else np.asarray(types, np.int32))
    mass = (np.ones(n, np.float32) if mass is None
            else np.asarray(mass, np.float32))
    charge = (np.zeros(n, np.float32) if charge is None
              else np.asarray(charge, np.float32))
    bonds = (np.zeros((0, 2), np.int32) if bonds is None
             else np.asarray(bonds, np.int32))
    bond_types = (np.zeros(bonds.shape[0], np.int32) if bond_types is None
                  else np.asarray(bond_types, np.int32))
    if n_types is None:
        n_types = int(types.max()) + 1 if n else 1

    def t(a):
        return torch.as_tensor(a, device=device)

    return System(types=t(types), mass=t(mass), charge=t(charge),
                  bonds=t(bonds), bond_types=t(bond_types), n_types=n_types)


def make_state(pos: np.ndarray, box: Box, vel: Optional[np.ndarray] = None,
               device="cuda") -> State:
    """An initial ``State`` on ``device`` (the box's device): positions
    wrapped, images from the wrap, zero forces and energy."""
    device = checked_device(device, "make_state")
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    n = pos.shape[0]
    wrapped, shift = wrap(pos, box)
    vel = (torch.zeros((n, 3), dtype=torch.float32, device=device)
           if vel is None else
           torch.as_tensor(np.asarray(vel, np.float32), device=device))
    z = torch.zeros((), dtype=torch.float32, device=device)
    return State(pos=wrapped, vel=vel, force=torch.zeros_like(wrapped),
                 image=shift, box=box, potential_energy=z,
                 virial=torch.zeros(3, dtype=torch.float32, device=device),
                 xi=z)


def thermal_velocities(generator: torch.Generator, mass: torch.Tensor,
                       kT: float) -> torch.Tensor:
    """Maxwell–Boltzmann velocities with zero total momentum, drawn from
    ``generator`` (on ``mass``'s device)."""
    n = mass.shape[0]
    v = (torch.randn((n, 3), generator=generator, dtype=torch.float32,
                     device=mass.device)
         * torch.sqrt(kT / mass)[:, None])
    p = torch.sum(v * mass[:, None], dim=0) / torch.sum(mass)
    return v - p[None, :]


def kinetic_energy(state: State, system: System) -> torch.Tensor:
    return 0.5 * torch.sum(system.mass[:, None] * state.vel ** 2)


def pressure(state: State, system: System) -> torch.Tensor:
    """Instantaneous pressure: PV = N·kT_inst + W/3 (W = Σ_d W_d)."""
    ke = kinetic_energy(state, system)
    return (2.0 * ke / 3.0 + torch.sum(state.virial) / 3.0) / state.box.volume


def pressure_tensor(state: State, system: System) -> torch.Tensor:
    """Diagonal pressure tensor (3,): P_d·V = Σ_i m v_d² + W_d."""
    ke2_d = torch.sum(system.mass[:, None] * state.vel ** 2, dim=0)
    return (ke2_d + state.virial) / state.box.volume


def temperature(state: State, system: System) -> torch.Tensor:
    """Instantaneous kinetic temperature over 3N − 3 degrees of freedom,
    floored at 3 so that a system of one particle stays finite."""
    dof = max(3 * state.n - 3, 3)
    return 2.0 * kinetic_energy(state, system) / dof
