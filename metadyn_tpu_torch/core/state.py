"""Static per-particle attributes (counterpart of ``metadyn_tpu/core/state.py``;
HOOMD's ``SystemDefinition``).  Only ``System`` and ``make_system`` are
ported: the packed engine keeps the dynamic state in ``ops.packed``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


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
