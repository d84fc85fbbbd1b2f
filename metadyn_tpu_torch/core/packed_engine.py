"""PackedEngine — the MD engine over the slot-layout state (counterpart of
``metadyn_tpu/core/packed_engine.py``).

On a CUDA device every pair-force call goes to the hand-written kernel
(``ops/packed_cuda.py``); on the CPU to the plain roll sweep.  There is no
fallback between the two.  That holds for the soft push-off pair
(``pair_kind="soft"``) too: the reference has no Pallas kernel for it and
routes it to its XLA roll sweep on every backend, while this engine sends
it to the pair kernel's soft layout on CUDA (a layout of the port alone)
and to the plain sweep on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .box import Box, perpendicular_widths
from ..ops.packed import (
    PackedSpec, PackedState, needs_repack, pack_host, packed_temperature,
    repack_incremental,
)
from ..ops.packed_cuda import check_spec, packed_lj_force_cuda


@dataclass(frozen=True)
class PackedAux:
    """Run-health flags, OR-accumulated on the device and read with the
    stride metrics."""

    overflow: torch.Tensor  # () bool: capacity overflow or a lost particle
    stale: torch.Tensor     # () bool: half-skin violation

    @classmethod
    def create(cls, device) -> "PackedAux":
        f = torch.zeros((), dtype=torch.bool, device=device)
        return cls(overflow=f, stale=f)


class PackedEngine:
    """Pair forces on the packed cell layout, with a distance-triggered
    incremental repack checked every ``rebuild_every`` steps.

    The check is a host ``if`` on :func:`needs_repack`: one device-to-host
    read per rebuild block (the reference branches on the device with
    ``lax.cond``)."""

    def __init__(self, spec: PackedSpec, device, rebuild_every: int = 1,
                 mass: float = 1.0, with_energy: bool = False,
                 nbr_table=None, always_repack: bool = False):
        """``with_energy=True`` makes every force call accumulate the
        energy and virial (default: only the stride-end refresh does).
        ``always_repack=True`` repacks at every rebuild boundary (a test
        hook that makes repack timing deterministic)."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("PackedEngine: a CUDA device was asked "
                                   "for, but torch finds no CUDA device")
            check_spec(spec)
            # the reference runs f32 at full precision: no TF32 products
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif self.device.type != "cpu":
            raise ValueError(f"PackedEngine: unsupported device {self.device}")
        if nbr_table is not None:
            raise NotImplementedError("PackedEngine: the slot neighbour table "
                                      "(nbr_table) is not ported yet")
        self.spec = spec
        self.rebuild_every = rebuild_every
        self.mass = mass
        self.with_energy = with_energy
        self.always_repack = always_repack
        # live per-step energy/virial: only with with_energy, on both
        # devices (the forces-only mode leaves them at the last refresh)
        self.energy_live = self.virial_live = bool(with_energy)

    # --- construction -----------------------------------------------------
    def pack_state(self, pos, box: Box, types, eps_i, sigma_i, vel=None,
                   image=None, extra_attrs=None):
        """Initial pack on the host (``ops.packed.pack_host``).  Returns
        (state, overflow)."""
        return pack_host(pos, box, self.spec, types, eps_i, sigma_i,
                         self.device, vel=vel, image=image,
                         extra_attrs=extra_attrs)

    # --- protocol ---------------------------------------------------------
    def _pair_force(self, state: PackedState,
                    with_energy: bool) -> PackedState:
        return packed_lj_force_cuda(state, self.spec, with_energy=with_energy)

    def init(self, state: PackedState):
        aux = PackedAux.create(self.device)
        return self.force_into(state, aux), aux

    def rebuild(self, state: PackedState, aux: PackedAux):
        # forces travel with the slots, so a migration needs no new force
        if self.always_repack or bool(needs_repack(state, self.spec)):
            state, bad = repack_incremental(state, self.spec)
            aux = PackedAux(overflow=aux.overflow | bad, stale=aux.stale)
        return state, aux

    def force_into(self, state: PackedState, aux: PackedAux,
                   extra_force=None) -> PackedState:
        state = self._pair_force(state, self.with_energy)
        if extra_force is not None:
            state = state.replace(f=state.f + extra_force)
        return state

    def positions(self, state: PackedState) -> torch.Tensor:
        return state.r

    def with_positions(self, state: PackedState, r) -> PackedState:
        return state.replace(r=r)

    def refresh_energy(self, state: PackedState, aux) -> PackedState:
        """Recompute forces with energy and virial (stride-end metrics)."""
        return self._pair_force(state, True)

    def metrics(self, state: PackedState, aux: PackedAux) -> dict:
        # the cell count per axis is fixed while the width follows the box:
        # a cell narrower than r_cut + skin silently misses pairs.  A tilted
        # cell's width is its perpendicular width over the count.
        cpd = torch.as_tensor(np.asarray(self.spec.cells_per_dim, np.float32),
                              device=state.box.L.device)
        width = perpendicular_widths(state.box) / cpd
        return {
            "temperature": packed_temperature(state, self.spec, self.mass),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
            "cell_width_violation": torch.min(width) < self.spec.r_list,
        }
