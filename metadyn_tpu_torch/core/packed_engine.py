"""PackedEngine — the MD engine over the slot-layout state (counterpart of
``metadyn_tpu/core/packed_engine.py``).

On a CUDA device every pair-force call goes to the hand-written kernel
(``ops/packed_cuda.py``); on the CPU to the plain roll sweep.  There is no
fallback between the two.  That holds for the soft push-off pair
(``pair_kind="soft"``) too: the reference has no Pallas kernel for it and
routes it to its XLA roll sweep on every backend, while this engine sends
it to the pair kernel's soft layout on CUDA (a layout of the port alone)
and to the plain sweep on the CPU.

The engine also steps a walker batch (``core/batch.py``: W states stacked
on a leading dimension, each with a box of its own), as ``parallel/
walkers.WalkerSampler`` drives it: one kernel launch per force call for
all W walkers, the repack check one device-to-host read per rebuild block
for all of them, and the run-health flags and metrics per walker.

With ``nbr_table=(r_nb, K)`` the engine keeps the slot neighbour table of
the order CVs (``ops/neighbor_table.py``), built at init and rebuilt at
every repack, in ``PackedAux.nbr``; the sampler's order-CV path reads it
(``cv/packed_order.make_table_order_force``).

The box may move (the NPT barostat rescales it on the device): the kernels
read the cell matrix from device memory, and the check that the fixed
cell grid still covers ``r_list`` (``cell_width_violation``) rides in the
repack check's read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .batch import batch_size, stack_walkers, walker, walkers
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

    overflow: torch.Tensor  # () bool: capacity overflow, a lost particle
    #                         or a full neighbour table
    stale: torch.Tensor     # () bool: half-skin violation
    # (W,) each for a walker batch
    nbr: Optional[torch.Tensor] = None  # (K, Npad) i32 slot neighbour table

    @classmethod
    def create(cls, device, lead: tuple = ()) -> "PackedAux":
        f = torch.zeros(lead, dtype=torch.bool, device=device)
        return cls(overflow=f, stale=f)


class PackedEngine:
    """Pair forces on the packed cell layout, with a distance-triggered
    incremental repack checked every ``rebuild_every`` steps.

    The check is a host ``if`` on :func:`needs_repack`: one device-to-host
    read per rebuild block (the reference branches on the device with
    ``lax.cond``); for a walker batch one read of the (W,) flags, and only
    the walkers that need it repack."""

    walker_batch = True

    def __init__(self, spec: PackedSpec, device, rebuild_every: int = 1,
                 mass: float = 1.0, with_energy: bool = False,
                 nbr_table=None, always_repack: bool = False):
        """``with_energy=True`` makes every force call accumulate the
        energy and virial (default: only the stride-end refresh does).
        ``always_repack=True`` repacks at every rebuild boundary (a test
        hook that makes repack timing deterministic).  ``nbr_table=(r_nb,
        K)`` keeps the slot neighbour table (K a multiple of 8, as the
        reference asks; r_nb within the smallest cell width, checked at
        init; orthorhombic boxes, one walker at a time)."""
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
            nbr_table = (float(nbr_table[0]), int(nbr_table[1]))
            if nbr_table[1] % 8:
                raise ValueError("nbr_table: K should be sublane-aligned "
                                 "(multiple of 8)")
        self.nbr_table = nbr_table
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
        w = batch_size(state)
        aux = PackedAux.create(self.device, () if w is None else (w,))
        if self.nbr_table is not None:
            if w is not None:
                raise ValueError("nbr_table: the slot neighbour table takes "
                                 "one walker at a time")
            self._check_table_box(state)
            tbl, ovf = self._build_table(state)
            aux = PackedAux(overflow=ovf, stale=aux.stale, nbr=tbl)
        return self.force_into(state, aux), aux

    def _check_table_box(self, state: PackedState) -> None:
        """The reference's checks of the table: an orthorhombic box, and
        r_nb within the smallest cell width (the 27-cell stencil holds
        every pair within r_nb); one host read of L at init."""
        if state.box.tilt is not None:
            raise ValueError("the slot neighbor table uses orthorhombic "
                             "minimum image; triclinic runs stay on the "
                             "cell-sweep path")
        r_nb = self.nbr_table[0]
        L = state.box.L.detach().cpu().numpy().astype(np.float64)
        min_width = min(float(l) / c
                        for l, c in zip(L, self.spec.cells_per_dim))
        if r_nb > min_width + 1e-6:
            raise ValueError(f"nbr_table radius {r_nb} exceeds the stencil "
                             f"guarantee (min cell width {min_width:.3f})")

    def _build_table(self, state: PackedState):
        from ..ops.neighbor_table import build_slot_neighbor_table
        r_nb, K = self.nbr_table
        return build_slot_neighbor_table(state, self.spec, r_nb, K)

    def rebuild(self, state: PackedState, aux: PackedAux):
        # forces travel with the slots, so a migration needs no new force
        if batch_size(state) is not None:
            return self._rebuild_walkers(state, aux)
        if self.always_repack or self._repack_flags(state):
            state, bad = self._repack_one(state)
            aux = dataclasses.replace(aux, overflow=aux.overflow | bad)
            if self.nbr_table is not None:
                # the slots moved, so the table's indices are void: rebuild
                # it (r_nb ≥ cut-off + skin keeps it complete until the
                # next half-skin trigger)
                tbl, ovf = self._build_table(state)
                aux = dataclasses.replace(aux, overflow=aux.overflow | ovf,
                                          nbr=tbl)
        return state, aux

    def cell_width_violation(self, state: PackedState) -> torch.Tensor:
        """Device bool ((W,) for a batch): a cell narrower than ``r_list``.
        The cell count per axis is fixed while the width follows the box,
        and a cell narrower than r_cut + skin silently misses pairs.  A
        tilted cell's width is its perpendicular width over the count."""
        w = perpendicular_widths(state.box)
        # the counts as Python numbers: no host-to-device copy, which would
        # wait for the device, in the repack check's path
        width = torch.stack([w[..., d] / float(c) for d, c in
                             enumerate(self.spec.cells_per_dim)], dim=-1)
        return torch.amin(width, dim=-1) < self.spec.r_list

    def _repack_flags(self, state: PackedState):
        """The repack check's one device-to-host read per rebuild block:
        the half-skin flags ((W,) for a batch) as host bools.  On a box
        that a step moved, the cell-width flag rides in the same read, and
        a violation raises: the fixed grid no longer covers r_list."""
        need = needs_repack(state, self.spec)
        if state.box.fixed:
            return need.tolist()
        need, narrow = torch.stack(
            [need, self.cell_width_violation(state)]).tolist()
        if np.any(narrow):
            raise RuntimeError(
                "PackedEngine: the box shrank below the cell grid's "
                f"r_list = {self.spec.r_list} per cell (cell_width_violation"
                "); build the grid with fewer cells or a smaller skin")
        return need

    def _rebuild_walkers(self, state: PackedState, aux: PackedAux):
        """The batch's rebuild: one read of the (W,) repack flags, then the
        repack (``repack_incremental``) of each walker that needs it,
        alone."""
        w_all = batch_size(state)
        todo = (range(w_all) if self.always_repack else
                [w for w, need in enumerate(self._repack_flags(state))
                 if need])
        if not todo:
            return state, aux
        parts = walkers(state)
        bad = torch.zeros(w_all, dtype=torch.bool, device=self.device)
        for w in todo:
            parts[w], bad_w = self._repack_one(walker(state, w))
            bad[w] = bad_w
        return stack_walkers(parts), dataclasses.replace(
            aux, overflow=aux.overflow | bad)

    def _repack_one(self, state: PackedState):
        return repack_incremental(state, self.spec)

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
        narrow = self.cell_width_violation(state)
        return {
            "temperature": packed_temperature(state, self.spec, self.mass),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
            "cell_width_violation": narrow.expand(aux.overflow.shape),
        }
