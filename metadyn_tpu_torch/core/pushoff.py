"""Soft push-off of a random-walk polymer melt, before the production pair
potential (WCA or LJ with FENE bonds blows up on the overlapping start).

Two push-offs, one per reference entry point, both on the pair kernel's soft
layout on CUDA (the plain roll sweep on the CPU):

- :func:`pushoff_pack` + :func:`pushoff_run`: ``examples/config5_flux_1m.py``
  's packed push-off: A = 100 through ``eps_i`` (A_ij = se_i·se_j), FENE
  bonds in the pair sweep (a bonded pair gets FENE + WCA with that ε
  instead of the soft term), r_cut 1, skin 1.
- :func:`prerelax_melt`: ``metadyn_tpu/cli.py``'s ``init.prerelax_steps``,
  which the reference runs on its particle-order all-pairs engine:
  ``soft_tables(1, A=100, r_cut=1)`` on every pair, bonded or not, plus
  FENE + WCA (ε = σ = 1) on the bonds.  Here the soft pair runs on the
  kernel without bonds, so it reaches bonded pairs too, and
  :class:`BondedPushoffEngine` adds the bond term by gathering each slot's
  partners (``bp*`` attrs); the same potential, on the packed engine.

Both integrate BAOAB Langevin at dt 0.002, γ 2, forces only, with a repack
check every 5 steps; both raise on a cell-capacity overflow.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .box import Box
from .packed_engine import PackedEngine
from ..integrate.packed import make_packed_langevin_step
from ..ops.packed import (
    PackedSpec, PackedState, _cart3, _fene_wca_pair, _frac3,
    bond_partner_attrs,
)

PUSHOFF_A = 100.0
PUSHOFF_RCUT = 1.0
PUSHOFF_DT = 0.002
PUSHOFF_GAMMA = 2.0
PUSHOFF_FENE_K = 30.0
PUSHOFF_FENE_R0 = 1.5
CHECK_EVERY = 5


def pushoff_spec(pos: np.ndarray, L: float, **bond_kw) -> PackedSpec:
    """The push-off's soft spec: r_cut 1, skin 1, floor(L/2) cells per side,
    the cap from the start's measured occupancy (×1.4 + 6)."""
    n = pos.shape[0]
    cpd = int(np.floor(L / 2.0))
    cell = np.floor((pos / L + 0.5) * cpd).astype(np.int64) % cpd
    occ0 = int(np.bincount((cell[:, 0] * cpd + cell[:, 1]) * cpd
                           + cell[:, 2]).max())
    return PackedSpec.create(L, n, r_cut=PUSHOFF_RCUT, skin=1.0,
                             cap=int(occ0 * 1.4) + 6, pair_kind="soft",
                             **bond_kw)


def pushoff_pack(pos, L: float, types, bond_attrs: dict, device):
    """The packed example's push-off start: soft pair with A = 100 through
    ``eps_i``, FENE bonds (k 30, r0 1.5) in the sweep, one bond slot per
    ``bp*`` attr of ``bond_attrs`` (``bond_partner_attrs``), rebuild every
    5 steps.  Returns (engine, state, spec)."""
    n = pos.shape[0]
    spec = pushoff_spec(pos, L, fene_k=PUSHOFF_FENE_K,
                        fene_r0=PUSHOFF_FENE_R0, bond_slots=len(bond_attrs))
    engine = PackedEngine(spec, device, rebuild_every=CHECK_EVERY)
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, device), types, np.full(n, PUSHOFF_A, np.float32),
        np.ones(n, np.float32), extra_attrs=bond_attrs)
    if overflow:
        raise RuntimeError("cell capacity overflow at the push-off pack")
    return engine, st, spec


def pushoff_run(engine, st, steps: int, seed: int = 99, kT: float = 1.0):
    """``steps`` push-off steps: Langevin dt 0.002, γ 2 (a generator on the
    engine's device seeded from ``seed``), forces only, a repack check
    every 5 steps.  Returns (state, aux)."""
    st, aux = engine.init(st)
    step = make_packed_langevin_step(lambda s_: engine.force_into(s_, None),
                                     dt=PUSHOFF_DT, kT=kT,
                                     gamma=PUSHOFF_GAMMA)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(seed)
    for done in range(0, steps, CHECK_EVERY):
        st, aux = engine.rebuild(st, aux)
        for _ in range(min(CHECK_EVERY, steps - done)):
            st = step(st, gen)
    return st, aux


def bond_gather_force(state: PackedState, bond_spec: PackedSpec,
                      with_energy: bool) -> tuple:
    """FENE + WCA (ε = σ = 1) of every slot's bonds, by gathering its
    partners through ``slot_of`` (partner pid + 1 in ``bp*``, 0 = none).
    Each bond is seen from both ends; each end takes its own force.
    Returns (force (3, Npad), energy, diagonal virial)."""
    f = torch.zeros_like(state.r)
    e = torch.zeros((), dtype=torch.float32, device=state.r.device)
    w = torch.zeros(3, dtype=torch.float32, device=state.r.device)
    one = torch.ones((), dtype=torch.float32, device=state.r.device)
    slot_of = state.slot_of.long()
    for k in range(bond_spec.bond_slots):
        p1 = state.attrs[f"bp{k}"]
        has = p1 > 0
        partner = slot_of[torch.clamp(p1.long() - 1, min=0)]
        d = state.r - state.r[:, partner]
        fd = _frac3(d, state.box)
        d = _cart3(fd - torch.round(fd), state.box)
        r2 = torch.sum(d * d, dim=0)
        e_b, coef = _fene_wca_pair(torch.where(has, r2, 1.0), one, one,
                                   bond_spec)
        coef = torch.where(has, coef, 0.0)
        cd = coef * d
        f = f + cd
        if with_energy:
            e = e + 0.5 * torch.sum(torch.where(has, e_b, 0.0))
            w = w + 0.5 * torch.sum(cd * d, dim=1)
    return f, e, w


class BondedPushoffEngine(PackedEngine):
    """The reference CLI's push-off potential on the packed engine: the
    spec's soft pair on every pair (the spec has no bonds, so bonded pairs
    get it too) plus :func:`bond_gather_force`'s FENE + WCA."""

    def __init__(self, spec: PackedSpec, device, fene_k: float,
                 fene_r0: float, **kw):
        if spec.has_bonds:
            raise ValueError("BondedPushoffEngine: the pair spec must have "
                             "no bonds (the bond term is gathered)")
        super().__init__(spec, device, **kw)
        self.bond_spec = dataclasses.replace(spec, fene_k=float(fene_k),
                                             fene_r0=float(fene_r0),
                                             bond_kind="fene")

    def _pair_force(self, state: PackedState, with_energy: bool):
        state = super()._pair_force(state, with_energy)
        f, e, w = bond_gather_force(state, self.bond_spec, with_energy)
        if not with_energy:
            return state.replace(f=state.f + f)
        return state.replace(f=state.f + f,
                             potential_energy=state.potential_energy + e,
                             virial=state.virial + w)


def prerelax_pack(pos: np.ndarray, bonds: np.ndarray, L: float, device,
                  fene_k: float, fene_r0: float):
    """The CLI push-off's start: type-blind soft pair (A = 100 through
    ``eps_i``), the bond partners as attrs.  Returns (engine, state)."""
    n = pos.shape[0]
    spec = pushoff_spec(pos, L)
    engine = BondedPushoffEngine(spec, device, fene_k, fene_r0,
                                 rebuild_every=CHECK_EVERY)
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, device), np.zeros(n, np.int32),
        np.full(n, PUSHOFF_A, np.float32), np.ones(n, np.float32),
        extra_attrs=bond_partner_attrs(bonds, n))
    if overflow:
        raise RuntimeError("cell capacity overflow at the push-off pack")
    return engine, st


def unwrapped_positions(state: PackedState) -> np.ndarray:
    """(N, 3) particle-order positions with the image counts added back."""
    slot = state.slot_of.long()
    r = state.r[:, slot] + _cart3(state.image[:, slot].to(torch.float32),
                                  state.box)
    return r.T.cpu().numpy()


def prerelax_melt(pos: np.ndarray, bonds: np.ndarray, L: float, device,
                  steps: int, kT: float, seed: int, fene_k: float,
                  fene_r0: float) -> np.ndarray:
    """The CLI's ``init.prerelax_steps``: ``steps`` push-off steps of
    :func:`prerelax_pack`'s engine at ``kT`` from a generator seeded with
    ``seed``.  Raises on a cell-capacity overflow.  Returns the unwrapped
    positions (N, 3), checked finite."""
    engine, st = prerelax_pack(pos, bonds, L, device, fene_k, fene_r0)
    st, aux = pushoff_run(engine, st, steps, seed=seed, kT=kT)
    if bool(aux.overflow):
        raise RuntimeError("cell capacity overflow during the push-off: "
                           "its forces are invalid")
    out = unwrapped_positions(st)
    if not np.isfinite(out).all():
        raise RuntimeError("the push-off blew up (non-finite positions)")
    return out
