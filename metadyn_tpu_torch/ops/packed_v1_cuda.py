"""Wrapper of the hand-written Hopper v1 pair-force kernel
(``csrc/packed_lj_force_v1.cu``), the counterpart of
``metadyn_tpu/ops/packed_pallas.packed_lj_force_pallas``: LJ over per-slot
``se``/``hs`` with optional FENE or harmonic bonds, in an orthorhombic or
a tilted box (the cell matrix read from device memory), always with
energy and virial.  Like the reference's v1 it
has no production caller: it is the cross-check of the production kernel
(``ops/packed_cuda.py``) in the per-slot and bonded layouts, written to a
different design.

On a CUDA tensor :func:`packed_lj_force_v1_cuda` launches the kernel or
raises; on a CPU tensor it runs the plain version,
``ops.packed.packed_lj_force``.  ``packed_lj_force_v1_cuda.launches`` counts
the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed import PackedSpec, PackedState, packed_lj_force
from .packed_cuda import BOND_KINDS, bond_ptrs, box_ptr, check_state, slot_ptr

KERNEL = "packed_lj_force_v1"


def check_spec_v1(spec: PackedSpec) -> None:
    """Raise on a spec the v1 kernel does not take: the soft pair, per-type
    tables (the reference's v1 refuses them too), a cap above 1024 (one
    thread per slot of a cell).  Any number of bond slots is taken."""
    if spec.pair_kind != "lj":
        raise NotImplementedError(f"CUDA v1 pair kernel: pair_kind "
                                  f"{spec.pair_kind!r} (only 'lj')")
    if spec.has_pair_table:
        raise NotImplementedError("CUDA v1 pair kernel: per-type pair tables "
                                  "run on the production kernel")
    if spec.cap > 1024:
        raise NotImplementedError("CUDA v1 pair kernel: cap above 1024")


def _function():
    fn = _build.load(KERNEL).packed_lj_force_v1
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def packed_lj_force_v1_cuda(state: PackedState,
                            spec: PackedSpec) -> PackedState:
    """Pair forces, potential energy and diagonal virial over ``se``/``hs``
    (the uniform σ/ε fields do not enter, as in the reference's v1)."""
    r = state.r
    if r.device.type == "cpu":
        return packed_lj_force(state, spec, with_energy=True)
    if r.device.type != "cuda":
        raise ValueError(f"packed_lj_force_v1_cuda: unsupported device "
                         f"{r.device}")
    who = "packed_lj_force_v1_cuda"
    check_spec_v1(spec)
    check_state(state, spec, who)
    fn = _function()
    se = slot_ptr(state.attrs["se"], torch.float32, spec, who, "se")
    hs = slot_ptr(state.attrs["hs"], torch.float32, spec, who, "hs")
    pid = (slot_ptr(state.pid, torch.int32, spec, who, "pid")
           if spec.has_bonds else None)
    f = torch.empty_like(r)
    partials = torch.empty((spec.n_cells, 4), dtype=torch.float32,
                           device=r.device)
    out = torch.empty(4, dtype=torch.float32, device=r.device)
    cx, cy, cz = spec.cells_per_dim
    bps, _keep = bond_ptrs(state, spec, who)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), se, hs, pid, *bps,
                 f.data_ptr(), partials.data_ptr(), out.data_ptr(),
                 spec.n_pad, spec.cap, cx, cy, cz,
                 BOND_KINDS[spec.bond_kind if spec.has_bonds else None],
                 spec.bond_slots if spec.has_bonds else 0,
                 int(spec.shift_energy), box_ptr(state, who),
                 float(spec.r_cut) ** 2, float(spec.fene_k or 0.0),
                 float(spec.fene_r0 or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"packed_lj_force_v1 kernel launch failed: CUDA "
                           f"error {err}")
    packed_lj_force_v1_cuda.launches += 1
    return state.replace(f=f, potential_energy=out[0], virial=out[1:4])


packed_lj_force_v1_cuda.launches = 0
