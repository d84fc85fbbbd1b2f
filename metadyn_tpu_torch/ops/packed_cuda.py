"""Wrapper of the hand-written Hopper pair-force kernel
(``csrc/packed_lj_force.cu``), the counterpart of
``metadyn_tpu/ops/packed_pallas2.packed_lj_force_pallas2`` in its
variants: the sentinel layout, per-slot ``se``/``hs`` (or ``se`` with a
uniform σ), per-type-pair scale tables, and FENE or harmonic bonds, each in
an orthorhombic or a tilted box (the kernel takes the cell matrix's six
entries from ``Box.h_host``); and the soft push-off pair
(``pair_kind="soft"``) in the per-slot ``se``/``hs`` layout, with or
without FENE bonds, which the reference runs as its XLA roll sweep
(``metadyn_tpu/ops/packed.py:830``): a layout of the port alone.  One
block per cell stages the real rows of its 27 neighbour cells in shared
memory (``csrc/cell_stage.cuh``); a cap whose 27 × cap staged rows do not
fit a block's shared memory raises.

On a CUDA tensor :func:`packed_lj_force_cuda` launches the kernel or raises;
on a CPU tensor it runs the plain version, ``ops.packed.packed_lj_force``.
There is no other fallback.  ``packed_lj_force_cuda.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .packed import (
    PackedSpec, PackedState, packed_lj_force, pair_scales_for,
)

KERNEL = "packed_lj_force"
MAX_BOND_SLOTS = 4          # csrc/pair_terms.cuh kMaxBondSlots
BOND_KINDS = {None: 0, "fene": 1, "harmonic": 2}


def check_spec(spec: PackedSpec) -> None:
    """Raise on any spec the kernel does not take: a uniform ε without a
    uniform σ, the sentinel layout with bonds, tables outside the per-slot
    ``se``/``hs`` layout, more than 4 bond slots, and the soft pair outside
    the per-slot ``se``/``hs`` layout without tables, with no bonds or FENE
    bonds."""
    if spec.pair_kind not in ("lj", "soft"):
        raise NotImplementedError(
            f"CUDA pair kernel: pair_kind {spec.pair_kind!r}")
    if spec.pair_kind == "soft" and (
            spec.uniform_eps is not None or spec.uniform_sigma is not None
            or spec.has_pair_table
            or (spec.has_bonds and spec.bond_kind != "fene")):
        raise NotImplementedError(
            "CUDA pair kernel: the soft pair needs the per-slot se/hs "
            "layout without tables, with no bonds or FENE bonds")
    if spec.uniform_eps is not None and spec.uniform_sigma is None:
        raise NotImplementedError("CUDA pair kernel: a uniform epsilon with "
                                  "per-slot sigma has no kernel layout")
    if spec.sentinel and spec.has_bonds:
        raise NotImplementedError("CUDA pair kernel: bonds in the sentinel "
                                  "layout have no kernel layout")
    if spec.has_pair_table and (spec.uniform_eps is not None
                                or spec.uniform_sigma is not None):
        raise NotImplementedError("CUDA pair kernel: pair tables need the "
                                  "per-slot se/hs layout")
    if spec.has_bonds and spec.bond_slots > MAX_BOND_SLOTS:
        raise NotImplementedError(f"CUDA pair kernel: at most "
                                  f"{MAX_BOND_SLOTS} bond slots")


def check_state(state: PackedState, spec: PackedSpec, who: str) -> None:
    """Raise on a state the kernels do not take: positions that are not
    contiguous f32 of shape (3, Npad).  Any box is taken, orthorhombic or
    tilted: the kernels read it from its host floats."""
    r = state.r
    if (r.dtype != torch.float32 or not r.is_contiguous()
            or tuple(r.shape) != (3, spec.n_pad)):
        raise ValueError(f"{who}: r must be contiguous f32 of shape "
                         f"(3, {spec.n_pad}); got {r.dtype} {tuple(r.shape)} "
                         f"contiguous={r.is_contiguous()}")


def slot_ptr(t: torch.Tensor, dtype, spec: PackedSpec, who: str,
             name: str) -> int:
    """Device pointer of a per-slot (Npad,) column, checked."""
    if (t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != (spec.n_pad,)):
        raise ValueError(f"{who}: {name} must be contiguous {dtype} of shape "
                         f"({spec.n_pad},); got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def bond_ptrs(state: PackedState, spec: PackedSpec, who: str) -> list:
    """The bp0.. attrs' pointers, padded with None to MAX_BOND_SLOTS."""
    n = spec.bond_slots if spec.has_bonds else 0
    ptrs = [slot_ptr(state.attrs[f"bp{k}"], torch.float32, spec, who,
                     f"bp{k}") for k in range(n)]
    return ptrs + [None] * (MAX_BOND_SLOTS - n)


@functools.lru_cache(maxsize=16)
def scale_table(spec: PackedSpec, device) -> torch.Tensor:
    """(2, nt, nt) f32 = (k_eps, k_sig) on ``device``: the plain version's
    scale functions evaluated at every type pair in f32, so the kernel
    reads the values the plain sweep computes."""
    tabs = [t for t in (spec.eps_scale, spec.sigma_scale) if t is not None]
    nt = len(tabs[0])
    ti, tj = torch.meshgrid(torch.arange(nt, dtype=torch.float32),
                            torch.arange(nt, dtype=torch.float32),
                            indexing="ij")
    out = []
    for fn in pair_scales_for(spec):
        k = torch.ones((nt, nt)) if fn is None else fn(ti, tj)
        out.append(torch.as_tensor(k, dtype=torch.float32).expand(nt, nt))
    return torch.stack(out).contiguous().to(device)


def _library():
    lib = _build.load(KERNEL)
    fn = lib.packed_lj_force
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 14
                       + [ctypes.c_float] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.packed_lj_force_blocks.argtypes = [ctypes.c_int] * 3
        lib.packed_lj_force_blocks.restype = ctypes.c_int
    return lib


def raise_on(err: int, what: str, spec: PackedSpec) -> None:
    """Raise on a kernel's nonzero return: -1 a layout without a kernel,
    -2 a cap whose staged rows do not fit a block's shared memory, else a
    CUDA error of the launch."""
    if err == -2:
        raise RuntimeError(f"{what}: cap {spec.cap} does not fit a block's "
                           "shared memory (27 * cap staged rows)")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def packed_lj_force_cuda(state: PackedState, spec: PackedSpec,
                         with_energy: bool = True) -> PackedState:
    """Pair forces of every layout :func:`check_spec` takes.

    With ``with_energy`` the state also gets the potential energy and the
    diagonal virial; without, only ``f`` is replaced and the two keep their
    old values (the inner-step mode)."""
    r = state.r
    if r.device.type == "cpu":
        return packed_lj_force(state, spec, with_energy=with_energy)
    if r.device.type != "cuda":
        raise ValueError(f"packed_lj_force_cuda: unsupported device {r.device}")
    who = "packed_lj_force_cuda"
    check_spec(spec)
    check_state(state, spec, who)
    lib = _library()
    se_eps = spec.uniform_eps is None
    hs_sig = spec.uniform_sigma is None
    se = (slot_ptr(state.attrs["se"], torch.float32, spec, who, "se")
          if se_eps else None)
    hs = (slot_ptr(state.attrs["hs"], torch.float32, spec, who, "hs")
          if hs_sig else None)
    typ = table = None
    n_types = 1
    if spec.has_pair_table:
        typ = slot_ptr(state.typ, torch.int32, spec, who, "typ")
        tab = scale_table(spec, r.device)
        n_types, table = tab.shape[1], tab.data_ptr()
    pid = (slot_ptr(state.pid, torch.int32, spec, who, "pid")
           if spec.has_bonds else None)
    f = torch.empty_like(r)
    if with_energy:
        # one partials row per block, one block per cell
        n_blocks = lib.packed_lj_force_blocks(*spec.cells_per_dim)
        partials = torch.empty((n_blocks, 4), dtype=torch.float32,
                               device=r.device)
        out = torch.empty(4, dtype=torch.float32, device=r.device)
        p_ptr, o_ptr = partials.data_ptr(), out.data_ptr()
    else:
        p_ptr = o_ptr = None
    bond_kind = BOND_KINDS[spec.bond_kind if spec.has_bonds else None]
    cx, cy, cz = spec.cells_per_dim
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.packed_lj_force(
            r.data_ptr(), se, hs, typ, pid, *bond_ptrs(state, spec, who),
            table, f.data_ptr(), p_ptr, o_ptr,
            spec.n_pad, spec.cap, cx, cy, cz, spec.n_real, int(se_eps),
            int(hs_sig), n_types, bond_kind,
            spec.bond_slots if spec.has_bonds else 0,
            int(spec.shift_energy), int(with_energy),
            int(spec.pair_kind == "soft"),
            *state.box.h_host(), float(spec.r_cut) ** 2, float(spec.r_cut),
            float(spec.uniform_sigma or 0.0) ** 2,
            float(spec.uniform_eps or 0.0),
            float(spec.fene_k or 0.0), float(spec.fene_r0 or 0.0),
            stream)
    raise_on(err, "packed_lj_force", spec)
    packed_lj_force_cuda.launches += 1
    if not with_energy:
        return state.replace(f=f)
    return state.replace(f=f, potential_energy=out[0], virial=out[1:4])


packed_lj_force_cuda.launches = 0
