"""Wrapper of the hand-written Hopper pair-force kernel
(``csrc/packed_lj_force.cu``), the counterpart of
``metadyn_tpu/ops/packed_pallas2.packed_lj_force_pallas2`` in its
variants: the sentinel layout, per-slot ``se``/``hs`` (or ``se`` with a
uniform σ), per-type-pair scale tables, and FENE or harmonic bonds, each in
an orthorhombic or a tilted box (the kernel reads the cell matrix's six
entries from device memory, the first of the box's geometry row
``Box.geo``, so a box that the NPT barostat rescales on the device needs
no host read); and the soft push-off pair
(``pair_kind="soft"``) in the per-slot ``se``/``hs`` layout, with or
without FENE bonds, which the reference runs as its XLA roll sweep
(``metadyn_tpu/ops/packed.py:830``): a layout of the port alone.  One
block per cell stages the real rows of its 27 neighbour cells in shared
memory (``csrc/cell_stage.cuh``); a cap whose 27 × cap staged rows do not
fit a block's shared memory raises.

With ``cell_mask`` (the spatial decomposition's per-cell 0/1 weights) the
energy and virial sums weight each pair by its i cell, the forces stay
unmasked: the reference's ``packed_lj_force(cell_mask=)``, which its
spatial engine runs as XLA (its Pallas kernel halves the pairs); the
port's kernel sums every ordered pair on its i side, so one weight per
block's sums is exact.

A walker batch (``core/batch.py``: W states stacked on a leading
dimension, each with a box of its own) is one launch over all W walkers,
the grid of blocks repeated per walker on a second grid dimension, each
block reading its walker's cell matrix (``Box.geo`` (W, BOX_ROW)); walker
w gets
the bits a launch on walker w alone gives.

On a CUDA tensor :func:`packed_lj_force_cuda` launches the kernel or raises;
on a CPU tensor it runs the plain version, ``ops.packed.packed_lj_force``.
There is no other fallback.  ``packed_lj_force_cuda.launches`` counts the
kernel launches (a batch's launch once), ``walkers`` the walkers they
covered, ``energy_launches`` those with the energy and virial and
``masked_launches`` those with a ``cell_mask``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ..core.batch import batch_size
from ..core.box import BOX_ROW
from .packed import (
    PackedSpec, PackedState, packed_lj_force, pair_scales_for,
)

KERNEL = "packed_lj_force"
# bond slots whose partner columns the v1 kernel takes one by one
# (csrc/pair_terms.cuh kRegBondSlots); any further slots go as one stacked
# array (bond_ptrs)
REG_BOND_SLOTS = 4
# bond slots whose partner columns kernel 1 takes by pointer
# (csrc/packed_lj_force.cu kColSlots); any further slots go as one stacked
# array (bond_cols)
COL_BOND_SLOTS = 8
BOND_KINDS = {None: 0, "fene": 1, "harmonic": 2}


def check_spec(spec: PackedSpec) -> None:
    """Raise on any spec the kernel does not take: a uniform ε without a
    uniform σ, the sentinel layout with bonds, tables outside the per-slot
    ``se``/``hs`` layout, and the soft pair outside the per-slot
    ``se``/``hs`` layout without tables, with no bonds or FENE bonds.  Any
    number of bond slots is taken, as in the reference."""
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


def check_state(state: PackedState, spec: PackedSpec, who: str,
                lead: tuple = ()) -> None:
    """Raise on a state the kernels do not take: positions that are not
    contiguous f32 of shape ``lead`` + (3, Npad) (``lead`` = (W,) for a
    walker batch).  Any box is taken, orthorhombic or tilted: the kernels
    read it from device memory (:func:`box_ptr`)."""
    r = state.r
    if (r.dtype != torch.float32 or not r.is_contiguous()
            or tuple(r.shape) != (*lead, 3, spec.n_pad)):
        raise ValueError(f"{who}: r must be contiguous f32 of shape "
                         f"{(*lead, 3, spec.n_pad)}; got {r.dtype} "
                         f"{tuple(r.shape)} contiguous={r.is_contiguous()}")


def slot_ptr(t: torch.Tensor, dtype, spec: PackedSpec, who: str,
             name: str, lead: tuple = ()) -> int:
    """Device pointer of a per-slot ``lead`` + (Npad,) column, checked."""
    if (t.dtype != dtype or not t.is_contiguous()
            or tuple(t.shape) != (*lead, spec.n_pad)):
        raise ValueError(f"{who}: {name} must be contiguous {dtype} of shape "
                         f"{(*lead, spec.n_pad)}; got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.data_ptr()


def box_ptr(state: PackedState, who: str, lead: tuple = ()) -> int:
    """Device pointer of the state's geometry rows ``Box.geo`` (the cell
    matrix, the perpendicular widths and their sum), ``lead`` + (BOX_ROW,)
    f32 on the positions' device, checked."""
    g = state.box.geo
    if (g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (*lead, BOX_ROW)
            or g.device != state.r.device):
        raise ValueError(f"{who}: the box's geometry must be contiguous f32 "
                         f"of shape {(*lead, BOX_ROW)} on {state.r.device}; "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    return g.data_ptr()


def mask_ptr(cell_mask, spec: PackedSpec, device, who: str):
    """Device pointer of a (C,) f32 cell mask on ``device``, checked; None
    for no mask."""
    if cell_mask is None:
        return None
    if (cell_mask.dtype != torch.float32 or not cell_mask.is_contiguous()
            or tuple(cell_mask.shape) != (spec.n_cells,)
            or cell_mask.device != device):
        raise ValueError(f"{who}: cell_mask must be contiguous f32 of shape "
                         f"({spec.n_cells},) on {device}")
    return cell_mask.data_ptr()


def bond_ptrs(state: PackedState, spec: PackedSpec, who: str,
              lead: tuple = ()) -> tuple:
    """(pointers, keep): the bp0..bp3 attrs' pointers, padded with None to
    REG_BOND_SLOTS, then that of the further slots' attrs stacked into one
    contiguous (bond_slots − 4, *lead, Npad) array (None for at most 4
    slots); ``keep`` holds that array until the launch is queued."""
    n = spec.bond_slots if spec.has_bonds else 0
    cols = [state.attrs[f"bp{k}"] for k in range(n)]
    ptrs = [slot_ptr(c, torch.float32, spec, who, f"bp{k}", lead)
            for k, c in enumerate(cols)]
    more = (torch.stack(cols[REG_BOND_SLOTS:]).contiguous()
            if n > REG_BOND_SLOTS else None)
    return (ptrs[:REG_BOND_SLOTS] + [None] * max(REG_BOND_SLOTS - n, 0)
            + [None if more is None else more.data_ptr()]), more


def bond_cols(state: PackedState, spec: PackedSpec, who: str,
              lead: tuple = ()) -> tuple:
    """(cols, more, keep) as kernel 1 takes its bond-partner attrs: a
    host array of the first min(bond_slots, COL_BOND_SLOTS) columns'
    device pointers (None without bonds), the device pointer of the
    further slots stacked into one contiguous (bond_slots − 8, *lead,
    Npad) array (None for at most 8 slots), and ``keep``, which holds that
    array until the launch is queued."""
    n = spec.bond_slots if spec.has_bonds else 0
    cols = [state.attrs[f"bp{k}"] for k in range(n)]
    ptrs = [slot_ptr(c, torch.float32, spec, who, f"bp{k}", lead)
            for k, c in enumerate(cols)]
    more = (torch.stack(cols[COL_BOND_SLOTS:]).contiguous()
            if n > COL_BOND_SLOTS else None)
    head = ptrs[:COL_BOND_SLOTS]
    arr = (ctypes.c_void_p * len(head))(*head) if head else None
    return arr, None if more is None else more.data_ptr(), more


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
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.POINTER(ctypes.c_void_p)]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p] + [ctypes.c_float] * 6
                       + [ctypes.c_void_p])
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
                         with_energy: bool = True,
                         cell_mask=None) -> PackedState:
    """Pair forces of every layout :func:`check_spec` takes, on one state
    or a walker batch.

    With ``with_energy`` the state also gets the potential energy and the
    diagonal virial ((W,) and (W, 3) for a batch); without, only ``f`` is
    replaced and the two keep their old values (the inner-step mode).
    ``cell_mask`` ((C,) f32) weights the energy and virial sums by each
    pair's i cell (with ``with_energy`` only)."""
    r = state.r
    if cell_mask is not None and not with_energy:
        raise ValueError("packed_lj_force_cuda: cell_mask weights the energy "
                         "and virial sums; it needs with_energy")
    if r.device.type == "cpu":
        return packed_lj_force(state, spec, with_energy=with_energy,
                               cell_mask=cell_mask)
    if r.device.type != "cuda":
        raise ValueError(f"packed_lj_force_cuda: unsupported device {r.device}")
    who = "packed_lj_force_cuda"
    check_spec(spec)
    n_walkers = batch_size(state)
    lead = () if n_walkers is None else (n_walkers,)
    check_state(state, spec, who, lead)
    h = box_ptr(state, who, lead)
    lib = _library()
    se_eps = spec.uniform_eps is None
    hs_sig = spec.uniform_sigma is None
    se = (slot_ptr(state.attrs["se"], torch.float32, spec, who, "se", lead)
          if se_eps else None)
    hs = (slot_ptr(state.attrs["hs"], torch.float32, spec, who, "hs", lead)
          if hs_sig else None)
    typ = table = None
    n_types = 1
    if spec.has_pair_table:
        typ = slot_ptr(state.typ, torch.int32, spec, who, "typ", lead)
        tab = scale_table(spec, r.device)
        n_types, table = tab.shape[1], tab.data_ptr()
    pid = (slot_ptr(state.pid, torch.int32, spec, who, "pid", lead)
           if spec.has_bonds else None)
    f = torch.empty_like(r)
    if with_energy:
        # one partials row per block, one block per cell and walker
        n_blocks = lib.packed_lj_force_blocks(*spec.cells_per_dim)
        partials = torch.empty((*lead, n_blocks, 4), dtype=torch.float32,
                               device=r.device)
        out = torch.empty((*lead, 4), dtype=torch.float32, device=r.device)
        p_ptr, o_ptr = partials.data_ptr(), out.data_ptr()
    else:
        p_ptr = o_ptr = None
    m_ptr = mask_ptr(cell_mask, spec, r.device, who)
    bond_kind = BOND_KINDS[spec.bond_kind if spec.has_bonds else None]
    cx, cy, cz = spec.cells_per_dim
    cols, more, _keep = bond_cols(state, spec, who, lead)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.packed_lj_force(
            r.data_ptr(), se, hs, typ, pid, cols, more, table, f.data_ptr(), p_ptr, o_ptr, m_ptr,
            spec.n_pad, spec.cap, cx, cy, cz, spec.n_real, int(se_eps),
            int(hs_sig), n_types, bond_kind,
            spec.bond_slots if spec.has_bonds else 0,
            int(spec.shift_energy), int(with_energy),
            int(spec.pair_kind == "soft"), n_walkers or 1,
            h, float(spec.r_cut) ** 2, float(spec.r_cut),
            float(spec.uniform_sigma or 0.0) ** 2,
            float(spec.uniform_eps or 0.0),
            float(spec.fene_k or 0.0), float(spec.fene_r0 or 0.0),
            stream)
    raise_on(err, "packed_lj_force", spec)
    packed_lj_force_cuda.launches += 1
    packed_lj_force_cuda.walkers += n_walkers or 1
    packed_lj_force_cuda.energy_launches += with_energy
    packed_lj_force_cuda.masked_launches += cell_mask is not None
    if not with_energy:
        return state.replace(f=f)
    return state.replace(f=f, potential_energy=out[..., 0],
                         virial=out[..., 1:4])


packed_lj_force_cuda.launches = 0
packed_lj_force_cuda.walkers = 0
packed_lj_force_cuda.energy_launches = 0
packed_lj_force_cuda.masked_launches = 0
