"""Wrappers of the hand-written Hopper order-CV kernels
(``csrc/packed_order.cu``), the counterparts of
``metadyn_tpu/ops/packed_order_pallas.py`` ``order_values_pallas`` and
``order_force_pallas``: the sentinel layout (uniform σ and ε, vacancy by
the coordinate sentinel) and the validity layout (per-slot ``se``/``hs``,
vacancy by ``pid < n_real``), in an orthorhombic or a tilted box; the
values kernel with the spatial decomposition's ``cell_mask`` (each cell's
value sums times its weight, ``parallel/spatial.py``).

Both kernels run one block per cell over the real rows of its 27
neighbour cells staged in shared memory (``csrc/cell_stage.cuh``,
``csrc/order_cv.cuh``), after a prefilter that stages only rows within
reach of the cell's i rows (:func:`prefilter_keep` is the rule in plain
PyTorch).  The kernels read the cell matrix and the perpendicular widths
from device memory (the box's geometry row ``Box.geo``, copied to constant
memory on the stream before each launch) and the prefilter radius from
those, so a box that the NPT barostat moved needs no host read.  The force kernel writes one row of g per i row; the values
kernel keeps one queue of hits across a warp's rows and writes one row of
value partials per cell, summed in double by a second pass.

On a CUDA tensor :func:`order_values_cuda` and :func:`order_force_cuda`
launch their kernel or raise; on a CPU tensor they run the plain roll
sweeps of ``cv/packed_order.py``.  There is no other fallback.  Each
wrapper's ``launches`` counts its kernel launches;
``order_values_cuda.masked_launches`` those with a ``cell_mask``.

The CVs reach the kernels as a float descriptor (format in
``csrc/order_cv.cuh``) built from each CV's ``kernel_descriptor()`` and
uploaded once per (CV list, device, mode).  Value terms and bias
coefficients use the lane layout of :func:`lane_layout`: per CV its
``n_value_terms`` value lanes and ``aux_size`` aux lanes, in list order, or
in the fused kernel's monomial mode n_mono(l) + 1 value lanes and
3·n_mono(l − 1) aux lanes for a Q_l (the reference's ``_lane_layout``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..cv.ylm_mono import n_mono
from .packed import PackedSpec, PackedState, _frac3
from .packed_cuda import box_ptr, check_state, mask_ptr, raise_on, slot_ptr

KERNEL = "packed_order"

# descriptor limits, as csrc/order_cv.cuh states them (MAX_L is this
# wrapper's: the f32 p_lm tables lose accuracy at high degree)
HDR = 9
MAX_CVS = 8
MAX_L = 12
MAX_TERMS = 64
MAX_AUX = 64
MAX_DESC = 1024
KIND_QL = 0
# the kernels' CV-kind sets and value-lane layouts (csrc/order_cv.cuh):
# LANES_Q6 is the CV list [Q6], LANES_Q6_COORD [Q6, coordination], whose
# value lanes the kernels know at compile time
CV_SET_QL, CV_SET_COORD, CV_SET_MIXED = 1, 2, 3
LANES_ANY, LANES_Q6, LANES_Q6_COORD = 0, 1, 2
# the prefilter radius' margin per unit of the summed perpendicular widths:
# far above the f32 rounding of the kernel's fractional coordinates
PREFILTER_MARGIN = 1e-4


def is_mono(cv, mono: bool) -> bool:
    """Whether ``cv`` runs in the monomial basis: a sphere-polynomial CV
    (Q_l) in the monomial mode."""
    return mono and getattr(cv, "sphere_poly", False)


def lane_layout(cvs, mono: bool = False) -> tuple[list, list, int, int]:
    """(aux lane offsets, value lane offsets, aux lanes, value lanes)."""
    aux_off, val_off = [], []
    na = nv = 0
    for cv in cvs:
        aux_off.append(na)
        val_off.append(nv)
        if is_mono(cv, mono):
            na += 3 * n_mono(cv.l - 1)
            nv += n_mono(cv.l) + 1
        else:
            na += cv.aux_size
            nv += cv.n_value_terms
    return aux_off, val_off, na, nv


def pack_force_aux(cvs, auxs, mono: bool = False) -> torch.Tensor:
    """The CVs' ``grad_aux`` outputs as one (aux lanes,) f32 device tensor
    (the reference pads to a (1, 128) lane row; the kernels take the
    length); in the monomial mode a Q_l's lanes are its three
    ``mono_force_vecs``."""
    lanes = []
    for cv, aux in zip(cvs, auxs):
        if is_mono(cv, mono):
            lanes += [b.reshape(-1) for b in cv.mono_force_vecs(aux)]
        else:
            lanes.append(cv.aux_flat(aux).reshape(-1))
    return torch.cat([a.to(torch.float32) for a in lanes]).contiguous()


def decode_value_lanes(cvs, vals: torch.Tensor, mono: bool = False) -> tuple:
    """Kernel value lanes → per-CV ``terms`` (the plain sweep's structure);
    in the monomial mode a Q_l's monomial sums go through
    ``mono_value_decode``."""
    _, val_off, _, _ = lane_layout(cvs, mono)
    out = []
    for cv, off in zip(cvs, val_off):
        if is_mono(cv, mono):
            nm = n_mono(cv.l)
            out.append(cv.mono_value_decode(vals[off:off + nm],
                                            vals[off + nm]))
        else:
            out.append(cv.terms_from_flat(vals[off:off + cv.n_value_terms]))
    return tuple(out)


def cv_descriptor(cvs, mono: bool = False) -> np.ndarray:
    """The kernels' CV descriptor: one header of ``HDR`` floats per CV
    ``[kind, l, val_off, aux_off, tab_off, rc2, r02, sc, scale]``, then the
    CVs' tables; ``mono``: the lane offsets of the monomial mode, whose
    kernel takes Q_l with l = 6 only.  Raises on a CV without kernel math,
    on l > ``MAX_L`` and beyond the kernels' lane and descriptor limits."""
    cvs = list(cvs)
    if not 1 <= len(cvs) <= MAX_CVS:
        raise ValueError(f"CUDA order kernels: 1..{MAX_CVS} CVs, got "
                         f"{len(cvs)}")
    for cv in cvs:
        if is_mono(cv, mono) and cv.l != 6:
            raise NotImplementedError(
                f"CUDA fused kernel: the monomial mode takes Q_6 only "
                f"(CV {cv.name!r} has l={cv.l}; l = 8 needs 108 aux lanes "
                f"past the kernel's {MAX_AUX})")
    aux_off, val_off, n_aux, n_vals = lane_layout(cvs, mono)
    if n_vals > MAX_TERMS or n_aux > MAX_AUX:
        raise ValueError(f"CUDA order kernels: {n_vals} value and {n_aux} aux "
                         f"lanes exceed {MAX_TERMS} and {MAX_AUX}")
    headers, tables = [], []
    tab_off = HDR * len(cvs)
    for cv, ao, vo in zip(cvs, aux_off, val_off):
        if not hasattr(cv, "kernel_descriptor"):
            raise NotImplementedError(
                f"CUDA order kernels: CV {getattr(cv, 'name', cv)!r} has no "
                "kernel math (Q_l and coordination only)")
        kind, l, rc2, r02, sc, scale, table = cv.kernel_descriptor()
        if kind == 0 and l > MAX_L:
            raise NotImplementedError(f"CUDA order kernels: Q_l with l={l} > "
                                      f"{MAX_L}")
        headers += [kind, l, vo, ao, tab_off, rc2, r02, sc, scale]
        tables.append(np.asarray(table, np.float32))
        tab_off += len(tables[-1])
    desc = np.concatenate([np.asarray(headers, np.float32)] + tables)
    if desc.size > MAX_DESC:
        raise ValueError(f"CUDA order kernels: descriptor of {desc.size} "
                         f"floats exceeds {MAX_DESC}")
    return desc


class Plan(NamedTuple):
    """A CV list as the kernels take it."""

    desc: torch.Tensor  # the descriptor, on the device
    n_vals: int         # value lanes
    n_aux: int          # aux lanes
    cv_set: int         # CV_SET_*: the kinds the kernels instantiate
    l_fixed: int        # 6 if every Q_l has l = 6 (unrolled math), else 0
    rc2_max: float      # the largest cut-off squared (inf if a CV has none)
    lanes: int          # LANES_*: the value-lane layout
    mono: bool          # the monomial mode (with at least one Q_l)


@functools.lru_cache(maxsize=32)
def _plan(cvs: tuple, device: torch.device, mono: bool = False) -> Plan:
    """The :class:`Plan` of a CV list, uploaded once per (CV list, device,
    mode)."""
    desc = cv_descriptor(cvs, mono)
    _, _, n_aux, n_vals = lane_layout(cvs, mono)
    heads = desc[:HDR * len(cvs)].reshape(len(cvs), HDR)
    ql = heads[:, 0] == KIND_QL
    cv_set = (CV_SET_QL if ql.all() else
              CV_SET_COORD if not ql.any() else CV_SET_MIXED)
    l_fixed = 6 if ql.any() and (heads[ql, 1] == 6).all() else 0
    q6 = ql[0] and heads[0, 1] == 6
    lanes = (LANES_Q6 if q6 and len(cvs) == 1 else
             LANES_Q6_COORD if q6 and len(cvs) == 2 and not ql[1] else
             LANES_ANY)
    return Plan(torch.as_tensor(desc, device=device), n_vals, n_aux, cv_set,
                l_fixed, float(heads[:, 5].max()), lanes,
                any(is_mono(cv, mono) for cv in cvs))


def prefilter_base(rc2_max: float) -> float:
    """The prefilter radius' base, the largest cut-off (inf: a CV has none,
    no prefilter); the kernels add PREFILTER_MARGIN × Σ perpendicular
    widths of the box they read (:func:`prefilter_radius`)."""
    return math.sqrt(rc2_max) if math.isfinite(rc2_max) else math.inf


def prefilter_radius(rc2_max: float, widths) -> float:
    """The staging prefilter's radius: the largest cut-off plus a margin of
    PREFILTER_MARGIN × Σ perpendicular widths; inf (no prefilter) when a
    CV has no cut-off."""
    return prefilter_base(rc2_max) + PREFILTER_MARGIN * sum(widths)


def prefilter_keep(xi: torch.Tensor, xj: torch.Tensor, box,
                   radius: float) -> torch.Tensor:
    """The kernels' staging prefilter in plain PyTorch: for a cell's
    real i rows ``xi`` (3, K) and candidate rows ``xj`` (3, M) (their
    neighbour cell's shift applied), whether each candidate is staged.

    With [lo, hi] the i rows' box in fractional coordinates, a candidate at
    f is at least g_d·w_d from it along axis d, g_d = max(lo_d − f_d, f_d −
    hi_d, 0), w_d the perpendicular width; kept when max_d g_d·w_d <
    ``radius``, in any box."""
    if not math.isfinite(radius):
        return torch.ones(xj.shape[1], dtype=torch.bool)
    w = box.widths.cpu()
    fi, fj = _frac3(xi, box), _frac3(xj, box)
    lo = fi.min(dim=1).values[:, None]
    hi = fi.max(dim=1).values[:, None]
    gap = torch.clamp(torch.maximum(lo - fj, fj - hi), min=0.0) * w[:, None]
    return gap.max(dim=0).values < radius


def check_layout(state: PackedState, spec: PackedSpec, who: str) -> tuple:
    """Raise on a state the order kernels do not take; return the layout
    arguments (pid pointer, n_real): the checked int32 pids in the validity
    layout, (None, 0) in the sentinel layout."""
    check_state(state, spec, who)
    if spec.sentinel:
        return None, 0
    return slot_ptr(state.pid, torch.int32, spec, who, "pid"), spec.n_real


def geometry_args(state: PackedState, spec: PackedSpec, who: str) -> tuple:
    """(n_pad, cap, cx, cy, cz, box) as the kernels take them: the cell
    grid and the device pointer of the box's geometry row (``Box.geo``)."""
    return (spec.n_pad, spec.cap, *spec.cells_per_dim, box_ptr(state, who))


def _library():
    lib = _build.load(KERNEL)
    if lib.packed_order_values.argtypes is None:
        geom = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        layout = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.packed_order_values.argtypes = (
            layout + [ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2 + geom + [ctypes.c_int] * 3
            + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
        lib.packed_order_values.restype = ctypes.c_int
        lib.packed_order_force.argtypes = (
            layout + [ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + geom
            + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.packed_order_force.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_of(state: PackedState, who: str) -> torch.device:
    dev = state.r.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def order_values_cuda(state: PackedState, spec: PackedSpec, cvs,
                      stacks=None, cell_mask=None) -> tuple:
    """Value sums of every CV in one traversal → per-CV ``terms``.
    ``stacks``: prebuilt partner stacks for the plain sweep (CPU only);
    ``cell_mask`` ((C,) f32): each cell's value sums times its weight."""
    if _device_of(state, "order_values_cuda").type == "cpu":
        from ..cv.packed_order import order_values_plain
        return order_values_plain(state, spec, cvs, stacks=stacks,
                                  cell_mask=cell_mask)
    pid, n_real = check_layout(state, spec, "order_values_cuda")
    m_ptr = mask_ptr(cell_mask, spec, state.r.device, "order_values_cuda")
    r = state.r
    plan = _plan(tuple(cvs), r.device)
    desc, n_vals = plan.desc, plan.n_vals
    partials = torch.empty((spec.n_cells, n_vals), dtype=torch.float32,
                           device=r.device)
    out = torch.empty(n_vals, dtype=torch.float32, device=r.device)
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.packed_order_values(
            r.data_ptr(), pid, n_real, desc.data_ptr(), desc.numel(),
            len(cvs), n_vals, partials.data_ptr(), out.data_ptr(),
            *geometry_args(state, spec, "order_values_cuda"), plan.cv_set,
            plan.l_fixed, plan.lanes, plan.rc2_max,
            prefilter_base(plan.rc2_max), PREFILTER_MARGIN, m_ptr,
            _stream(r.device))
    raise_on(err, "packed_order_values", spec)
    order_values_cuda.launches += 1
    order_values_cuda.masked_launches += cell_mask is not None
    return decode_value_lanes(cvs, out)


def order_force_cuda(state: PackedState, spec: PackedSpec, cvs, auxs,
                     stacks=None) -> torch.Tensor:
    """Bias force (3, Npad) Σ_cv Σ_j ``pair_grad_terms(d_ij, aux_cv)``.
    ``stacks``: prebuilt partner stacks for the plain sweep (CPU only)."""
    if _device_of(state, "order_force_cuda").type == "cpu":
        from ..cv.packed_order import order_force_plain
        return order_force_plain(state, spec, cvs, auxs, stacks=stacks)
    pid, n_real = check_layout(state, spec, "order_force_cuda")
    r = state.r
    plan = _plan(tuple(cvs), r.device)
    aux = pack_force_aux(cvs, auxs)
    if aux.numel() != plan.n_aux or aux.device != r.device:
        raise ValueError(f"order_force_cuda: {aux.numel()} aux lanes on "
                         f"{aux.device}, expected {plan.n_aux} on {r.device}")
    g = torch.empty_like(r)
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.packed_order_force(
            r.data_ptr(), pid, n_real, plan.desc.data_ptr(),
            plan.desc.numel(), len(cvs), aux.data_ptr(), plan.n_aux,
            g.data_ptr(), *geometry_args(state, spec, "order_force_cuda"),
            plan.cv_set, plan.l_fixed, plan.rc2_max,
            prefilter_base(plan.rc2_max), PREFILTER_MARGIN,
            _stream(r.device))
    raise_on(err, "packed_order_force", spec)
    order_force_cuda.launches += 1
    return g


order_values_cuda.launches = 0
order_values_cuda.masked_launches = 0
order_force_cuda.launches = 0
