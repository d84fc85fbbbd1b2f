"""Wrapper of the hand-written Hopper fused LJ + order-CV kernel
(``csrc/packed_fused_lj_order.cu``), the counterpart of
``metadyn_tpu/ops/packed_fused_pallas.fused_lj_order_force`` in its
recurrence mode and its monomial mode (``mono=True``: Q_6 in the monomial
basis of ``cv/ylm_mono.py``), with or without the spatial decomposition's
``cell_mask`` on the value sums (the reference's rule: only with
``mono``), in the sentinel layout (the reference's rule), in an
orthorhombic or a tilted box.  One block per cell stages the real rows of
its 27 neighbour cells once, prefiltered to the larger of the LJ cut-off
and the largest CV cut-off (:func:`fused_reach`), for both the LJ and the
CV math (``csrc/order_cv.cuh``).

One traversal returns the LJ pair force, the order-CV bias force from the
given (lagged) bias coefficients, and fresh CV value terms at the current
positions: the trailing force call of each sub-chunk on the lagged
multiple-time-stepping path (``sampler.make_lagged_parts``).

On a CUDA tensor :func:`fused_lj_order_force_cuda` launches the kernel or
raises; on a CPU tensor it runs :func:`fused_lj_order_force_plain`, the
reference's own oracle chain: the plain pair force, the plain force sweep
and the plain value sweep at the same positions, in the same mode.  There
is no other fallback.  ``fused_lj_order_force_cuda.launches`` counts the
launches; of them, ``mono_launches`` those in the monomial mode without a
mask and ``masked_launches`` those with one.

Not ported (it raises): the ``parts`` subsets, the reference's timing
modes (ROADMAP.md §2 item 5).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed import PackedSpec, PackedState, packed_lj_force
from .packed_cuda import check_spec, check_state, mask_ptr, raise_on
from .packed_order_cuda import (
    PREFILTER_MARGIN, _plan, _stream, decode_value_lanes, geometry_args,
    pack_force_aux, prefilter_base, prefilter_radius,
)

KERNEL = "packed_fused_lj_order"
ALL_PARTS = frozenset({"lj", "vals", "force"})


def _library():
    lib = _build.load(KERNEL)
    fn = lib.packed_fused_lj_order
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] + [ctypes.c_float] * 3
                       + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def fused_reach(r_cut: float, rc2_max: float, widths) -> tuple:
    """(hit radius², prefilter radius) of the fused kernel: the larger of
    the LJ cut-off and the CVs' largest cut-off (inf if a CV has none),
    and the staging prefilter's radius around it."""
    rc2_hit = max(float(r_cut) ** 2, rc2_max)
    return rc2_hit, prefilter_radius(rc2_hit, widths)


def fused_lj_order_force_plain(state: PackedState, spec: PackedSpec, cvs,
                               auxs, mono: bool = False,
                               cell_mask=None) -> tuple:
    """(f_lj, g, terms) from the plain pair force and the plain sweeps, in
    the recurrence or the monomial mode; ``cell_mask`` weights the value
    sums by each pair's i cell."""
    from ..cv.packed_order import (
        _half_partner_stacks, order_force_plain, order_values_plain,
    )
    f_lj = packed_lj_force(state, spec, with_energy=False).f
    stacks = _half_partner_stacks(state, spec)
    g = order_force_plain(state, spec, cvs, auxs, stacks=stacks, mono=mono)
    return f_lj, g, order_values_plain(state, spec, cvs, stacks=stacks,
                                       cell_mask=cell_mask, mono=mono)


def fused_lj_order_force_cuda(state: PackedState, spec: PackedSpec, cvs,
                              auxs, parts=ALL_PARTS, mono: bool = False,
                              cell_mask=None) -> tuple:
    """One traversal → (f_lj (3, Npad), g_bias (3, Npad), terms).

    ``auxs``: per-CV ``grad_aux`` outputs, usually from the previous
    evaluation's terms (the lag); ``terms`` are the fresh value sums.
    ``mono``: Q_l's math in the monomial basis (Q_6 on the card).
    ``cell_mask`` ((C,) f32, with ``mono`` only, as in the reference): each
    pair's value terms times its i cell's weight; the forces unmasked."""
    if frozenset(parts) != ALL_PARTS:
        raise NotImplementedError("the parts subsets (timing modes) are not "
                                  "ported yet (ROADMAP.md §2 item 5)")
    if cell_mask is not None and not mono:
        raise NotImplementedError("cell_mask requires the monomial math mode "
                                  "(mono=True), as in the reference")
    if not spec.sentinel or spec.has_bonds:
        raise ValueError("the fused LJ + CV kernel needs the lean sentinel "
                         "layout (uniform_sigma and uniform_eps, no bonds)")
    r = state.r
    if r.device.type == "cpu":
        return fused_lj_order_force_plain(state, spec, cvs, auxs, mono=mono,
                                          cell_mask=cell_mask)
    if r.device.type != "cuda":
        raise ValueError(f"fused_lj_order_force_cuda: unsupported device "
                         f"{r.device}")
    check_spec(spec)
    check_state(state, spec, "fused_lj_order_force_cuda")
    plan = _plan(tuple(cvs), r.device, mono)
    desc, n_vals, n_aux = plan.desc, plan.n_vals, plan.n_aux
    m_ptr = mask_ptr(cell_mask, spec, r.device, "fused_lj_order_force_cuda")
    aux = pack_force_aux(cvs, auxs, mono)
    if aux.numel() != n_aux or aux.device != r.device:
        raise ValueError(f"fused_lj_order_force_cuda: {aux.numel()} aux "
                         f"lanes on {aux.device}, expected {n_aux} on "
                         f"{r.device}")
    f = torch.empty_like(r)
    g = torch.empty_like(r)
    partials = torch.empty((spec.n_cells, n_vals), dtype=torch.float32,
                           device=r.device)
    out = torch.empty(n_vals, dtype=torch.float32, device=r.device)
    sig2 = float(spec.uniform_sigma) ** 2
    # the hit radius; the kernel widens the prefilter radius around it by
    # the margin from the box it reads (fused_reach is the same rule)
    rc2_hit = max(float(spec.r_cut) ** 2, plan.rc2_max)
    lib = _library()
    with torch.cuda.device(r.device):
        err = lib.packed_fused_lj_order(
            r.data_ptr(), desc.data_ptr(), desc.numel(), len(cvs), n_vals,
            aux.data_ptr(), n_aux, f.data_ptr(), g.data_ptr(),
            partials.data_ptr(), out.data_ptr(),
            *geometry_args(state, spec, "fused_lj_order_force_cuda"),
            float(spec.r_cut) ** 2, sig2, 4.0 * float(spec.uniform_eps),
            plan.cv_set, plan.l_fixed, plan.lanes, rc2_hit,
            prefilter_base(rc2_hit), PREFILTER_MARGIN, int(plan.mono), m_ptr,
            _stream(r.device))
    raise_on(err, "packed_fused_lj_order", spec)
    fused_lj_order_force_cuda.launches += 1
    if cell_mask is not None:
        fused_lj_order_force_cuda.masked_launches += 1
    elif plan.mono:
        fused_lj_order_force_cuda.mono_launches += 1
    return f, g, decode_value_lanes(cvs, out, mono)


fused_lj_order_force_cuda.launches = 0
fused_lj_order_force_cuda.mono_launches = 0
fused_lj_order_force_cuda.masked_launches = 0
