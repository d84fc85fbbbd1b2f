"""Wrapper of the hand-written Hopper pair-force kernel
(``csrc/packed_lj_force.cu``), the counterpart of
``metadyn_tpu/ops/packed_pallas2.packed_lj_force_pallas2`` in its sentinel
layout.

On a CUDA tensor :func:`packed_lj_force_cuda` launches the kernel or raises;
on a CPU tensor it runs the plain version, ``ops.packed.packed_lj_force``.
There is no other fallback.  ``packed_lj_force_cuda.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .packed import PackedSpec, PackedState, packed_lj_force

KERNEL = "packed_lj_force"


def check_spec(spec: PackedSpec) -> None:
    """Raise on any spec the kernel does not take."""
    if spec.pair_kind != "lj":
        raise NotImplementedError(f"CUDA pair kernel: pair_kind "
                                  f"{spec.pair_kind!r} (only 'lj')")
    if not spec.sentinel:
        raise NotImplementedError(
            "CUDA pair kernel: only the sentinel layout (uniform_sigma and "
            "uniform_eps set) is ported; per-slot se/hs is not")
    if spec.has_bonds:
        raise NotImplementedError("CUDA pair kernel: bonds are not ported")
    if spec.has_pair_table:
        raise NotImplementedError("CUDA pair kernel: per-type pair tables "
                                  "are not ported")


def check_state(state: PackedState, spec: PackedSpec, who: str) -> None:
    """Raise on a state the kernels do not take: a tilted box, or positions
    that are not contiguous f32 of shape (3, Npad)."""
    if state.box.tilt is not None:
        raise NotImplementedError(f"{who}: triclinic boxes are not ported")
    r = state.r
    if (r.dtype != torch.float32 or not r.is_contiguous()
            or tuple(r.shape) != (3, spec.n_pad)):
        raise ValueError(f"{who}: r must be contiguous f32 of shape "
                         f"(3, {spec.n_pad}); got {r.dtype} {tuple(r.shape)} "
                         f"contiguous={r.is_contiguous()}")


def _function():
    lib = _build.load(KERNEL)
    fn = lib.packed_lj_force
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.packed_lj_force_threads.argtypes = []
        lib.packed_lj_force_threads.restype = ctypes.c_int
    return fn, lib.packed_lj_force_threads()


def packed_lj_force_cuda(state: PackedState, spec: PackedSpec,
                         with_energy: bool = True) -> PackedState:
    """LJ pair forces of the sentinel layout.

    With ``with_energy`` the state also gets the potential energy and the
    diagonal virial; without, only ``f`` is replaced and the two keep their
    old values (the inner-step mode)."""
    r = state.r
    if r.device.type == "cpu":
        return packed_lj_force(state, spec, with_energy=with_energy)
    if r.device.type != "cuda":
        raise ValueError(f"packed_lj_force_cuda: unsupported device {r.device}")
    check_spec(spec)
    check_state(state, spec, "packed_lj_force_cuda")
    fn, threads = _function()
    f = torch.empty_like(r)
    if with_energy:
        n_blocks = -(-spec.n_pad // threads)
        partials = torch.empty((n_blocks, 4), dtype=torch.float32,
                               device=r.device)
        out = torch.empty(4, dtype=torch.float32, device=r.device)
        p_ptr, o_ptr = partials.data_ptr(), out.data_ptr()
    else:
        p_ptr = o_ptr = None
    sig2 = float(spec.uniform_sigma) ** 2
    rc2 = float(spec.r_cut) ** 2
    eps4 = 4.0 * float(spec.uniform_eps)
    sc6 = (sig2 / rc2) ** 3
    e_shift = eps4 * (sc6 * sc6 - sc6) if spec.shift_energy else 0.0
    Lx, Ly, Lz = state.box.L_host
    cx, cy, cz = spec.cells_per_dim
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), f.data_ptr(), p_ptr, o_ptr, spec.n_pad,
                 spec.cap, cx, cy, cz, Lx, Ly, Lz, rc2, sig2, eps4, e_shift,
                 int(with_energy), stream)
    if err != 0:
        raise RuntimeError(f"packed_lj_force kernel launch failed: CUDA "
                           f"error {err}")
    packed_lj_force_cuda.launches += 1
    if not with_energy:
        return state.replace(f=f)
    return state.replace(f=f, potential_energy=out[0], virial=out[1:4])


packed_lj_force_cuda.launches = 0
