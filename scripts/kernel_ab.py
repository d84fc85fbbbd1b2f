#!/usr/bin/env python3
"""Time the port's orthorhombic kernels of one source tree on one GPU.

    python3 scripts/kernel_ab.py ROOT

ROOT is a checkout of this repository (the working tree, or an unpacked
``git archive`` of another commit); its ``metadyn_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built into its own
``_build/``.  To compare two commits, run the script once per tree in
turns on the same card (A, B, B, A) and compare the lines.

Timed, each the median of CUDA-event times over many calls after warm-up
calls (``chip_smoke.cuda_ms``), at the main paths' shapes:
- kernel 1 forces only and with energy on the 62,500-particle liquid
  (bench_data/liq64k.npz, the sentinel layout);
- kernel 1 forces only and the v1 kernel on a cubic 62,500-particle fcc
  (a = 1.68, noise 0.05) in the per-slot layout (r_cut 2.5, skin 0.4,
  cap 40);
- kernels 2, 3 and 4 on Config 3's input (chip_smoke.config3_inputs, fcc
  plus noise 0.05, Q6 + coordination).

Prints one line, ``AB {json}``, with the times in ms.
"""
import json
import pathlib
import sys


def main(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from metadyn_tpu_torch import Box, PackedEngine, PackedSpec, fcc_lattice
    from metadyn_tpu_torch.cv.packed_order import order_values_plain
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: torch finds no CUDA device")
    assert pathlib.Path(cs.__file__).resolve().parent == root
    dev = torch.device("cuda", 0)

    def pack(spec, pos, L):
        n = pos.shape[0]
        st, ovf = PackedEngine(spec, dev).pack_state(
            pos, Box.cubic(L, dev), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, np.float32))
        assert not ovf
        return st

    def ms(fn, calls=101):
        return cs.cuda_ms(fn, calls=calls, warm=5)

    out = {"tree": str(root), "card": torch.cuda.get_device_name(0)}
    d = np.load(root / "bench_data" / "liq64k.npz")
    L = float(d["L"])
    spec = PackedSpec.create(L, d["pos"].shape[0], r_cut=2.5, skin=0.55,
                             cap=40, shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    st = pack(spec, d["pos"], L)
    out["k1_liq64k"] = ms(lambda: packed_lj_force_cuda(st, spec, False))
    out["k1_liq64k_energy"] = ms(lambda: packed_lj_force_cuda(st, spec, True))

    pos = fcc_lattice(25, 1.68)
    L = 25 * 1.68
    pos = (pos + np.random.default_rng(5).normal(0.0, 0.05, pos.shape)
           ).astype(np.float32)
    spec = PackedSpec.create(L, pos.shape[0], r_cut=2.5, skin=0.4, cap=40,
                             shift_energy=False)
    st = pack(spec, pos, L)
    out["k1_se_hs_fcc62k"] = ms(lambda: packed_lj_force_cuda(st, spec, False))
    out["v1_se_hs_fcc62k"] = ms(lambda: packed_lj_force_v1_cuda(st, spec))

    pos, _, L, a, spec = cs.config3_inputs(32, noise=0.05)
    st = pack(spec, pos, L)
    cvs = cs.config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in
            enumerate(zip(cvs, order_values_plain(st, spec, cvs)))]
    out["values_cfg3"] = ms(lambda: order_values_cuda(st, spec, cvs), 51)
    out["force_cfg3"] = ms(lambda: order_force_cuda(st, spec, cvs, auxs), 51)
    out["fused_cfg3"] = ms(
        lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs), 51)
    return out


if __name__ == "__main__":
    print("AB " + json.dumps(main(pathlib.Path(sys.argv[1]).resolve())))
