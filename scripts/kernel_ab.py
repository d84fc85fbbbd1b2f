#!/usr/bin/env python3
"""Time the port's kernels of one source tree on one GPU.

    python3 scripts/kernel_ab.py ROOT

ROOT is a checkout of this repository (the working tree, or an unpacked
``git archive`` of another commit); its ``metadyn_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built into its own
``_build/``.  To compare two commits, run the script once per tree in
turns on the same card (A, B, B, A) and compare the lines.

Timed, each the median of CUDA-event times over many calls after warm-up
calls (``cuda_ms`` of the chip_smoke.py beside this script, so that both
trees are timed alike), at the main paths' shapes:
- kernel 1 forces only and with energy on the 62,500-particle liquid
  (bench_data/liq64k.npz, the sentinel layout), and forces only with the
  cap doubled to 80 (the same real rows, twice the slots to stage);
- kernel 1 forces only and the v1 kernel on a cubic 62,500-particle fcc
  (a = 1.68, noise 0.05) in the per-slot layout (r_cut 2.5, skin 0.4,
  cap 40);
- kernel 1 forces only and with energy in Config 2's layout (per-slot
  se/hs, the epsilon table [[1, .6], [.6, 1]], FENE k 30 r0 1.5; r_cut
  2.5, skin 0.4, cap 40: 7^3 cells, Npad 13,720) on 512 chains of 16
  beads at the YAML's density (L 21.3) laid on a bcc lattice with noise
  0.05, each chain a row of 16 sites along x (no push-off needed);
- kernel 1 forces only on the triclinic start (chip_smoke.triclinic_pack:
  62,500 particles, tilt (0.2, -0.12, 0.1), layout (b), noise 0.05);
- kernels 2, 3 and 4 on Config 3's input (chip_smoke.config3_inputs, fcc
  plus noise 0.05, Q6 + coordination);
- kernels 2 and 3 on the triclinic start in the validity layout with Q6
  alone, the triclinic main path's CV;
- kernel 4 on the triclinic start in the sentinel layout (tilted) with Q6
  and coordination (r0 1.35 a / sqrt 2, r_cut 2.4), as chip_smoke.py's
  phase 16 holds it.

The order-CV kernels (2, 3, 4) are also timed on the device alone, under
the keys ending in ``_dev``: each call is queued behind a device sleep of
~1 ms, so that the host's launch is out of the span and the CUDA events
bracket only the kernel's own work (for kernels 2 and 4 the sweep and the
second pass).  Compare those only with each other.

Prints one line, ``AB {json}``, with the times in ms.

    python3 scripts/kernel_ab.py ROOT --bits OUT.npz
    python3 scripts/kernel_ab.py --compare A.npz B.npz

``--bits`` also saves every kernel's outputs: kernel 1's (forces; with
energy the energy and the virial too) on the liquid, the fcc, Config 2's
layout and the triclinic start, the v1 kernel's on the fcc, kernels 2 and
3's (value lanes, bias force) on the triclinic start and Config 3's
input, kernel 4's (LJ force, bias force, value lanes) on both; and
``--compare`` prints, per array of two such files, whether the two trees
gave the same bits and the largest difference: the check that a change to
the kernels left a launch's results as they were.
"""
import dataclasses
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def bcc_chains(cells: int = 16, L: float = 21.3, noise: float = 0.05):
    """2 cells^3 beads on a bcc lattice in a cubic box of side L, with
    Gaussian noise (numpy seed 5); chains are the rows of ``cells`` sites
    along x of one sublattice, diblock (the second half type 1).  Returns
    (pos, types, bonds, L)."""
    import numpy as np
    a = L / cells
    i, j, k = np.meshgrid(*[np.arange(cells)] * 3, indexing="ij")
    site = np.stack([i, j, k], axis=-1).astype(np.float64)
    pos = np.stack([site, site + 0.5], axis=0) * a - L / 2   # (2, x, y, z, 3)
    # particle id = ((sub * cells + y) * cells + z) * cells + x
    pos = pos.transpose(0, 2, 3, 1, 4).reshape(-1, 3)
    pos += np.random.default_rng(5).normal(0.0, noise, pos.shape)
    idx = np.arange(pos.shape[0]).reshape(-1, cells)
    bonds = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    types = (np.arange(pos.shape[0]) % cells >= cells // 2).astype(np.int32)
    return pos.astype(np.float32), types, bonds.astype(np.int32), L


def device_ms(fn, calls: int = 51, warm: int = 5) -> float:
    """Median device time of ``fn()`` in ms: each call is enqueued while the
    device sleeps (~2e6 cycles), between two CUDA events."""
    import statistics
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(root: pathlib.Path, bits=None) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from metadyn_tpu_torch import (
        Box, PackedCoordination, PackedEngine, PackedSpec, bond_partner_attrs,
        fcc_lattice, pair_scale_tables,
    )
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

    mod_spec = importlib.util.spec_from_file_location("ab_timing",
                                                      HERE / "chip_smoke.py")
    timing = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(timing)

    def ms(fn, calls=101):
        return timing.cuda_ms(fn, calls=calls, warm=5)

    saved = {}

    def keep(name, st, spec):
        """Kernel 1's outputs on ``st``, both modes, for ``--bits``."""
        for we in (False, True):
            o = packed_lj_force_cuda(st, spec, we)
            saved[f"{name}_e{int(we)}_f"] = o.f.cpu().numpy()
            if we:
                saved[f"{name}_pe"] = o.potential_energy.cpu().numpy()
                saved[f"{name}_virial"] = o.virial.cpu().numpy()

    def keep_out(name, value):
        """One kernel call's outputs (a state, a tensor, the value terms,
        or a tuple of them) for ``--bits``."""
        if hasattr(value, "f"):
            value = (value.f, value.potential_energy, value.virial)
        if isinstance(value, torch.Tensor):
            saved[name] = value.detach().cpu().numpy()
            return
        for i, v in enumerate(value):
            if isinstance(v, (list, tuple)):
                v = torch.cat([t.reshape(-1) for cv_t in v for t in cv_t])
            saved[f"{name}_{i}"] = v.detach().cpu().numpy()

    out = {"tree": str(root), "card": torch.cuda.get_device_name(0)}
    d = np.load(root / "bench_data" / "liq64k.npz")
    L = float(d["L"])
    spec = PackedSpec.create(L, d["pos"].shape[0], r_cut=2.5, skin=0.55,
                             cap=40, shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    st = pack(spec, d["pos"], L)
    keep("liq64k", st, spec)
    out["k1_liq64k"] = ms(lambda: packed_lj_force_cuda(st, spec, False))
    out["k1_liq64k_energy"] = ms(lambda: packed_lj_force_cuda(st, spec, True))
    # the same particles at twice the cap: a sweep that reads every slot
    # of the 27 cells pays for the vacant ones
    spec = dataclasses.replace(spec, cap=80)
    st = pack(spec, d["pos"], L)
    out["k1_liq64k_cap80"] = ms(lambda: packed_lj_force_cuda(st, spec, False))

    pos = fcc_lattice(25, 1.68)
    L = 25 * 1.68
    pos = (pos + np.random.default_rng(5).normal(0.0, 0.05, pos.shape)
           ).astype(np.float32)
    spec = PackedSpec.create(L, pos.shape[0], r_cut=2.5, skin=0.4, cap=40,
                             shift_energy=False)
    st = pack(spec, pos, L)
    keep("se_hs_fcc62k", st, spec)
    out["k1_se_hs_fcc62k"] = ms(lambda: packed_lj_force_cuda(st, spec, False))
    keep_out("v1_se_hs_fcc62k", packed_lj_force_v1_cuda(st, spec))
    out["v1_se_hs_fcc62k"] = ms(lambda: packed_lj_force_v1_cuda(st, spec))

    pos, types, bonds, L = bcc_chains()
    n = pos.shape[0]
    eps_scale, _, eps_diag, _ = pair_scale_tables([[1.0, 0.6], [0.6, 1.0]])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                             shift_energy=False, fene_k=30.0, fene_r0=1.5,
                             eps_scale=eps_scale)
    assert spec.n_pad == 13720, spec.n_pad
    st, ovf = PackedEngine(spec, dev).pack_state(
        pos, Box.cubic(L, dev), types, eps_diag[types],
        np.ones(n, np.float32), extra_attrs=bond_partner_attrs(bonds, n))
    assert not ovf
    keep("config2", st, spec)
    out["k1_config2"] = ms(lambda: packed_lj_force_cuda(st, spec, False))
    out["k1_config2_energy"] = ms(lambda: packed_lj_force_cuda(st, spec,
                                                               True))

    _, st, spec = cs.triclinic_pack(25, dev, noise=0.05)
    keep("se_hs_tilted62k", st, spec)
    out["k1_se_hs_tilted62k"] = ms(lambda: packed_lj_force_cuda(st, spec,
                                                                False))
    cvs = [cs.triclinic_cv(spec)]
    auxs = [cvs[0].grad_aux(order_values_plain(st, spec, cvs)[0],
                            torch.tensor(0.9, device=dev))]
    keep_out("values_tric_q6", [order_values_cuda(st, spec, cvs)])
    keep_out("force_tric_q6", order_force_cuda(st, spec, cvs, auxs))
    out["values_tric_q6"] = ms(lambda: order_values_cuda(st, spec, cvs), 51)
    out["force_tric_q6"] = ms(lambda: order_force_cuda(st, spec, cvs, auxs),
                              51)
    out["values_tric_q6_dev"] = device_ms(
        lambda: order_values_cuda(st, spec, cvs))
    out["force_tric_q6_dev"] = device_ms(
        lambda: order_force_cuda(st, spec, cvs, auxs))
    _, st, spec = cs.triclinic_pack(25, dev, sentinel=True, noise=0.05)
    cvs = [cs.triclinic_cv(spec),
           PackedCoordination(spec, r0=1.35 * cs.TRIC_A / np.sqrt(2),
                              r_cut=2.4, name="coord")]
    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in
            enumerate(zip(cvs, order_values_plain(st, spec, cvs)))]
    f, g, t = fused_lj_order_force_cuda(st, spec, cvs, auxs)
    keep_out("fused_tric", (f, g, t))
    out["fused_tric"] = ms(
        lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs), 51)
    out["fused_tric_dev"] = device_ms(
        lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs))

    pos, _, L, a, spec = cs.config3_inputs(32, noise=0.05)
    st = pack(spec, pos, L)
    cvs = cs.config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in
            enumerate(zip(cvs, order_values_plain(st, spec, cvs)))]
    keep_out("values_cfg3", [order_values_cuda(st, spec, cvs)])
    keep_out("force_cfg3", order_force_cuda(st, spec, cvs, auxs))
    f, g, t = fused_lj_order_force_cuda(st, spec, cvs, auxs)
    keep_out("fused_cfg3", (f, g, t))
    out["values_cfg3"] = ms(lambda: order_values_cuda(st, spec, cvs), 51)
    out["force_cfg3"] = ms(lambda: order_force_cuda(st, spec, cvs, auxs), 51)
    out["fused_cfg3"] = ms(
        lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs), 51)
    out["values_cfg3_dev"] = device_ms(lambda: order_values_cuda(st, spec, cvs))
    out["force_cfg3_dev"] = device_ms(
        lambda: order_force_cuda(st, spec, cvs, auxs))
    out["fused_cfg3_dev"] = device_ms(
        lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs))
    if bits:
        np.savez(bits, **saved)
    return out


def compare(a: str, b: str) -> dict:
    """Per array of two ``--bits`` files: [same bits, max |a - b|]."""
    import numpy as np
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files), (x.files, y.files)
        return {k: [bool(np.array_equal(x[k], y[k])),
                    float(np.abs(x[k].astype(np.float64) - y[k]).max())]
                for k in sorted(x.files)}


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        print("BITS " + json.dumps(compare(sys.argv[2], sys.argv[3])))
    else:
        bits = sys.argv[3] if sys.argv[2:3] == ["--bits"] else None
        print("AB " + json.dumps(main(pathlib.Path(sys.argv[1]).resolve(),
                                      bits)))
