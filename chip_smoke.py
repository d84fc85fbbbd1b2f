#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Four workloads, all at full size:

- the headline one (bench.py): the 62,500-particle LJ liquid
  (bench_data/liq64k.npz) on the packed cell engine (r_cut 2.5, skin 0.55,
  cap 40), BAOAB Langevin, two lamellar CVs on a 64x64 well-tempered grid
  bias with edge walls, one hill per 500-step stride;
- Config 3 (bench_config3.py): a 62,500-particle fcc start at rho 0.95 and
  kT 0.6 (r_cut 2.5, skin 0.3, cap 32), Steinhardt Q6 and coordination on a
  48x48 well-tempered grid with walls, one hill per 100-step stride,
  bias_every=10, with the lagged fused multiple-time-stepping path
  (mts_lag=True, the headline) and the exact one;
- Config 2 (examples/config2_diblock_sk.yaml): 512 diblock chains of 16
  beads (8192 beads, L = 21.3, rho 0.85), relaxed by the packed soft
  push-off (A = 100, FENE, r_cut 1, 2000 steps at dt 0.002, gamma 2), then
  LJ r_cut 2.5 with the per-type epsilon table [[1, .6], [.6, 1]] and FENE
  bonds (skin 0.4, cap 40: 343 cells, Npad 13,720), the S(k) mesh CV (32^3,
  k0 1.18, width 0.4) on an 81-point well-tempered grid over [0, 8000]
  with walls, bias_every=1, one hill per 100-step stride;
- the triclinic path (examples/triclinic_packed.yaml): fcc_lattice(25,
  1.68) (62,500 particles) in the cell tilted (0.2, -0.12, 0.1), the
  per-slot layout, LJ r_cut 2.5 (skin 0.4, cap 40: 14^3 cells), Q6 r_cut
  1.49 on a 64-point well-tempered grid, bias_every=1, one hill per 50-step
  stride; once more as the YAML writes it (4,000 particles).

Every kernel but v1 runs one block per cell over the real rows of its 27
neighbour cells, staged in shared memory
(metadyn_tpu_torch/csrc/cell_stage.cuh): the pair kernel, and the order-CV
values, force and fused LJ + CV kernels (csrc/order_cv.cuh).

Phases, one line or more each:

  1. device: the card, and nvidia-smi's name and power limit;
  2. build: every kernel from metadyn_tpu_torch/csrc with nvcc, all sources
     compiled at once (one nvcc each);
  3. pair kernel vs plain PyTorch pair force at the liquid's shapes, in both
     modes (forces only; with energy and virial), with times per call;
  4. the liquid slice for 20 steps at gamma = 0 on the kernel engine and on
     the plain-force engine, from one state: positions must agree;
  5. the liquid slice with bias_every=5: 1 warm stride, 4 timed strides;
  6. the strict liquid slice with bias_every=1: 1 warm stride, 2 timed;
  7. the order-CV libraries' build report (ptxas registers and spills);
  8. the order-CV kernels (values, force, fused LJ + CV) vs their plain
     versions at Config 3's shapes on fcc plus noise, with times per call,
     and vs their functions from the definition (every row of the 27 cells,
     no cut-off test before the CV math: order_values_stencil,
     order_force_stencil);
  9. the Config 3 slice (mts_lag) for 20 steps at gamma = 0 on the kernels
     and on the plain versions, from one state: positions must agree.  The
     plain path swaps the plain sweeps in where the port looks up the
     wrappers (cv/packed_order, sampler) and runs the plain-force engine;
 10. Config 3 with mts_lag: cap 32 (once more at cap 36 on overflow, as
     bench_config3 does), 2 + 2 warm strides, then 2 runs of 4 timed
     strides, with exact kernel launch counts per stride;
 11. Config 3 with exact multiple time stepping (mts_lag=False): 2 + 2
     warm strides (one is too few: from the fcc start the temperature is
     still ~0.48 after 200 steps), 2 timed strides, exact launch counts.
 12. the v1 pair kernel's build report (built in phase 2 with the others);
 13. the Config 2 push-off (soft pair on the plain sweep, timed on its own
     line), then on the relaxed melt: the pair kernel in each per-slot
     layout (Config 2's table + FENE; FENE with the WCA r_cut of
     examples/config2_diblock_sk.py; Config 5's se + uniform sigma + FENE;
     se/hs alone), forces only and with energy, and the v1 kernel, each
     against the plain pair force and v1 against the pair kernel, with
     times per call;
 14. the Config 2 slice for 20 steps at gamma = 0 on the kernel engine and
     on the plain-force engine, from one state: positions must agree;
 15. Config 2 timed: the production pack (no overflow, S(k0) inside the
     grid), 24 warm strides (the switch from the soft push-off to LJ
     heats the melt to T ~ 6, and T - 1 decays by ~0.77 per stride), then
     2 runs of 3 timed strides with exact launch counts;
 16. the triclinic kernels against their plain versions at 62,500 and
     4,000 particles: the pair kernel (b) and v1 on the tilted per-slot
     start, the values and force kernels in the validity layout with Q6 +
     coordination without a cut-off and with Q6 alone (the main path's
     CV), the fused kernel on the tilted sentinel start, each also against
     the stencil definitions;
 17. the triclinic slice (4,000) for 20 steps at gamma = 0 on the kernels
     and on the plain path, from one state;
 18. the triclinic slice timed at 62,500 particles (12 warm strides, 2
     runs of 3 timed strides, exact launch counts, one profiled stride)
     and at the YAML's 4,000.

After each timed run one more stride runs under torch.profiler, and a line
reports the GPU's busy share of it and the top kernels.  The launch counts
of each path are set to 0 just before its timed strides and read just
after: the pair kernel's from phases 5 and 15, the values and fused
kernels' from phase 10, the force kernel's from phase 11 (the lagged path
never runs it inside a stride); the v1 kernel has no production caller and
no main-path launches.

Then a JSON line describing each kernel: its time, its plain version's,
its launches on the main path, and its bound: the larger of the bytes it
must move (each input read once, each output written once) over the
card's memory rate and the floating-point operations the run's pairs need
over the card's FP32 rate (the operations per pair are counted from the
kernels' sources, see FLOP_PER_PAIR).  No single PyTorch call computes a
cell-list pair sweep, so every library_ms is null.  As the last line
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; without a CUDA device it exits 1 and prints no result.

Run from the repository root:  python3 chip_smoke.py
"""
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
STRIDE = 500
KT = 1.0
CFG3_STRIDE = 100
CFG3_KT = 0.6
CFG3_T_BAND = (0.5, 0.7)
CFG2_STRIDE = 100
CFG2_T_BAND = (0.9, 1.1)
CFG2_PUSHOFF_STEPS = 2000
CFG2_EPS_TABLE = [[1.0, 0.6], [0.6, 1.0]]
WCA_RC = 2.0 ** (1.0 / 6.0)
TRIC_STRIDE = 50
TRIC_KT = 0.7
TRIC_A = 1.68
TRIC_TILT = (0.2, -0.12, 0.1)
# from the plain path on the CPU at 4,000 particles (PERF.md §6): T dips
# to 0.44 in the first stride from the fcc start and T - 0.7 decays by
# ~0.8 per stride after it
TRIC_WARM = 12
TRIC_T_BAND = (0.6, 0.8)

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# FP32 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12     # FLOP/s
PEAK_BYTES = 3.35e12  # B/s
# Floating-point operations per unordered pair, counted from the kernels'
# sources (csrc/pair_terms.cuh, csrc/order_cv.cuh): an LJ pair forces only
# (difference, r^2, the power chain, coefficient, 3 accumulations) and
# with energy and virial; a FENE + WCA bond; a Q_6 bond (the Y_6m
# recurrence over m = 0..6; its bias force twice that); a coordination
# pair (the switching function; its force).  Estimates to within ~50%:
# the bound they give is a floor, not a prediction.
FLOP_PER_PAIR = {"lj": 24, "lj_energy": 37, "bond": 45, "q6_value": 150,
                 "q6_force": 300, "coord_value": 20, "coord_force": 30}


def cuda_ms(fn, calls: int = 25, warm: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``calls`` calls, from CUDA
    events around each call, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` and do ``flops`` FP32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pairs_within(state, spec, rc: float) -> int:
    """Unordered pairs of real slots closer than ``rc``, by a roll sweep
    over the 27 neighbour cells: the pair work these inputs need."""
    import torch
    from metadyn_tpu_torch.ops.packed import OFFSETS, _tables, shift_rows_cart
    cap, C = spec.cap, spec.n_cells
    dims = (2, 3, 4)
    x = state.r.reshape(3, cap, *spec.cells_per_dim)
    real = (state.pid < spec.n_real).reshape(cap, *spec.cells_per_dim)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    xi = state.r.reshape(3, 1, cap, C)
    real_i = real.reshape(1, cap, C)
    count = 0
    for oi, o in enumerate(OFFSETS):
        back = (-o[0], -o[1], -o[2])
        xj = torch.roll(x, back, dims).reshape(3, cap, C) + shifts[oi][:, None]
        rj = torch.roll(real, back, (1, 2, 3)).reshape(cap, 1, C)
        d = xi - xj[:, :, None, :]
        r2 = (d * d).sum(0)
        count += int(((r2 < rc * rc) & (r2 > 1e-12) & real_i & rj).sum())
    return count // 2


def pair_kernel_bytes(spec, with_energy: bool, v1: bool = False) -> int:
    """Bytes the pair kernels must move for ``spec``'s layout: the inputs
    the layout reads (positions; se, hs, types, pids and bond partners
    where used), each once, and the forces out."""
    per_slot = 12 + 12                                  # r in, f out
    per_slot += 4 * (v1 or spec.uniform_eps is None)    # se
    per_slot += 4 * (v1 or spec.uniform_sigma is None)  # hs
    per_slot += 4 * spec.has_pair_table                 # typ
    if spec.has_bonds:
        per_slot += 4 + 4 * spec.bond_slots             # pid, bp*
    return spec.n_pad * per_slot + (16 if with_energy else 0)


def pair_close(tag: str, a, b, with_energy: bool) -> tuple:
    """Hold a pair kernel's state ``a`` against the plain force's ``b``:
    max|df| <= 1e-4 max|f| + 1e-3, PE and virial rtol 1e-5.  Returns
    (max|df|, a report)."""
    import numpy as np
    df = float((a.f - b.f).abs().max())
    fmax = float(b.f.abs().max())
    assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (tag, df, fmax)
    line = f"max|df|/max|f|={df / fmax:.3e} (max|f|={fmax:.3e})"
    if with_energy:
        dpe = abs(float(a.potential_energy - b.potential_energy)) / abs(
            float(b.potential_energy))
        dw = float(((a.virial - b.virial).abs() / b.virial.abs()).max())
        assert dpe <= 1e-5 and dw <= 1e-5, (tag, dpe, dw)
        line += f" rel_dPE={dpe:.3e} rel_dvirial={dw:.3e}"
    return df, line


def pair_kernel_bound(spec, n_pairs: int, n_bonds: int, with_energy: bool,
                      v1: bool = False) -> tuple:
    flops = (n_pairs * FLOP_PER_PAIR["lj_energy" if with_energy else "lj"]
             + n_bonds * FLOP_PER_PAIR["bond"])
    return bound(pair_kernel_bytes(spec, with_energy, v1), flops)


def ptxas_lines(name: str) -> list:
    from metadyn_tpu_torch.ops import _build
    return [ln.strip() for ln in _build.log_path(name).read_text().splitlines()
            if "registers" in ln or "spill" in ln]


def build_all(names) -> dict:
    """Compile every library at once, one nvcc per source.  Returns the
    seconds each build took."""
    from metadyn_tpu_torch.ops import _build
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {n: pool.submit(_build.build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def config3_inputs(cap: int, noise: float = 0.0):
    """bench_config3.run_once's start on the port: (pos, vel, L, a, spec)."""
    import numpy as np
    from metadyn_tpu_torch import PackedSpec, fcc_lattice
    rho = 0.95
    a = (4.0 / rho) ** (1.0 / 3.0)
    pos = fcc_lattice(25, a)
    n = pos.shape[0]
    L = 25 * a
    rng = np.random.default_rng(0)
    vel = rng.normal(0.0, np.sqrt(CFG3_KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    if noise:
        pos = (pos + np.random.default_rng(5).normal(0.0, noise, pos.shape)
               ).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.3, cap=cap,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    return pos, vel, L, a, spec


def config3_cvs(spec, a):
    import numpy as np
    from metadyn_tpu_torch import PackedCoordination, PackedSteinhardtQl
    nn = a / np.sqrt(2)
    return [PackedSteinhardtQl(spec, r_cut=nn * 1.2, l=6, name="q6"),
            PackedCoordination(spec, r0=nn * 1.35, name="coord",
                               r_cut=nn * 1.35 * 1.5)]


def config3_sampler(engine_cls, dev, cap: int, mts_lag: bool,
                    gamma: float = 1.0, stride: int = CFG3_STRIDE):
    """The Config 3 sampler through the port's entry points, or None if the
    initial pack overflows ``cap``."""
    import numpy as np
    from metadyn_tpu_torch import (
        Box, GridSpec, HillSpec, MetadSampler, WallSpec, WELL_TEMPERED,
        make_packed_langevin_step, make_system,
    )
    pos, vel, L, a, spec = config3_inputs(cap)
    n = pos.shape[0]
    engine = engine_cls(spec, dev, rebuild_every=10)
    state, overflow = engine.pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel)
    if overflow:
        return None
    grid = GridSpec.create([0.0, 4.0], [0.7, 28.0], [48, 48], [0.015, 0.5],
                           dev)
    return MetadSampler(
        make_system(n, dev), state, engine, config3_cvs(spec, a), grid,
        HillSpec.create(W=0.4, stride=stride, mode=WELL_TEMPERED, deltaT=6.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=CFG3_KT,
                                            gamma=gamma),
        seed=0, chunks_per_block=2,
        walls=WallSpec.at_grid_edges(grid, k=200.0),
        bias_every=10, mts_lag=mts_lag)


def plain_force_engine():
    """PackedEngine with the plain PyTorch pair force in place of the kernel:
    the reference path of phases 4 and 9."""
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.ops.packed import packed_lj_force

    class PlainForceEngine(PackedEngine):
        def _pair_force(self, state, with_energy):
            return packed_lj_force(state, self.spec, with_energy=with_energy)

    return PlainForceEngine


def counters() -> dict:
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda
    return {"pair": packed_lj_force_cuda, "values": order_values_cuda,
            "force": order_force_cuda, "fused": fused_lj_order_force_cuda,
            "v1": packed_lj_force_v1_cuda}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


@contextlib.contextmanager
def plain_order_path():
    """The order-CV wrappers' plain versions, patched in where the port looks
    them up: the reference path of phase 9."""
    import metadyn_tpu_torch.cv.packed_order as po
    import metadyn_tpu_torch.sampler as sm
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_plain,
    )
    saved = (po.order_values_cuda, po.order_force_cuda,
             sm.fused_lj_order_force_cuda)
    po.order_values_cuda = po.order_values_plain
    po.order_force_cuda = po.order_force_plain
    sm.fused_lj_order_force_cuda = fused_lj_order_force_plain
    try:
        yield
    finally:
        (po.order_values_cuda, po.order_force_cuda,
         sm.fused_lj_order_force_cuda) = saved


def order_force_stencil(state, spec, cvs, auxs):
    """Kernel 3's function from its definition, an oracle that shares no
    pair test with the kernel or with order_force_plain (both keep only
    the pairs inside the CVs' largest cut-off): g_i = sum over the CVs
    and over the real rows j of all 27 neighbour cells (shifted by h u)
    with r^2 > 1e-12 of grad_cv(r_i - r_j), each CV's pair math on every
    stencil row, no Newton halving; 0 on vacant i.  Returns (3, Npad)."""
    import torch
    from metadyn_tpu_torch.ops.packed import OFFSETS, _tables, shift_rows_cart
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    real = state.pid < spec.n_real
    rows = torch.cat([state.r, real[None].to(torch.float32)]).reshape(
        4, cap, cx, cy, cz)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    xi = state.r.reshape(3, 1, cap, C)
    g = torch.zeros((3, cap, C), dtype=torch.float32, device=state.r.device)
    for oi, o in enumerate(OFFSETS):
        part = torch.roll(rows, shifts=(-o[0], -o[1], -o[2]),
                          dims=(2, 3, 4)).reshape(4, cap, C)
        xj = part[:3] + shifts[oi][:, None, :]
        d = xi - xj[:, :, None, :]                      # (3, j, i, C)
        r2 = (d * d).sum(dim=0)
        w = real.reshape(1, cap, C) & (part[3] > 0)[:, None, :] & (r2 > 1e-12)
        for cv, aux in zip(cvs, auxs):
            gc = torch.stack(cv.pair_grad_terms(d[0], d[1], d[2], r2, aux))
            g += torch.where(w, gc, 0.0).sum(dim=1)
    return g.reshape(3, -1)


def order_values_stencil(state, spec, cvs) -> tuple:
    """Kernel 2's function from its definition, an oracle that shares no
    pair test with the kernel or with order_values_plain (both keep only
    the pairs inside the CVs' largest cut-off): per CV the sums over the
    real i rows and the real rows j of all 27 neighbour cells (shifted by
    h u) with r^2 > 1e-12 of its value terms, each CV's pair math on every
    stencil row, each ordered pair once.  Returns per-CV ``terms``."""
    import torch
    from metadyn_tpu_torch.ops.packed import OFFSETS, _tables, shift_rows_cart
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    real = state.pid < spec.n_real
    rows = torch.cat([state.r, real[None].to(torch.float32)]).reshape(
        4, cap, cx, cy, cz)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    xi = state.r.reshape(3, 1, cap, C)
    sums = None
    for oi, o in enumerate(OFFSETS):
        part = torch.roll(rows, shifts=(-o[0], -o[1], -o[2]),
                          dims=(2, 3, 4)).reshape(4, cap, C)
        xj = part[:3] + shifts[oi][:, None, :]
        d = xi - xj[:, :, None, :]                      # (3, j, i, C)
        r2 = (d * d).sum(dim=0)
        w = (real.reshape(1, cap, C) & (part[3] > 0)[:, None, :]
             & (r2 > 1e-12)).to(torch.float32)
        flat = [torch.cat([t.reshape(-1) for t in
                           cv.pair_value_terms(d[0], d[1], d[2], r2, w)])
                for cv in cvs]
        sums = flat if sums is None else [a + b for a, b in zip(sums, flat)]
    return tuple(cv.terms_from_flat(t) for cv, t in zip(cvs, sums))


def values_vs_stencil(tag: str, terms, state, spec, cvs,
                      rtol: float = 2e-5) -> None:
    """Value lanes ``terms`` of kernel 2 or 4 against
    :func:`order_values_stencil`, max|dlane| <= rtol max|lane| within each
    CV."""
    import numpy as np
    import torch
    ref = order_values_stencil(state, spec, cvs)
    worst = 0.0
    for cv, t, r in zip(cvs, terms, ref):
        a = torch.cat([x.reshape(-1) for x in t])
        b = torch.cat([x.reshape(-1) for x in r])
        d = float((a - b).abs().max())
        scale = float(b.abs().max())
        assert np.isfinite(d) and scale > 0 and d <= rtol * scale, (
            tag, cv.name, d, scale)
        worst = max(worst, d)
    print(f"{tag} value lanes vs the full-stencil definition (no cut-off "
          f"test): max|dlane|={worst:.3e}")


def force_vs_stencil(tag: str, gk, state, spec, cvs, auxs) -> None:
    """A bias force ``gk`` of kernel 3 or 4 against
    :func:`order_force_stencil`, with the kernel-vs-plain tolerance (2e-3
    relative + 2e-4 max|g|)."""
    import numpy as np
    gs = order_force_stencil(state, spec, cvs, auxs)
    d = (gk - gs).abs()
    gmax = float(gs.abs().max())
    worst = float((d - 2e-3 * gs.abs()).max())
    assert np.isfinite(gmax) and gmax > 0 and worst <= 2e-4 * gmax, (
        tag, worst, gmax)
    print(f"{tag} bias force vs the full-stencil definition (no cut-off "
          f"test): max|dg|={float(d.max()):.3e} max|g|={gmax:.3e}")


def order_kernels_vs_plain(dev) -> dict:
    """Phase 8: each order-CV kernel against its plain version at Config 3's
    shapes (fcc plus noise 0.05, cap 32).  Returns per kernel (max abs
    error, kernel ms, plain ms)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import Box, PackedEngine
    from metadyn_tpu_torch.cv.packed_order import (
        order_force_plain, order_values_plain,
    )
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda, fused_lj_order_force_plain,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )

    pos, vel, L, a, spec = config3_inputs(32, noise=0.05)
    n = pos.shape[0]
    engine = PackedEngine(spec, dev, rebuild_every=10)
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel)
    assert not overflow, "cell capacity overflow at pack (phase 8)"
    assert (spec.cap, spec.n_pad) == (32, 87808), (spec.cap, spec.n_pad)
    cvs = config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    out = {}

    def lanes(terms):
        return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])

    def lanes_close(name, terms, ref, rtol):
        """max|Δlane| ≤ rtol·max|lane| within each CV's lanes."""
        for cv, t, r in zip(cvs, terms, ref):
            d = float((lanes([t]) - lanes([r])).abs().max())
            scale = float(lanes([r]).abs().max())
            assert np.isfinite(d) and d <= rtol * scale, (name, cv.name, d,
                                                          scale)

    # kernel 2: value terms and s
    tk = order_values_cuda(st, spec, cvs)
    tp = order_values_plain(st, spec, cvs)
    sk = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tk)])
    sp = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tp)])
    torch.cuda.synchronize()
    err = float((lanes(tk) - lanes(tp)).abs().max())
    ds = float(((sk - sp).abs() / sp.abs()).max())
    assert np.isfinite(err) and ds <= 2e-5, (ds, sk, sp)
    lanes_close("values", tk, tp, 2e-5)
    values_vs_stencil("config3 order_values", tk, st, spec, cvs)
    out["values"] = (err, cuda_ms(lambda: order_values_cuda(st, spec, cvs)),
                     cuda_ms(lambda: order_values_plain(st, spec, cvs)))
    print(f"order_values kernel_vs_plain: s={sk.tolist()} rel_ds={ds:.3e} "
          f"max|dlane|={err:.3e} kernel_ms={out['values'][1]:.4f} "
          f"plain_ms={out['values'][2]:.4f}")

    def force_close(name, a_, b_, rtol, atol_frac):
        d = (a_ - b_).abs()
        bmax = float(b_.abs().max())
        worst = float((d - rtol * b_.abs()).max())
        assert np.isfinite(bmax) and worst <= atol_frac * bmax, (name, worst,
                                                                  bmax)
        return float(d.max()), bmax

    # kernel 3: bias force
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in enumerate(zip(cvs, tp))]
    gk = order_force_cuda(st, spec, cvs, auxs)
    gp = order_force_plain(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    vac = st.pid >= spec.n_real
    assert torch.all(gk[:, vac] == 0.0)
    err, gmax = force_close("g", gk, gp, 2e-3, 2e-4)
    force_vs_stencil("config3 order_force", gk, st, spec, cvs, auxs)
    out["force"] = (err,
                    cuda_ms(lambda: order_force_cuda(st, spec, cvs, auxs)),
                    cuda_ms(lambda: order_force_plain(st, spec, cvs, auxs)))
    print(f"order_force kernel_vs_plain: max|dg|={err:.3e} max|g|={gmax:.3e} "
          f"kernel_ms={out['force'][1]:.4f} plain_ms={out['force'][2]:.4f}")

    # kernel 4: LJ force, bias force and fresh terms in one traversal
    fk, gk4, tk4 = fused_lj_order_force_cuda(st, spec, cvs, auxs)
    fp, gp4, tp4 = fused_lj_order_force_plain(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    assert torch.all(fk[:, vac] == 0.0) and torch.all(gk4[:, vac] == 0.0)
    ef, fmax = force_close("f_lj", fk, fp, 0.0, 1e-3)
    eg, _ = force_close("g", gk4, gp4, 2e-3, 2e-4)
    s4k = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tk4)])
    s4p = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tp4)])
    ds4 = float(((s4k - s4p).abs() / s4p.abs()).max())
    assert ds4 <= 2e-4, (ds4, s4k, s4p)
    lanes_close("fused values", tk4, tp4, 2e-4)
    values_vs_stencil("config3 fused_lj_order", tk4, st, spec, cvs, 2e-4)
    force_vs_stencil("config3 fused_lj_order", gk4, st, spec, cvs, auxs)
    el = float((lanes(tk4) - lanes(tp4)).abs().max())
    out["fused"] = (
        max(ef, eg, el),
        cuda_ms(lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs)),
        cuda_ms(lambda: fused_lj_order_force_plain(st, spec, cvs, auxs)))
    print(f"fused_lj_order kernel_vs_plain: max|df_lj|={ef:.3e} "
          f"(max|f_lj|={fmax:.3e}) max|dg|={eg:.3e} rel_ds={ds4:.3e} "
          f"max|dlane|={el:.3e} kernel_ms={out['fused'][1]:.4f} "
          f"plain_ms={out['fused'][2]:.4f}")

    # bounds: positions in (and forces out), the pairs inside each cut-off
    fp, n_pad = FLOP_PER_PAIR, spec.n_pad
    q6 = pairs_within(st, spec, cvs[0].r_cut)
    co = pairs_within(st, spec, cvs[1].r_cut)
    lj = pairs_within(st, spec, spec.r_cut)
    out["values"] += bound(12 * n_pad,
                           q6 * fp["q6_value"] + co * fp["coord_value"])
    out["force"] += bound(24 * n_pad,
                          q6 * fp["q6_force"] + co * fp["coord_force"])
    out["fused"] += bound(
        36 * n_pad, lj * fp["lj"] + q6 * (fp["q6_value"] + fp["q6_force"])
        + co * (fp["coord_value"] + fp["coord_force"]))
    print(f"order kernels' bounds: pairs q6={q6} coord={co} lj={lj}; "
          + " ".join(f"{k}={v[3]:.5f} ms ({v[4]})" for k, v in out.items()))
    return out


def config3_kernel_vs_plain(dev) -> None:
    """Phase 9: 20 steps of the lagged Config 3 slice at gamma = 0, kernels
    against plain versions, from one state."""
    import numpy as np
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.ops.packed import unpack_positions

    finals = []
    for plain in (False, True):
        reset_counts()
        with plain_order_path() if plain else contextlib.nullcontext():
            engine_cls = plain_force_engine() if plain else PackedEngine
            s = config3_sampler(engine_cls, dev, 32, mts_lag=True, gamma=0.0,
                                stride=20)
            assert s is not None, "cell capacity overflow at pack (phase 9)"
            m = s.run(20)[-1]
        counts = read_counts()
        if plain:
            assert not any(counts.values()), counts
        else:
            assert all(counts[k] > 0 for k in ("pair", "values", "fused")), \
                counts
        finals.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                       np.asarray(m["cv"])))
    L = float(s.state.box.L_host[0])
    dpos = finals[0][0] - finals[1][0]
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    dcv = float(np.abs(finals[0][1] - finals[1][1]).max())
    assert dpos <= 1e-3, dpos
    print(f"config3_kernel_vs_plain mts_lag gamma=0 20 steps: "
          f"max|dpos|={dpos:.3e} max|dcv|={dcv:.3e} "
          f"cv={finals[0][1].tolist()}")


def config3_timed(dev, mts_lag: bool, warm: tuple, n_runs: int, n_timed: int,
                  per_stride: dict, smi: str) -> dict:
    """Phases 10 and 11: Config 3 timed, with the physics checks and exact
    launch counts per stride.  Returns the launch counts of the last run."""
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.utils.profiling import device_profile
    import numpy as np
    import torch

    tag = f"config3 mts_lag={mts_lag}"
    for cap in (32, 36):
        s = config3_sampler(PackedEngine, dev, cap, mts_lag)
        if s is None:
            print(f"{tag}: cap {cap} overflows at pack")
            continue
        for w in warm:
            hist = s.run(CFG3_STRIDE * w)
        if any(bool(m["nlist_overflow"]) for m in hist):
            print(f"{tag}: cap {cap} overflowed in the warm strides")
            continue
        runs = []
        for _ in range(n_runs):
            hills0 = s.bias.n_hills
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            hist = s.run(CFG3_STRIDE * n_timed)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts()
            runs.append((dt, counts, hist, s.bias.n_hills - hills0))
        if any(bool(m["nlist_overflow"]) for r in runs for m in r[2]):
            print(f"{tag}: cap {cap} overflowed in the timed strides")
            continue
        break
    else:
        raise AssertionError(f"{tag}: overflow at cap 32 and at cap 36")
    retry = " (retry at cap 36 after overflow at cap 32)" if cap == 36 else ""
    n = s.engine.spec.n_real
    for dt, counts, hist, hills in runs:
        want = {k: n_timed * per_stride.get(k, 0) for k in counts}
        assert counts == want, (counts, want)
        assert hills == n_timed, hills
        for m in hist:
            for k in ("cv", "bias_V", "hill_height", "temperature",
                      "potential_energy"):
                assert np.all(np.isfinite(m[k])), (k, m)
            assert not m["cell_width_violation"], m
            assert CFG3_T_BAND[0] < float(m["temperature"]) < CFG3_T_BAND[1], m
            assert float(m["hill_height"]) > 0.0, m
        last = hist[-1]
        print(f"{tag}: cap {cap}{retry} {n_timed} strides {dt:.3f} s "
              f"{n * CFG3_STRIDE * n_timed / dt:.1f} particle-steps/s "
              f"T={float(last['temperature']):.4f} "
              f"PE/N={float(last['potential_energy']) / n:.4f} "
              f"cv={last['cv'].tolist()} "
              f"T_range=[{min(float(m['temperature']) for m in hist):.4f}, "
              f"{max(float(m['temperature']) for m in hist):.4f}] "
              f"launches={counts} on {smi}")
    prof = device_profile(lambda: s.run(CFG3_STRIDE))
    untraced_ms = 1e3 * min(r[0] for r in runs) / n_timed
    prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
    prof["tracing_overhead_ms"] = prof["wall_ms"] - untraced_ms
    print(f"profile {tag} one stride: {json.dumps(prof)} on {smi}")
    return runs[-1][1]


def config2_pushoff(dev, smi: str) -> dict:
    """The Config 2 start: examples/config2_diblock_sk.yaml's melt (512
    chains of 16, L = 21.3, numpy seed 0), relaxed by the JAX package's
    packed soft push-off (examples/config5_flux_1m.py): pair_kind soft with
    A = 100 through eps_i, FENE bonds, r_cut 1 and skin 1, cap from the
    measured occupancy (x1.4 + 6), rebuild every 5 steps, Langevin dt
    0.002 and gamma 2, CFG2_PUSHOFF_STEPS steps.  The soft pair has no
    kernel: this runs the plain roll sweep on the card."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        Box, PackedEngine, PackedSpec, bond_partner_attrs,
        make_packed_langevin_step, polymer_melt,
    )
    from metadyn_tpu_torch.ops.packed import unpack_positions

    n_chains, chain_len, L = 512, 16, 21.3
    pos, bonds = polymer_melt(n_chains, chain_len, L, seed=0)
    n = pos.shape[0]
    t = np.zeros((n_chains, chain_len), np.int32)
    t[:, chain_len // 2:] = 1
    types = t.reshape(-1)
    cpd = int(np.floor(L / 2.0))
    cell = np.floor((pos / L + 0.5) * cpd).astype(np.int64) % cpd
    occ0 = int(np.bincount((cell[:, 0] * cpd + cell[:, 1]) * cpd
                           + cell[:, 2]).max())
    spec = PackedSpec.create(L, n, r_cut=1.0, skin=1.0, cap=int(occ0 * 1.4) + 6,
                             pair_kind="soft", fene_k=30.0, fene_r0=1.5)
    engine = PackedEngine(spec, dev, rebuild_every=5)
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, dev), types, np.full(n, 100.0, np.float32),
        np.ones(n, np.float32), extra_attrs=bond_partner_attrs(bonds, n))
    assert not overflow, "cell capacity overflow at the push-off pack"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, aux = engine.init(st)
    step = make_packed_langevin_step(lambda s_: engine.force_into(s_, aux),
                                     dt=0.002, kT=1.0, gamma=2.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    for _ in range(CFG2_PUSHOFF_STEPS // 5):
        st, aux = engine.rebuild(st, aux)
        for _ in range(5):
            st = step(st, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert not bool(aux.overflow), "overflow during the push-off"
    relaxed = unpack_positions(st, spec).cpu().numpy()
    assert np.isfinite(relaxed).all()
    print(f"config2 push-off: {CFG2_PUSHOFF_STEPS} soft steps (plain sweep, "
          f"cap {spec.cap}, Npad {spec.n_pad}) {dt:.3f} s "
          f"{n * CFG2_PUSHOFF_STEPS / dt:.1f} particle-steps/s on {smi}")
    return {"pos": relaxed, "bonds": bonds, "types": types, "L": L, "n": n}


# the per-slot layouts of phase 13 on the Config 2 melt: name ->
# (PackedSpec.create keywords, per-type epsilon table or None)
CFG2_LAYOUTS = {
    # examples/config2_diblock_sk.yaml: the main path
    "se_hs_table_fene": (dict(r_cut=2.5, skin=0.4, cap=40,
                              shift_energy=False, fene_k=30.0,
                              fene_r0=1.5), CFG2_EPS_TABLE),
    # examples/config2_diblock_sk.py: WCA + FENE
    "se_hs_fene_wca": (dict(r_cut=WCA_RC, skin=0.5, cap=40, fene_k=30.0,
                            fene_r0=1.5), None),
    # examples/config5_flux_1m.py's production spec
    "se_usig_fene_wca": (dict(r_cut=WCA_RC, skin=0.5, cap=48, fene_k=30.0,
                              fene_r0=1.5, uniform_sigma=1.0), None),
    "se_hs": (dict(r_cut=2.5, skin=0.4, cap=40, shift_energy=False), None),
}


def config2_pack(melt: dict, dev, layout: str = "se_hs_table_fene",
                 engine_cls=None, cv=None):
    """(engine, state, spec) of a CFG2_LAYOUTS layout on the relaxed melt,
    velocities from numpy seed 2 (the YAML's seed), the mesh CV's
    coefficients (+1 A, -1 B) as a slot attr when ``cv`` is given."""
    import numpy as np
    from metadyn_tpu_torch import (
        Box, PackedEngine, PackedSpec, bond_partner_attrs, pair_scale_tables,
    )
    n, types = melt["n"], melt["types"]
    kw, table = CFG2_LAYOUTS[layout]
    eps_scale, eps_i = None, np.ones(n, np.float32)
    if table is not None:
        eps_scale, _, eps_diag, _ = pair_scale_tables(table)
        eps_i = eps_diag[types]
    spec = PackedSpec.create(melt["L"], n, eps_scale=eps_scale, **kw)
    engine = (engine_cls or PackedEngine)(spec, dev, rebuild_every=5)
    rng = np.random.default_rng(2)
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    extra = {}
    if spec.has_bonds:
        extra.update(bond_partner_attrs(melt["bonds"], n))
    if cv is not None:
        extra[cv.attr_name] = np.asarray([1.0, -1.0], np.float32)[types]
    state, overflow = engine.pack_state(
        melt["pos"], Box.cubic(melt["L"], dev), types, eps_i,
        np.ones(n, np.float32), vel=vel, extra_attrs=extra)
    assert not overflow, f"cell capacity overflow at pack ({layout})"
    return engine, state, spec


def config2_kernels_vs_plain(melt: dict, dev) -> dict:
    """Phase 13: the pair kernel in each per-slot layout and the v1 kernel
    against the plain pair force (and v1 against the pair kernel) on the
    relaxed Config 2 melt.  Returns per variant (max abs error, kernel ms,
    plain ms, bound ms, bound by)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda

    n_bonds = len(melt["bonds"])
    out = {}
    for layout in CFG2_LAYOUTS:
        _, st, spec = config2_pack(melt, dev, layout)
        pairs = pairs_within(st, spec, spec.r_cut)
        nb = n_bonds if spec.has_bonds else 0
        for we in (False, True):
            a = packed_lj_force_cuda(st, spec, with_energy=we)
            b = packed_lj_force(st, spec, with_energy=we)
            torch.cuda.synchronize()
            err, line = pair_close(layout, a, b, we)
            ms = cuda_ms(lambda: packed_lj_force_cuda(st, spec,
                                                      with_energy=we))
            plain = cuda_ms(lambda: packed_lj_force(st, spec,
                                                    with_energy=we),
                            calls=10)
            bms, by = pair_kernel_bound(spec, pairs, nb, we)
            out[f"{layout}{'+energy' if we else ''}"] = (err, ms, plain,
                                                         bms, by)
            print(f"config2 pair kernel {layout} with_energy={we} "
                  f"kernel_vs_plain: {line} kernel_ms={ms:.4f} "
                  f"plain_ms={plain:.4f} bound_ms={bms:.5f} ({by}; "
                  f"{pairs} pairs, {nb} bonds, Npad {spec.n_pad})")
        if spec.has_pair_table or spec.uniform_sigma is not None:
            continue
        v1 = packed_lj_force_v1_cuda(st, spec)
        plain = packed_lj_force(st, spec, with_energy=True)
        k1 = packed_lj_force_cuda(st, spec, with_energy=True)
        torch.cuda.synchronize()
        err, line = pair_close(f"v1 {layout}", v1, plain, True)
        err_k1, line_k1 = pair_close(f"v1 vs kernel 1 {layout}", v1, k1, True)
        ms = cuda_ms(lambda: packed_lj_force_v1_cuda(st, spec))
        plain_ms = cuda_ms(lambda: packed_lj_force(st, spec,
                                                   with_energy=True),
                           calls=10)
        bms, by = pair_kernel_bound(spec, pairs, nb, True, v1=True)
        out[f"v1 {layout}"] = (max(err, err_k1), ms, plain_ms, bms, by)
        print(f"config2 v1 kernel {layout}: vs plain {line}; vs pair kernel "
              f"{line_k1} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bms:.5f} ({by})")
    return out


def config2_sampler(melt: dict, dev, engine_cls=None, gamma: float = 1.0,
                    stride: int = CFG2_STRIDE):
    """The Config 2 sampler through the port's entry points (the YAML's
    engine, CV, bias and integrator; cli.py's start check: S(k0) inside the
    grid).  Returns (sampler, S(k0) at the start)."""
    from metadyn_tpu_torch import (
        GridSpec, HillSpec, MetadSampler, PackedMesh, WallSpec,
        WELL_TEMPERED, make_packed_langevin_step, make_system,
    )
    n, L = melt["n"], melt["L"]
    cv = PackedMesh.create((32, 32, 32), L, n_real=n, k0=1.18, width=0.4,
                           name="sk")
    engine, state, spec = config2_pack(melt, dev, engine_cls=engine_cls,
                                       cv=cv)
    system = make_system(n, dev, types=melt["types"], bonds=melt["bonds"])
    s0 = float(cv.value(state, system))
    assert 0.0 <= s0 <= 8000.0, f"S(k0) = {s0} outside the grid [0, 8000]"
    grid = GridSpec.create([0.0], [8000.0], [81], [100.0], dev)
    sampler = MetadSampler(
        system, state, engine, [cv], grid,
        HillSpec.create(W=0.3, stride=stride, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0,
                                            gamma=gamma),
        seed=2, chunks_per_block=4, bias_every=1,
        walls=WallSpec.at_grid_edges(grid, k=50.0))
    return sampler, s0


def triclinic_pack(n_cells: int, dev, engine_cls=None,
                   sentinel: bool = False, noise: float = 0.0):
    """examples/triclinic_packed.yaml's start on the port: fcc_lattice(
    n_cells, 1.68) in Box.triclinic(L, L, L, 0.2, -0.12, 0.1), all types 0,
    eps = sigma = 1, velocities from numpy seed 11 (the YAML's seed) at kT
    0.7; LJ r_cut 2.5 without shift, skin 0.4, cap 40, rebuild every 5
    steps.  ``sentinel`` packs the same start in the sentinel layout
    (uniform sigma = eps = 1), the fused kernel's; ``noise`` adds Gaussian
    displacements (numpy seed 5) for the kernel checks.  The cubic lattice
    is not periodic under the tilted cell: the start has close contacts
    across the z face, as the reference's has.  Returns (engine, state,
    spec)."""
    import numpy as np
    from metadyn_tpu_torch import Box, PackedEngine, PackedSpec, fcc_lattice
    pos = fcc_lattice(n_cells, TRIC_A)
    n = pos.shape[0]
    L = n_cells * TRIC_A
    rng = np.random.default_rng(11)
    vel = rng.normal(0.0, np.sqrt(TRIC_KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    if noise:
        pos = (pos + np.random.default_rng(5).normal(0.0, noise, pos.shape)
               ).astype(np.float32)
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40,
                             shift_energy=False, tilt=TRIC_TILT, **kw)
    engine = (engine_cls or PackedEngine)(spec, dev, rebuild_every=5)
    state, overflow = engine.pack_state(
        pos, Box.triclinic(L, L, L, dev, *TRIC_TILT), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not overflow, f"cell capacity overflow at pack (n_cells {n_cells})"
    return engine, state, spec


def triclinic_cv(spec):
    from metadyn_tpu_torch import PackedSteinhardtQl
    return PackedSteinhardtQl(spec, r_cut=1.49, l=6, name="q6")


def triclinic_sampler(n_cells: int, dev, engine_cls=None, gamma: float = 1.0,
                      stride: int = TRIC_STRIDE):
    """The triclinic sampler through the port's entry points (the YAML's
    engine, CV, bias and integrator, as metadyn_tpu/cli.py builds them, no
    hill file; cli.py's start check: Q6 within the grid's range +-5%).
    Returns (sampler, Q6 at the start)."""
    from metadyn_tpu_torch import (
        GridSpec, HillSpec, MetadSampler, WELL_TEMPERED,
        make_packed_langevin_step, make_system,
    )
    engine, state, spec = triclinic_pack(n_cells, dev, engine_cls)
    cv = triclinic_cv(spec)
    system = make_system(spec.n_real, dev)
    lo, hi = 0.0, 0.75
    s0 = float(cv.value(state, system))
    margin = 0.05 * (hi - lo)
    assert lo - margin <= s0 <= hi + margin, f"Q6 = {s0} outside the grid"
    grid = GridSpec.create([lo], [hi], [64], [0.02], dev)
    sampler = MetadSampler(
        system, state, engine, [cv], grid,
        HillSpec.create(W=0.3, stride=stride, mode=WELL_TEMPERED,
                        deltaT=4.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=TRIC_KT,
                                            gamma=gamma),
        seed=11, chunks_per_block=16, bias_every=1)
    return sampler, s0


def min_image_tilted(d, box):
    """Displacements (N, 3) (torch) to their minimum image in ``box``."""
    import torch
    from metadyn_tpu_torch.core.box import fractional, from_fractional
    f = fractional(d, box)
    return from_fractional(f - torch.round(f), box)


def triclinic_kernels_vs_plain(dev, n_cells: int) -> dict:
    """Phase 16 at one size: kernel 1 (b) and v1 on the tilted per-slot
    start, kernels 2 and 3 in the validity layout with Q6 and coordination
    without a cut-off (the pack leaves the vacant slots at 0, where a
    coordinate test would count them) and with Q6 alone (the main path's
    CV), kernel 4 on the tilted sentinel
    start; noise 0.05.  Returns per kernel (max abs error, kernel ms, plain
    ms, bound ms, bound by)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import PackedCoordination
    from metadyn_tpu_torch.cv.packed_order import (
        order_force_plain, order_values_plain,
    )
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda, fused_lj_order_force_plain,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda

    tag = f"triclinic N={4 * n_cells ** 3}"
    _, st, spec = triclinic_pack(n_cells, dev, noise=0.05)
    vac = st.pid >= spec.n_real
    assert bool((st.r[:, vac] == 0.0).all()), "vacant slots not at 0"
    fp, n_pad = FLOP_PER_PAIR, spec.n_pad
    lj_pairs = pairs_within(st, spec, spec.r_cut)
    out = {}

    for we in (False, True):
        a = packed_lj_force_cuda(st, spec, with_energy=we)
        b = packed_lj_force(st, spec, with_energy=we)
        torch.cuda.synchronize()
        assert torch.all(a.f[:, vac] == 0.0)
        err, line = pair_close("pair", a, b, we)
        ms = cuda_ms(lambda: packed_lj_force_cuda(st, spec, with_energy=we))
        plain = cuda_ms(lambda: packed_lj_force(st, spec, with_energy=we),
                        calls=10)
        bms, by = pair_kernel_bound(spec, lj_pairs, 0, we)
        out[f"pair{'+energy' if we else ''}"] = (err, ms, plain, bms, by)
        print(f"{tag} pair kernel se_hs tilted with_energy={we}: {line} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.5f} "
              f"({by}; {lj_pairs} pairs, Npad {n_pad})")

    v1 = packed_lj_force_v1_cuda(st, spec)
    k1 = packed_lj_force_cuda(st, spec, with_energy=True)
    b = packed_lj_force(st, spec, with_energy=True)
    torch.cuda.synchronize()
    err, line = pair_close("v1", v1, b, True)
    err_k1, line_k1 = pair_close("v1 vs kernel 1", v1, k1, True)
    ms = cuda_ms(lambda: packed_lj_force_v1_cuda(st, spec))
    plain = cuda_ms(lambda: packed_lj_force(st, spec, with_energy=True),
                    calls=10)
    bms, by = pair_kernel_bound(spec, lj_pairs, 0, True, v1=True)
    out["v1"] = (max(err, err_k1), ms, plain, bms, by)
    print(f"{tag} v1 kernel tilted: vs plain {line}; vs pair kernel "
          f"{line_k1} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.5f} ({by})")

    # kernels 2 and 3, validity layout: Q6 (the slice's) + coordination
    # without a cut-off (every partner of the stencil, vacant ones too)
    cvs = [triclinic_cv(spec),
           PackedCoordination(spec, r0=1.35 * TRIC_A / np.sqrt(2),
                              name="coord")]
    tk = order_values_cuda(st, spec, cvs)
    tp = order_values_plain(st, spec, cvs)
    sk = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tk)])
    sp = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tp)])
    torch.cuda.synchronize()
    ds = float(((sk - sp).abs() / sp.abs()).max())
    lk = torch.cat([t.reshape(-1) for c in tk for t in c])
    lp = torch.cat([t.reshape(-1) for c in tp for t in c])
    err = float((lk - lp).abs().max())
    assert np.isfinite(err) and ds <= 2e-5, (ds, sk, sp)
    values_vs_stencil(f"{tag} Q6 + coordination", tk, st, spec, cvs)
    ms = cuda_ms(lambda: order_values_cuda(st, spec, cvs))
    plain = cuda_ms(lambda: order_values_plain(st, spec, cvs), calls=10)
    q6 = pairs_within(st, spec, cvs[0].r_cut)
    all_pairs = pairs_within(st, spec, 1e3)
    bms, by = bound(16 * n_pad, q6 * fp["q6_value"]
                    + all_pairs * fp["coord_value"])
    out["values"] = (err, ms, plain, bms, by)
    print(f"{tag} order_values validity tilted: s={sk.tolist()} "
          f"rel_ds={ds:.3e} max|dlane|={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain:.4f} bound_ms={bms:.5f} ({by}; q6 pairs {q6}, "
          f"all stencil pairs {all_pairs})")

    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in enumerate(zip(cvs, tp))]
    gk = order_force_cuda(st, spec, cvs, auxs)
    gp = order_force_plain(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    assert torch.all(gk[:, vac] == 0.0)
    d = (gk - gp).abs()
    gmax = float(gp.abs().max())
    worst = float((d - 2e-3 * gp.abs()).max())
    assert np.isfinite(gmax) and worst <= 2e-4 * gmax, (worst, gmax)
    force_vs_stencil(f"{tag} Q6 + coordination", gk, st, spec, cvs, auxs)
    ms = cuda_ms(lambda: order_force_cuda(st, spec, cvs, auxs))
    plain = cuda_ms(lambda: order_force_plain(st, spec, cvs, auxs), calls=10)
    bms, by = bound(28 * n_pad, q6 * fp["q6_force"]
                    + all_pairs * fp["coord_force"])
    out["force"] = (float(d.max()), ms, plain, bms, by)
    print(f"{tag} order_force validity tilted: max|dg|={float(d.max()):.3e} "
          f"max|g|={gmax:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.5f} ({by})")

    # kernels 2 and 3 with the main path's CV alone (Q6)
    q6cv = cvs[:1]
    tq = order_values_plain(st, spec, q6cv)
    tkq = order_values_cuda(st, spec, q6cv)
    lk = torch.cat([t.reshape(-1) for t in tkq[0]])
    lp = torch.cat([t.reshape(-1) for t in tq[0]])
    err = float((lk - lp).abs().max())
    assert err <= 2e-5 * float(lp.abs().max()), (err, lp)
    values_vs_stencil(f"{tag} Q6 alone", tkq, st, spec, q6cv)
    ms = cuda_ms(lambda: order_values_cuda(st, spec, q6cv))
    plain = cuda_ms(lambda: order_values_plain(st, spec, q6cv), calls=10)
    bms, by = bound(16 * n_pad, q6 * fp["q6_value"])
    out["values_q6"] = (err, ms, plain, bms, by)
    qauxs = [q6cv[0].grad_aux(tq[0], dV[0])]
    gk = order_force_cuda(st, spec, q6cv, qauxs)
    gp = order_force_plain(st, spec, q6cv, qauxs)
    torch.cuda.synchronize()
    assert torch.all(gk[:, vac] == 0.0)
    d = (gk - gp).abs()
    gmax = float(gp.abs().max())
    worst = float((d - 2e-3 * gp.abs()).max())
    assert np.isfinite(gmax) and worst <= 2e-4 * gmax, (worst, gmax)
    force_vs_stencil(f"{tag} Q6 alone", gk, st, spec, q6cv, qauxs)
    ms = cuda_ms(lambda: order_force_cuda(st, spec, q6cv, qauxs))
    plain = cuda_ms(lambda: order_force_plain(st, spec, q6cv, qauxs),
                    calls=10)
    bms, by = bound(28 * n_pad, q6 * fp["q6_force"])
    out["force_q6"] = (float(d.max()), ms, plain, bms, by)
    print(f"{tag} Q6 alone (the main path's CV), validity tilted: values "
          f"max|dlane|={err:.3e} kernel_ms={out['values_q6'][1]:.4f} "
          f"plain_ms={out['values_q6'][2]:.4f} bound_ms="
          f"{out['values_q6'][3]:.5f}; force max|dg|={float(d.max()):.3e} "
          f"max|g|={gmax:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.5f} ({by})")

    # kernel 4: the sentinel layout on the tilted start
    _, sst, sspec = triclinic_pack(n_cells, dev, sentinel=True, noise=0.05)
    scvs = [triclinic_cv(sspec),
            PackedCoordination(sspec, r0=1.35 * TRIC_A / np.sqrt(2),
                               r_cut=2.4, name="coord")]
    stp = order_values_plain(sst, sspec, scvs)
    sauxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in enumerate(zip(scvs,
                                                                   stp))]
    fk, gk4, tk4 = fused_lj_order_force_cuda(sst, sspec, scvs, sauxs)
    fpl, gp4, tp4 = fused_lj_order_force_plain(sst, sspec, scvs, sauxs)
    torch.cuda.synchronize()
    svac = sst.pid >= sspec.n_real
    assert torch.all(fk[:, svac] == 0.0) and torch.all(gk4[:, svac] == 0.0)
    ef = float((fk - fpl).abs().max())
    fmax = float(fpl.abs().max())
    assert np.isfinite(ef) and ef <= 1e-3 * fmax, (ef, fmax)
    d4 = (gk4 - gp4).abs()
    worst = float((d4 - 2e-3 * gp4.abs()).max())
    assert worst <= 2e-4 * float(gp4.abs().max()), worst
    s4k = torch.stack([cv.finalize_value(t) for cv, t in zip(scvs, tk4)])
    s4p = torch.stack([cv.finalize_value(t) for cv, t in zip(scvs, tp4)])
    ds4 = float(((s4k - s4p).abs() / s4p.abs()).max())
    assert ds4 <= 2e-4, (ds4, s4k, s4p)
    values_vs_stencil(f"{tag} fused_lj_order", tk4, sst, sspec, scvs, 2e-4)
    force_vs_stencil(f"{tag} fused_lj_order", gk4, sst, sspec, scvs, sauxs)
    ms = cuda_ms(lambda: fused_lj_order_force_cuda(sst, sspec, scvs, sauxs))
    plain = cuda_ms(lambda: fused_lj_order_force_plain(sst, sspec, scvs,
                                                       sauxs), calls=10)
    sq6 = pairs_within(sst, sspec, scvs[0].r_cut)
    sco = pairs_within(sst, sspec, scvs[1].r_cut)
    slj = pairs_within(sst, sspec, sspec.r_cut)
    bms, by = bound(36 * sspec.n_pad, slj * fp["lj"]
                    + sq6 * (fp["q6_value"] + fp["q6_force"])
                    + sco * (fp["coord_value"] + fp["coord_force"]))
    out["fused"] = (max(ef, float(d4.max())), ms, plain, bms, by)
    print(f"{tag} fused_lj_order sentinel tilted: max|df_lj|={ef:.3e} "
          f"(max|f_lj|={fmax:.3e}) max|dg|={float(d4.max()):.3e} "
          f"rel_ds={ds4:.3e} kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.5f} ({by})")
    return out


def triclinic_kernel_vs_plain(dev) -> None:
    """Phase 17: 20 steps of the triclinic slice (4,000 particles) at
    gamma = 0, the kernel path against the plain path, from one state."""
    import numpy as np
    import torch
    from metadyn_tpu_torch.ops.packed import unpack_positions

    finals = []
    for plain in (False, True):
        reset_counts()
        with plain_order_path() if plain else contextlib.nullcontext():
            s, _ = triclinic_sampler(10, dev, plain_force_engine() if plain
                                     else None, gamma=0.0, stride=20)
            m = s.run(20)[-1]
        counts = read_counts()
        want = ({k: 0 for k in counts} if plain else
                {**{k: 0 for k in counts}, "pair": 23, "values": 23,
                 "force": 21})
        assert counts == want, (plain, counts)
        finals.append((unpack_positions(s.state, s.engine.spec),
                       float(np.asarray(m["cv"])[0]),
                       float(m["potential_energy"])))
    dpos = float(min_image_tilted(finals[0][0] - finals[1][0],
                                  s.state.box).abs().max())
    dq6 = abs(finals[0][1] - finals[1][1])
    assert dpos <= 1e-3 and dq6 <= 1e-4, (dpos, dq6)
    torch.cuda.synchronize()
    print(f"triclinic_kernel_vs_plain gamma=0 20 steps (N=4000): "
          f"max|dpos|={dpos:.3e} |dQ6|={dq6:.3e} "
          f"rel_dPE={abs(finals[0][2] - finals[1][2]) / abs(finals[1][2]):.3e}"
          f" Q6={finals[0][1]:.5f}")


def triclinic_timed(dev, smi: str, n_cells: int = 25, warm: int = TRIC_WARM,
                    n_runs: int = 2, n_timed: int = 3,
                    profile: bool = True) -> dict:
    """Phase 18: the triclinic slice timed, with the physics checks and
    exact launch counts per stride (bias_every 1: every step one pair
    force, one value sweep and one force sweep; the stride end one energy
    refresh and one value sweep for the CV).  Returns the last run's
    counts."""
    import numpy as np
    import torch
    from metadyn_tpu_torch.utils.profiling import device_profile

    s, s0 = triclinic_sampler(n_cells, dev)
    spec = s.engine.spec
    n = spec.n_real
    if n_cells == 25:
        assert (spec.cells_per_dim, spec.cap, spec.n_pad) == ((14, 14, 14),
                                                              40, 109760)
    hist = s.run(TRIC_STRIDE * warm)
    assert not any(bool(m["nlist_overflow"]) for m in hist), "warm overflow"
    print(f"triclinic N={n} warm: Q6 at the start {s0:.5f}; {warm} strides, "
          f"T by stride {[round(float(m['temperature']), 4) for m in hist]}")
    per_stride = {"pair": TRIC_STRIDE + 1, "values": TRIC_STRIDE + 1,
                  "force": TRIC_STRIDE}
    runs = []
    for _ in range(n_runs):
        hills0 = s.bias.n_hills
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        hist = s.run(TRIC_STRIDE * n_timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        assert counts == {**{k: 0 for k in counts},
                          **{k: n_timed * v for k, v in per_stride.items()}
                          }, counts
        assert s.bias.n_hills - hills0 == n_timed, s.bias.n_hills
        for m in hist:
            for k in ("cv", "bias_V", "hill_height", "temperature",
                      "potential_energy"):
                assert np.all(np.isfinite(m[k])), (k, m)
            assert not m["nlist_overflow"], m
            assert not m["cell_width_violation"], m
            assert TRIC_T_BAND[0] < float(m["temperature"]) < TRIC_T_BAND[1], m
            assert float(m["hill_height"]) > 0.0, m
        runs.append(dt)
        last = hist[-1]
        print(f"triclinic N={n}: {n_timed} strides {dt:.3f} s "
              f"{n * TRIC_STRIDE * n_timed / dt:.1f} particle-steps/s "
              f"T={float(last['temperature']):.4f} "
              f"PE/N={float(last['potential_energy']) / n:.4f} "
              f"Q6={float(last['cv'][0]):.5f} V={float(last['bias_V']):.4f} "
              f"T_range=[{min(float(m['temperature']) for m in hist):.4f}, "
              f"{max(float(m['temperature']) for m in hist):.4f}] "
              f"launches={counts} on {smi}")
    if profile:
        prof = device_profile(lambda: s.run(TRIC_STRIDE))
        untraced_ms = 1e3 * min(runs) / n_timed
        prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
        prof["tracing_overhead_ms"] = prof["wall_ms"] - untraced_ms
        print(f"profile triclinic N={n} one stride: {json.dumps(prof)} "
              f"on {smi}")
    return counts


def config2_kernel_vs_plain(melt: dict, dev) -> None:
    """Phase 14: 20 steps of the Config 2 slice at gamma = 0, the kernel
    engine against the plain-force engine, from one state."""
    import numpy as np
    from metadyn_tpu_torch.ops.packed import unpack_positions

    finals = []
    for plain in (False, True):
        reset_counts()
        s, _ = config2_sampler(melt, dev, plain_force_engine() if plain
                               else None, gamma=0.0, stride=20)
        m = s.run(20)[-1]
        counts = read_counts()
        assert counts["pair"] == (0 if plain else 21 + 2), counts
        finals.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                       float(np.asarray(m["cv"])[0]),
                       float(m["potential_energy"])))
    L = melt["L"]
    dpos = finals[0][0] - finals[1][0]
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    assert dpos <= 1e-3, dpos
    print(f"config2_kernel_vs_plain gamma=0 20 steps: max|dpos|={dpos:.3e} "
          f"rel_dcv={abs(finals[0][1] - finals[1][1]) / finals[1][1]:.3e} "
          f"rel_dPE={abs(finals[0][2] - finals[1][2]) / abs(finals[1][2]):.3e}"
          f" cv={finals[0][1]:.3f}")


def config2_timed(melt: dict, dev, smi: str, warm: int = 24,
                  n_runs: int = 2, n_timed: int = 3) -> int:
    """Phase 15: Config 2 timed, with the physics checks and exact launch
    counts per stride.  Returns the pair kernel's launches in the last
    run."""
    import numpy as np
    import torch
    from metadyn_tpu_torch.utils.profiling import device_profile

    s, s0 = config2_sampler(melt, dev)
    spec = s.engine.spec
    assert (spec.cells_per_dim, spec.cap, spec.n_pad) == ((7, 7, 7), 40,
                                                          13720)
    hist = s.run(CFG2_STRIDE * warm)
    assert not any(bool(m["nlist_overflow"]) for m in hist), "warm overflow"
    print(f"config2 warm: S(k0) at the start {s0:.3f}; {warm} strides, T by "
          f"stride {[round(float(m['temperature']), 4) for m in hist]}")
    n = spec.n_real
    runs = []
    for _ in range(n_runs):
        hills0 = s.bias.n_hills
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        hist = s.run(CFG2_STRIDE * n_timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        assert counts == {**{k: 0 for k in counts},
                          "pair": n_timed * (CFG2_STRIDE + 1)}, counts
        assert s.bias.n_hills - hills0 == n_timed, s.bias.n_hills
        for m in hist:
            for k in ("cv", "bias_V", "hill_height", "temperature",
                      "potential_energy"):
                assert np.all(np.isfinite(m[k])), (k, m)
            assert not m["nlist_overflow"], m
            assert not m["cell_width_violation"], m
            assert CFG2_T_BAND[0] < float(m["temperature"]) < CFG2_T_BAND[1], m
            assert float(m["hill_height"]) > 0.0, m
        runs.append(dt)
        last = hist[-1]
        print(f"config2: {n_timed} strides {dt:.3f} s "
              f"{n * CFG2_STRIDE * n_timed / dt:.1f} particle-steps/s "
              f"T={float(last['temperature']):.4f} "
              f"PE/N={float(last['potential_energy']) / n:.4f} "
              f"S(k0)={float(last['cv'][0]):.3f} "
              f"V={float(last['bias_V']):.4f} "
              f"T_range=[{min(float(m['temperature']) for m in hist):.4f}, "
              f"{max(float(m['temperature']) for m in hist):.4f}] "
              f"launches={counts} on {smi}")
    prof = device_profile(lambda: s.run(CFG2_STRIDE))
    untraced_ms = 1e3 * min(runs) / n_timed
    prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
    prof["tracing_overhead_ms"] = prof["wall_ms"] - untraced_ms
    print(f"profile config2 one stride: {json.dumps(prof)} on {smi}")
    return counts["pair"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from metadyn_tpu_torch import (
        Box, GridSpec, HillSpec, MetadSampler, PackedEngine, PackedLamellar,
        PackedSpec, WallSpec, WELL_TEMPERED, make_packed_langevin_step,
        make_system,
    )
    from metadyn_tpu_torch.ops import _build
    from metadyn_tpu_torch.ops import (
        packed_fused_cuda, packed_order_cuda, packed_v1_cuda,
    )
    from metadyn_tpu_torch.ops.packed import packed_lj_force, unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import KERNEL, packed_lj_force_cuda
    from metadyn_tpu_torch.utils.profiling import device_profile

    # 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"device: {kind} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi[0])

    # 2. build, every source at once
    order_libs = (packed_order_cuda.KERNEL, packed_fused_cuda.KERNEL)
    build_secs = build_all((KERNEL, packed_v1_cuda.KERNEL) + order_libs)
    print("\n".join(ptxas_lines(KERNEL)), file=sys.stderr)
    print(f"build: csrc/{KERNEL}.cu nvcc {' '.join(_build.NVCC_FLAGS[:2])} "
          f"{build_secs[KERNEL]:.2f} s")

    # the workload (bench.py build_sampler, on the port)
    d = np.load(ROOT / "bench_data" / "liq64k.npz")
    pos, vel, L = d["pos"], d["vel"], float(d["L"])
    n = pos.shape[0]
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004], dev)

    def build(engine_cls, bias_every, gamma=1.0, stride=STRIDE):
        engine = engine_cls(spec, dev, rebuild_every=10)
        cv1 = PackedLamellar.create([[0, 0, 3]], n, dev, name="a")
        cv2 = PackedLamellar.create([[0, 3, 0]], n, dev, name="b")
        amps = np.ones(n, np.float32)
        state, overflow = engine.pack_state(
            pos, Box.cubic(L, dev), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, np.float32), vel=vel,
            extra_attrs={cv1.attr_name: amps, cv2.attr_name: amps})
        assert not overflow, "cell capacity overflow at pack"
        sampler = MetadSampler(
            make_system(n, dev), state, engine, [cv1, cv2], gspec,
            HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT,
                                                gamma=gamma),
            seed=0, bias_every=bias_every, chunks_per_block=8,
            walls=WallSpec.at_grid_edges(gspec, k=2000.0))
        return sampler

    # 3. kernel vs plain at the workload's shapes
    st = build(PackedEngine, 5).state
    errs, times = {}, {}
    for we in (False, True):
        a = packed_lj_force_cuda(st, spec, with_energy=we)
        b = packed_lj_force(st, spec, with_energy=we)
        torch.cuda.synchronize()
        df = float((a.f - b.f).abs().max())
        fmax = float(b.f.abs().max())
        assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (we, df, fmax)
        errs[we] = df
        line = f"max|df|/max|f|={df / fmax:.3e} (max|df|={df:.3e})"
        if we:
            dpe = abs(float(a.potential_energy - b.potential_energy)) / abs(
                float(b.potential_energy))
            dw = float(((a.virial - b.virial).abs() / b.virial.abs()).max())
            assert dpe <= 1e-5 and dw <= 1e-5, (dpe, dw)
            line += f" rel_dPE={dpe:.3e} rel_dvirial={dw:.3e}"
        times[we] = (
            cuda_ms(lambda: packed_lj_force_cuda(st, spec, with_energy=we)),
            cuda_ms(lambda: packed_lj_force(st, spec, with_energy=we)))
        print(f"kernel_vs_plain with_energy={we}: {line} "
              f"kernel_ms={times[we][0]:.4f} plain_ms={times[we][1]:.4f}")
    liq_pairs = pairs_within(st, spec, spec.r_cut)
    liq_bound = pair_kernel_bound(spec, liq_pairs, 0, False)
    print(f"pair kernel bound (liquid, forces only): {liq_bound[0]:.5f} ms "
          f"({liq_bound[1]}; {liq_pairs} pairs within r_cut)")

    # 4. the slice at gamma = 0: kernel engine vs plain-force engine
    finals = []
    for cls in (PackedEngine, plain_force_engine()):
        s = build(cls, 5, gamma=0.0, stride=20)
        m = s.run(20)[-1]
        finals.append((unpack_positions(s.state, spec).cpu().numpy(),
                       float(m["potential_energy"])))
    dpos = finals[0][0] - finals[1][0]
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    dpe = abs(finals[0][1] - finals[1][1]) / abs(finals[1][1])
    assert dpos <= 1e-3, dpos
    print(f"slice_kernel_vs_plain gamma=0 20 steps: max|dpos|={dpos:.3e} "
          f"rel_dPE={dpe:.3e}")

    # 5./6. the slice, timed
    rates = {}
    for bias_every, n_timed in ((5, 4), (1, 2)):
        s = build(PackedEngine, bias_every)
        s.run(STRIDE)                                   # warm stride
        hills0 = s.bias.n_hills
        torch.cuda.synchronize()
        packed_lj_force_cuda.launches = 0
        t0 = time.perf_counter()
        hist = s.run(STRIDE * n_timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = packed_lj_force_cuda.launches
        assert launches == n_timed * (STRIDE + 1), launches
        for m in hist:
            for k in ("cv", "bias_V", "hill_height", "temperature",
                      "potential_energy"):
                assert np.all(np.isfinite(m[k])), (k, m)
            assert not m["nlist_overflow"], m
            assert not m["cell_width_violation"], m
            assert 0.9 < float(m["temperature"]) < 1.1, m
            assert float(m["hill_height"]) > 0.0, m
        assert s.bias.n_hills - hills0 == n_timed, s.bias.n_hills
        rates[bias_every] = (n * STRIDE * n_timed / dt, launches)
        last = hist[-1]
        print(f"slice bias_every={bias_every}: {n_timed} strides "
              f"{dt:.3f} s {rates[bias_every][0]:.1f} particle-steps/s "
              f"T={float(last['temperature']):.4f} "
              f"PE/N={float(last['potential_energy']) / n:.4f} "
              f"cv={last['cv'].tolist()} launches={launches} on {smi[0]}")
        prof = device_profile(lambda: s.run(STRIDE))
        # busy share against the untraced stride time: the profiler slows
        # the host, not the kernels
        untraced_ms = 1e3 * dt / n_timed
        prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
        prof["tracing_overhead_ms"] = prof["wall_ms"] - untraced_ms
        print(f"profile bias_every={bias_every} one stride: "
              f"{json.dumps(prof)} on {smi[0]}")

    # 7. the order-CV libraries (built in phase 2)
    for lib in order_libs:
        print("\n".join(ptxas_lines(lib)), file=sys.stderr)
        print(f"build: csrc/{lib}.cu nvcc {' '.join(_build.NVCC_FLAGS[:2])} "
              f"{build_secs[lib]:.2f} s; "
              + "; ".join(ptxas_lines(lib)[-4:]))

    # 8. order-CV kernels vs plain at Config 3's shapes
    order = order_kernels_vs_plain(dev)

    # 9. the Config 3 slice at gamma = 0: kernels vs plain versions
    config3_kernel_vs_plain(dev)

    # 10./11. Config 3 timed, lagged and exact
    lag_counts = config3_timed(
        dev, True, warm=(2, 2), n_runs=2, n_timed=4,
        per_stride={"pair": 91, "fused": 10, "values": 2}, smi=smi[0])
    exact_counts = config3_timed(
        dev, False, warm=(2, 2), n_runs=1, n_timed=2,
        per_stride={"pair": 101, "values": 12, "force": 10}, smi=smi[0])

    # 12. the v1 pair kernel (built in phase 2)
    v1_lib = packed_v1_cuda.KERNEL
    print("\n".join(ptxas_lines(v1_lib)), file=sys.stderr)
    print(f"build: csrc/{v1_lib}.cu nvcc {' '.join(_build.NVCC_FLAGS[:2])} "
          f"{build_secs[v1_lib]:.2f} s; " + "; ".join(ptxas_lines(v1_lib)[-6:]))

    # 13.-15. Config 2: the push-off, kernels vs plain, the slice, timed
    melt = config2_pushoff(dev, smi[0])
    cfg2 = config2_kernels_vs_plain(melt, dev)
    config2_kernel_vs_plain(melt, dev)
    cfg2_launches = config2_timed(melt, dev, smi[0])

    # 16.-18. the triclinic slice: the tilted and validity kernels against
    # their plain versions at both sizes, the slice against the plain path,
    # the slice timed at 62,500 particles and at the YAML's 4,000
    t16 = time.perf_counter()
    tric = {n_cells: triclinic_kernels_vs_plain(dev, n_cells)
            for n_cells in (25, 10)}
    triclinic_kernel_vs_plain(dev)
    tric_counts = triclinic_timed(dev, smi[0])
    triclinic_timed(dev, smi[0], n_cells=10, n_runs=1, profile=False)
    print(f"triclinic phases 16-18: {time.perf_counter() - t16:.1f} s")

    def entry(name, source, replaces, launches, nums, **extra):
        err, ms, plain_ms, bms, by = nums
        return {"name": name, "route": "cuda",
                "source": f"metadyn_tpu_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": None, **extra}

    variants = {
        "sentinel liq64k": (errs[False], *times[False], *liq_bound),
        **{f"{k} config2": v for k, v in cfg2.items()
           if not k.startswith("v1")},
        **{f"se_hs tilted{k[4:]} triclinic N={4 * c ** 3}": v
           for c, t in tric.items() for k, v in t.items()
           if k.startswith("pair")}}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")

    def tric_variants(kernel, layout):
        out = {f"{layout} tilted triclinic N={4 * c ** 3}":
               dict(zip(keys, t[kernel])) for c, t in tric.items()}
        if f"{kernel}_q6" in tric[25]:
            out.update({f"{layout} tilted Q6 alone (main path) triclinic "
                        f"N={4 * c ** 3}": dict(zip(keys, t[f"{kernel}_q6"]))
                        for c, t in tric.items()})
        return out

    staged = ("one block per cell over the 27 neighbour cells' real rows, "
              "staged and compacted in shared memory (csrc/cell_stage.cuh)")
    print(json.dumps({"kernels": [
        entry(KERNEL, KERNEL, "metadyn_tpu/ops/packed_pallas2.py:301",
              cfg2_launches, cfg2["se_hs_table_fene"], design=staged,
              launches_by_path={"liq64k bias_every=5": rates[5][1],
                                "config3 mts_lag": lag_counts["pair"],
                                "config2": cfg2_launches,
                                "triclinic": tric_counts["pair"]},
              variants={k: dict(zip(keys, v)) for k, v in variants.items()}),
        entry("packed_order_values", packed_order_cuda.KERNEL,
              "metadyn_tpu/ops/packed_order_pallas.py:257",
              lag_counts["values"], order["values"],
              design=staged + ", prefiltered to the CVs' reach, one hit "
              "queue across a warp's i rows, a partials row per cell",
              launches_by_path={"config3 mts_lag": lag_counts["values"],
                                "triclinic": tric_counts["values"]},
              variants=tric_variants("values", "validity")),
        entry("packed_order_force", packed_order_cuda.KERNEL,
              "metadyn_tpu/ops/packed_order_pallas.py:309",
              exact_counts["force"], order["force"],
              design=staged + ", prefiltered to the CVs' reach",
              launches_by_path={"config3 exact": exact_counts["force"],
                                "triclinic": tric_counts["force"]},
              variants=tric_variants("force", "validity")),
        entry(packed_fused_cuda.KERNEL, packed_fused_cuda.KERNEL,
              "metadyn_tpu/ops/packed_fused_pallas.py:296",
              lag_counts["fused"], order["fused"],
              design=staged + ", one staging prefiltered to the larger of "
              "the LJ and CV cut-offs for the LJ and the CV math",
              variants=tric_variants("fused", "sentinel")),
        entry(v1_lib, v1_lib, "metadyn_tpu/ops/packed_pallas.py:185", 0,
              cfg2["v1 se_hs_fene_wca"],
              variants={**{k: dict(zip(keys, v)) for k, v in cfg2.items()
                           if k.startswith("v1")},
                        **tric_variants("v1", "se_hs")}),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
