#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Five workloads, all at full size, then the example YAMLs through the
port's CLI (phase 22):

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
  stride; once more as the YAML writes it (4,000 particles);
- Config 5 (examples/config5_flux_1m.py): flux-tempered metadynamics on
  65,536 diblock chains of 16 beads (1,048,576 beads, L = 107.25, rho
  0.85; chain starts on a jittered grid, persistence 0.9), relaxed by the
  packed soft push-off (A = 100, FENE, r_cut 1, skin 1, 53^3 cells, cap 46:
  Npad 6,848,342; 1000 steps, then 500 at A = 1000, which the script
  lacks: without them the melt blows up at the switch, as phase 20
  shows), then WCA + FENE with a uniform sigma (skin 0.5, cap
  48: 66^3 cells, Npad 13,799,808, a repack check every step), the S(k)
  mesh CV (48^3, k0 = 2 pi 4 / L, width 0.3) and FluxTemperedSampler on
  a 101-point grid over [0, max(8 S(k0), 10)], stride 50, update_period
  4, bias_every 1.

Every kernel but v1 runs one block per cell over the real rows of its 27
neighbour cells, staged in shared memory
(metadyn_tpu_torch/csrc/cell_stage.cuh): the pair kernel, and the order-CV
values, force and fused LJ + CV kernels (csrc/order_cv.cuh).  The pair
kernel also runs the soft push-off pair (its soft layout), for which the
JAX package has no Pallas kernel.

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
 13. the Config 2 push-off (the pair kernel's soft layout, timed on its own
     line, exactly one launch per step), then on the relaxed melt: the
     pair kernel in each per-slot
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
     and at the YAML's 4,000;
 19. the pair kernel's soft layout (its build report, then against the
     plain sweep, forces only and with energy, with times per call and the
     bound) at Config 2's push-off start (8,192 beads) and at Config 5's
     (1,048,576 beads, Npad 6,848,342);
 20. Config 5's push-off witness at the JAX example's --chains 128
     (2,048 beads): after the script's push-off alone one production
     period blows up, after the second stage it stays in a T band; then
     Config 5 at 1,024 chains (16,384 beads, the same density), relaxed
     on the soft kernel: one update period (stride 10 x update_period 2)
     at gamma = 0 through FluxTemperedSampler on the kernel engine and on
     the plain-force engine, from one state: positions, the histograms
     the update consumes and V after it must agree;
 21. Config 5 at 1,048,576 beads: the push-off on the soft kernel (timed,
     peak memory), the production pack with the pair kernel against the
     plain force on it, one warm period and two timed ones (rate, exact
     launch counts: 51 per stride, T in a band, peak memory), one
     profiled period, and one more, whose bias update the round-trip
     gate's cap forces; the gate's bookkeeping over all five.
 22. the CLI (metadyn_tpu_torch.cli.CliRun, what ``python -m
     metadyn_tpu_torch.cli run`` runs): examples/config2_diblock_sk.yaml,
     config3_nucleation_2dcv.yaml, config5_flux.yaml and
     triclinic_packed.yaml read by the port's reader and run as written,
     at full size and n_steps (the melts with the build's push-off), only
     the output paths moved: exact launches of the build and the run, the
     hill file, grid dump and CSV log read back, T of the last stride in
     its band, wall seconds and the run's rate; the triclinic YAML's
     resume leg (K steps with a checkpoint, --resume for K more) against
     a straight 2K-step run, bit for bit; and the device-to-host copies of
     one report block of config3's CLI run against phase 10's directly
     built sampler over the same strides.
 23. Config 1 (examples/config1_lj_lamellar.yaml: 864 particles, the
     all-pairs engine with row_block 216, one lamellar CV by autograd,
     standard metadynamics, 500 steps of stride 25) through CliRun as
     written (only the output paths moved), then with integrator.kind
     nvt_nh and nvt_bdp: build and run wall seconds, particle-steps/s, 20
     hill records, T of the last stride in its band, V finite with max >
     0, the files read back, no packed kernel launched;
 24. the three engines against each other on liq64k's 62,500 particles:
     AllPairsEngine (row_block 1024), NeighborEngine (CellSpec.create(L,
     n, 2.5, skin=0.4)) and PackedEngine with the pair kernel in its
     sentinel layout (bench.py's spec) from the same positions (forces,
     PE, virial; the pair kernel's launches counted); the half-skin
     witness (particles past skin/2 after 5 and 10 steps); then
     MetadSampler on NeighborEngine with bench.py's CVs as particle-order
     LamellarOPs, its 64x64 well-tempered grid and walls, stride 500,
     bias_every 5, the list rebuilt every 5 steps: 1 warm and 2 timed
     strides (rate, peak memory, no overflow, no stale list, T in
     0.9-1.1) and one profiled stride;
 25. the double-well sampler of scripts/fes_oracle.py (one
     particle, ForceField(external=) by autograd through the sampler's
     callable adapter, AxisPosition, well-tempered): 200 strides of 50
     steps, ms per step, 200 hills and a finite bias.  The oracle proper
     (the FES within 0.1 kT) is that script, and the slow tests of
     tests/test_torch_fes_oracle.py.

After each timed run one more stride runs under torch.profiler, and a line
reports the GPU's busy share of it and the top kernels.  The launch counts
of each path are set to 0 just before its timed strides and read just
after: the pair kernel's from phases 5 and 15, the values and fused
kernels' from phase 10, the force kernel's from phase 11 (the lagged path
never runs it inside a stride), the soft layout's from the 1M push-off
(phase 21; it runs no launch inside a stride); the v1 kernel has no
production caller and no main-path launches.  Phase 24's cross-check
launches the pair kernel twice (the packed engine's init and its energy
refresh); phases 23 and 25 launch none (the particle-order path is plain
PyTorch, as the reference runs it as XLA).

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
import shutil
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
CFG5_CHAIN_LEN = 16
CFG5_STRIDE = 50
CFG5_PERIOD = 4
CFG5_PUSHOFF_STEPS = 1000
CFG5_PUSHOFF2_STEPS = 500
CFG5_PUSHOFF2_A = 1000.0
CFG5_TIMED_PERIODS = 2
# phase 20's push-off witness (config5_pushoff_witness): the JAX package's
# example blows up at --chains 128 (PERF.md §6, PR 7)
CFG5_WITNESS_CHAINS = 128
CFG5_BLOWUP_T = 100.0
CFG5_WITNESS_T_BAND = (0.5, 10.0)
# T over the two timed periods fell from 2.33 to 1.26 in the first 1M run
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §5): the switch from the push-off
# heats the melt to T ~4.5 and gamma 2 cools it by ~1/e per 250 steps
CFG5_T_BAND = (1.0, 3.0)

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
FLOP_PER_PAIR = {"lj": 24, "lj_energy": 37, "soft": 20, "soft_energy": 34,
                 "bond": 45, "q6_value": 150, "q6_force": 300,
                 "coord_value": 20, "coord_force": 30}


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
    kind = spec.pair_kind + ("_energy" if with_energy else "")
    flops = (n_pairs * FLOP_PER_PAIR[kind]
             + n_bonds * FLOP_PER_PAIR["bond"])
    return bound(pair_kernel_bytes(spec, with_energy, v1), flops)


def pair_kernel_vs_plain(label: str, key: str, st, spec, n_bonds: int,
                         calls: int = 25, plain_calls: int = 10,
                         plain_warm: int = 3) -> dict:
    """The pair kernel against the plain pair force on ``st``, forces only
    and with energy (pair_close), with times per call and the bound; one
    line each.  Returns {key, key + "+energy": (max abs error, kernel ms,
    plain ms, bound ms, bound by)}."""
    import torch
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

    pairs = pairs_within(st, spec, spec.r_cut)
    out = {}
    for we in (False, True):
        a = packed_lj_force_cuda(st, spec, with_energy=we)
        b = packed_lj_force(st, spec, with_energy=we)
        torch.cuda.synchronize()
        err, line = pair_close(f"{label} {key}", a, b, we)
        del a, b
        ms = cuda_ms(lambda: packed_lj_force_cuda(st, spec, with_energy=we),
                     calls=calls)
        plain = cuda_ms(lambda: packed_lj_force(st, spec, with_energy=we),
                        calls=plain_calls, warm=plain_warm)
        bms, by = pair_kernel_bound(spec, pairs, n_bonds, we)
        out[f"{key}{'+energy' if we else ''}"] = (err, ms, plain, bms, by)
        print(f"{label} {key} with_energy={we} kernel_vs_plain: {line} "
              f"kernel_ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.5f} "
              f"({by}; {pairs} pairs within r_cut, {n_bonds} bonds, cap "
              f"{spec.cap}, {spec.cells_per_dim[0]}^3 cells, Npad "
              f"{spec.n_pad})")
    torch.cuda.empty_cache()
    return out


def ptxas_lines(name: str, pattern: str = None) -> list:
    """ptxas's register and spill lines in library ``name``'s build log;
    with ``pattern``, only those of the entry functions whose mangled name
    matches it, each after that name."""
    import re
    from metadyn_tpu_torch.ops import _build
    out, fn = [], None
    for ln in _build.log_path(name).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        elif "registers" in ln or "spill" in ln:
            if pattern is None:
                out.append(ln.strip())
            elif fn and re.search(pattern, fn):
                out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    return out


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


def diblock_melt(n_chains: int, chain_len: int, L: float, **melt_kw) -> dict:
    """polymer_melt (numpy seed 0) with diblock types: the first half of
    every chain A (0), the rest B (1); and its bond-partner attrs."""
    import numpy as np
    from metadyn_tpu_torch import bond_partner_attrs, polymer_melt

    pos, bonds = polymer_melt(n_chains, chain_len, L, seed=0, **melt_kw)
    n = pos.shape[0]
    t = np.zeros((n_chains, chain_len), np.int32)
    t[:, chain_len // 2:] = 1
    return {"pos": pos, "bonds": bonds, "types": t.reshape(-1), "L": L,
            "n": n, "bp": bond_partner_attrs(bonds, n)}


def config5_pushoff(engine, st):
    """Config 5's push-off: examples/config5_flux_1m.py's 1000 soft steps
    at A = 100, then config5_second_stage.  The script's push-off alone
    leaves non-bonded contacts near r = 0.5, where the production WCA force
    (~2e5) blows the melt up within the first production steps at dt
    0.002: the JAX package's example does so at 2,048 beads (PERF.md §6),
    and phase 20 shows it on the port (config5_pushoff_witness).  Returns
    (state, aux); the engine launches the kernel CFG5_PUSHOFF_STEPS +
    CFG5_PUSHOFF2_STEPS + 2 times."""
    from metadyn_tpu_torch.core.pushoff import pushoff_run
    st, aux = pushoff_run(engine, st, CFG5_PUSHOFF_STEPS)
    assert not bool(aux.overflow), "overflow during the push-off"
    return config5_second_stage(engine, st)


def config5_second_stage(engine, st):
    """The push-off's second stage, which the script lacks:
    CFG5_PUSHOFF2_STEPS more soft steps at A = CFG5_PUSHOFF2_A (se scaled
    by sqrt(A / 100); seed 98).  Returns (state, aux)."""
    from metadyn_tpu_torch.core.pushoff import pushoff_run
    scale = (CFG5_PUSHOFF2_A / 100.0) ** 0.5
    st = st.replace(attrs={**st.attrs, "se": st.attrs["se"] * scale})
    return pushoff_run(engine, st, CFG5_PUSHOFF2_STEPS, seed=98)


def relaxed_of(st, spec) -> tuple:
    """(positions, velocities) by particle, numpy, checked finite."""
    import numpy as np
    from metadyn_tpu_torch.ops.packed import unpack_positions
    pos = unpack_positions(st, spec).cpu().numpy()
    vel = st.v[:, st.slot_of.long()].T.cpu().numpy()
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    return pos, vel


def config2_pushoff(dev, smi: str) -> dict:
    """Phase 13's start: examples/config2_diblock_sk.yaml's melt (512
    chains of 16, L = 21.3, numpy seed 0), relaxed by the packed soft
    push-off (pushoff_pack) for CFG2_PUSHOFF_STEPS steps on the pair
    kernel's soft layout: exactly one launch per step and one for the
    init."""
    from metadyn_tpu_torch.core.pushoff import pushoff_pack, pushoff_run
    import torch

    melt = diblock_melt(512, 16, 21.3)
    engine, st, spec = pushoff_pack(melt["pos"], melt["L"], melt["types"],
                                    melt["bp"], dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st, aux = pushoff_run(engine, st, CFG2_PUSHOFF_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {**{k: 0 for k in counts},
                      "pair": CFG2_PUSHOFF_STEPS + 1}, counts
    assert not bool(aux.overflow), "overflow during the push-off"
    relaxed, _ = relaxed_of(st, spec)
    n = melt["n"]
    print(f"config2 push-off: {CFG2_PUSHOFF_STEPS} soft steps (pair kernel, "
          f"soft layout; cap {spec.cap}, Npad {spec.n_pad}) {dt:.3f} s "
          f"{n * CFG2_PUSHOFF_STEPS / dt:.1f} particle-steps/s "
          f"launches={counts['pair']} on {smi}")
    return {**melt, "pos": relaxed}


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
        Box, PackedEngine, PackedSpec, pair_scale_tables,
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
        extra.update(melt["bp"])
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
    import torch
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda

    n_bonds = len(melt["bonds"])
    out = {}
    for layout in CFG2_LAYOUTS:
        _, st, spec = config2_pack(melt, dev, layout)
        nb = n_bonds if spec.has_bonds else 0
        out.update(pair_kernel_vs_plain("config2 pair kernel", layout, st,
                                        spec, nb))
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
        bms, by = pair_kernel_bound(spec, pairs_within(st, spec, spec.r_cut),
                                    nb, True, v1=True)
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


# lj_force_kernel<SeEps, HsSig, Table, Bond, Soft = true, WithEnergy>
SOFT_KERNELS = r"lj_force_kernelILb1ELb1ELb0ELi[01]ELb1E"


def soft_kernel_vs_plain(melt: dict, dev, tag: str, calls: int = 25,
                         plain_calls: int = 10, plain_warm: int = 3):
    """Phase 19: the pair kernel's soft layout against the plain sweep at a
    push-off start, forces only and with energy, with times per call and
    the bound.  Returns ((engine, state, spec), per mode (max abs error,
    kernel ms, plain ms, bound ms, bound by))."""
    from metadyn_tpu_torch.core.pushoff import pushoff_pack
    engine, st, spec = pushoff_pack(melt["pos"], melt["L"], melt["types"],
                                    melt["bp"], dev)
    out = pair_kernel_vs_plain("soft pair kernel", f"soft {tag}", st, spec,
                               len(melt["bonds"]), calls, plain_calls,
                               plain_warm)
    return (engine, st, spec), out


@contextlib.contextmanager
def recorded_updates():
    """Records the histograms each bias update of FluxTemperedSampler
    consumes (numpy, by interop.flux_state_arrays), by wrapping
    flux_sampler.update_bias where the sampler looks it up."""
    import metadyn_tpu_torch.flux_sampler as fs
    from metadyn_tpu_torch.interop import flux_state_arrays
    real, seen = fs.update_bias, []

    def update_bias(bias, flux, *args, **kw):
        seen.append(flux_state_arrays(flux))
        return real(bias, flux, *args, **kw)

    fs.update_bias = update_bias
    try:
        yield seen
    finally:
        fs.update_bias = real


def config5_melt(n_chains: int) -> dict:
    """examples/config5_flux_1m.py's melt: n_chains diblock chains of 16 at
    rho 0.85, chain starts on a jittered grid, persistence 0.9."""
    n = n_chains * CFG5_CHAIN_LEN
    L = float((n / 0.85) ** (1.0 / 3.0))
    return diblock_melt(n_chains, CFG5_CHAIN_LEN, L, grid_starts=True,
                        persistence=0.9)


def config5_sampler(melt: dict, pos, vel, dev, engine_cls=None,
                    gamma: float = 2.0, stride: int = CFG5_STRIDE,
                    update_period: int = CFG5_PERIOD, **kw):
    """examples/config5_flux_1m.py's production phase on the port: WCA
    (r_cut 2^(1/6), uniform sigma 1) + FENE, skin 0.5, cap 48, a repack
    check every step; PackedMesh 48^3 with k0 = 2 pi 4 / L, width 0.3, the
    mesh coefficients +1 (A) and -1 (B); FluxTemperedSampler on [0, hi],
    hi = max(8 S(k0), 10), 101 points, sigma hi/40, kT 1, BAOAB dt 0.002,
    seed 0, bias_every 1.  Returns (sampler, S(k0) at the start, hi)."""
    import numpy as np
    from metadyn_tpu_torch import (
        Box, FluxTemperedSampler, GridSpec, PackedEngine, PackedMesh,
        PackedSpec, make_packed_langevin_step, make_system,
    )
    n, L, types = melt["n"], melt["L"], melt["types"]
    spec = PackedSpec.create(L, n, r_cut=WCA_RC, skin=0.5, cap=48,
                             fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    engine = (engine_cls or PackedEngine)(spec, dev)
    cv = PackedMesh.create((48, 48, 48), L, n_real=n,
                           k0=2 * np.pi * 4 / L, width=0.3, name="dsa")
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, dev), types, np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={**melt["bp"], cv.attr_name: np.asarray(
            [1.0, -1.0], np.float32)[types]})
    assert not overflow, "cell capacity overflow at the production pack"
    system = make_system(n, dev, types=types, bonds=melt["bonds"])
    s0 = float(cv.value(st, system))
    hi = max(8.0 * s0, 10.0)
    assert 0.0 <= s0 <= hi, f"S(k0) = {s0} outside the grid [0, {hi}]"
    sampler = FluxTemperedSampler(
        system, st, engine, [cv],
        GridSpec.create([0.0], [hi], [101], [hi / 40], dev),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0,
                                            gamma=gamma),
        kT=1.0, stride=stride, update_period=update_period, seed=0,
        bias_every=1, **kw)
    return sampler, s0, hi


def closest_nonbonded(melt: dict, pos) -> float:
    """The smallest minimum-image distance between two beads that share no
    bond (numpy, all pairs: for a few thousand beads)."""
    import numpy as np
    n, L = melt["n"], melt["L"]
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r2 = (d * d).sum(axis=-1)
    r2[np.arange(n), np.arange(n)] = np.inf
    a, b = np.asarray(melt["bonds"]).T
    r2[a, b] = r2[b, a] = np.inf
    return float(np.sqrt(r2.min()))


def config5_pushoff_witness(dev, smi: str) -> None:
    """Phase 20's first part: why config5_pushoff adds a second stage to
    examples/config5_flux_1m.py's push-off.  At the size where the JAX
    package's example shows the blow-up (--chains 128: 2,048 beads, L
    13.4, the same melt), after the script's push-off alone and after the
    second stage as well: the closest non-bonded pair, then one production
    period (stride 50 x update_period 4, 200 steps, gamma 2, as the script
    runs it; the plain-force engine) with T by stride.  The first must blow
    up (T above CFG5_BLOWUP_T, or not finite), the second stay inside
    CFG5_WITNESS_T_BAND."""
    from metadyn_tpu_torch.core.pushoff import pushoff_pack, pushoff_run
    import numpy as np

    melt = config5_melt(CFG5_WITNESS_CHAINS)
    engine, st, spec = pushoff_pack(melt["pos"], melt["L"], melt["types"],
                                    melt["bp"], dev)
    st, aux = pushoff_run(engine, st, CFG5_PUSHOFF_STEPS)
    assert not bool(aux.overflow), "overflow during the push-off"
    stage1 = relaxed_of(st, spec)
    st, aux = config5_second_stage(engine, st)
    assert not bool(aux.overflow), "overflow during the push-off"
    stage2 = relaxed_of(st, spec)
    out = {}
    for tag, (pos, vel) in (("script", stage1), ("two_stage", stage2)):
        s, _, _ = config5_sampler(melt, pos, vel, dev, plain_force_engine())
        (m,) = s.run(CFG5_STRIDE * CFG5_PERIOD)
        out[tag] = (closest_nonbonded(melt, pos),
                    [float(t) for t in m["temperature"]])
    print(f"config5 push-off witness N={melt['n']} (plain-force production, "
          f"200 steps): " + "; ".join(
              f"{tag}: closest non-bonded r={r:.4f}, T by stride {T}"
              for tag, (r, T) in out.items()) + f" on {smi}")
    T1, T2 = np.asarray(out["script"][1]), np.asarray(out["two_stage"][1])
    assert not np.all(np.isfinite(T1)) or T1.max() > CFG5_BLOWUP_T, out
    assert np.all((CFG5_WITNESS_T_BAND[0] < T2)
                  & (T2 < CFG5_WITNESS_T_BAND[1])), out


def config5_kernel_vs_plain(dev) -> None:
    """Phase 20: Config 5 at 1,024 chains of 16 (16,384 beads, the same
    density), relaxed by the push-off on the soft kernel; one update
    period at stride 10 x update_period 2 (the ungated cadence, so the
    period ends in an update) at gamma = 0 through FluxTemperedSampler,
    on the kernel engine and on the plain-force engine, from one state:
    positions by particle, the histograms the update consumes, V after it,
    and the per-stride metrics."""
    from metadyn_tpu_torch.core.pushoff import pushoff_pack
    import numpy as np
    import torch
    from metadyn_tpu_torch.ops.packed import unpack_positions

    melt = config5_melt(1024)
    engine, st, spec = pushoff_pack(melt["pos"], melt["L"], melt["types"],
                                    melt["bp"], dev)
    st, aux = config5_pushoff(engine, st)
    assert not bool(aux.overflow), "overflow during the push-off"
    pos, vel = relaxed_of(st, spec)
    runs = []
    for plain in (False, True):
        reset_counts()
        s, s0, hi = config5_sampler(
            melt, pos, vel, dev, plain_force_engine() if plain else None,
            gamma=0.0, stride=10, update_period=2, min_round_trips=0)
        with recorded_updates() as seen:
            (m,) = s.run(20)
        torch.cuda.synchronize()
        counts = read_counts()
        # kernel path: init and the prime, then 10 steps and a refresh per
        # stride
        assert counts["pair"] == (0 if plain else 2 + 2 * 11), counts
        assert len(seen) == 1 and s.n_updates == 1 and m["update_applied"]
        assert not np.any(m["nlist_overflow"]), m
        runs.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                     seen[0], s.bias.grid.V.cpu().numpy(), m))
    (pk, hk, Vk, mk), (pp, hp, Vp, mp) = runs
    L = melt["L"]
    dpos = pk - pp
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    assert dpos <= 1e-3, dpos
    for k in ("hist", "flux_up", "flux_down", "prev_bin"):
        np.testing.assert_array_equal(hk[k], hp[k], err_msg=k)
    assert np.isfinite(Vk).all()
    np.testing.assert_allclose(Vk, Vp, rtol=1e-4, atol=1e-4)
    for k in ("cv", "temperature", "potential_energy"):
        np.testing.assert_allclose(mk[k], mp[k], rtol=1e-4, err_msg=k)
    print(f"config5_kernel_vs_plain gamma=0 N={melt['n']} 20 steps: "
          f"max|dpos|={dpos:.3e} hist equal ({int(hk['hist'].sum())} "
          f"visits, {int(hk['flux_up'].sum())} up, "
          f"{int(hk['flux_down'].sum())} down) "
          f"max|dV|={float(np.abs(Vk - Vp).max()):.3e} "
          f"S(k0)={[round(float(x), 4) for x in np.ravel(mk['cv'])]} "
          f"grid [0, {hi:.3f}]")


# (beads, cells per side, cap, Npad) of the 1M push-off and production
CFG5_SIZES = ((1048576, 53, 46, 6848342), (1048576, 66, 48, 13799808))


def config5_1m(soft: tuple, melt: dict, dev, smi: str,
               sizes=CFG5_SIZES) -> dict:
    """Phase 21: Config 5 at 1,048,576 beads.  The push-off from phase 19's
    start on the soft kernel (timed, peak memory); the production pack
    with kernel 1 against the plain force on it; one warm period and two
    timed ones with exact launch counts and the physics checks; one
    profiled period; one more that ends in the first bias update; the
    gate's bookkeeping over all of them.  Returns the numbers for the
    kernels line."""
    import numpy as np
    import torch
    from metadyn_tpu_torch.utils.profiling import device_profile

    engine, st, spec = soft
    n = melt["n"]
    assert (n, spec.cells_per_dim[0], spec.cap, spec.n_pad) == sizes[0], (
        n, spec)
    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st, aux = config5_pushoff(engine, st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    push_peak = torch.cuda.max_memory_allocated() / gib
    steps = CFG5_PUSHOFF_STEPS + CFG5_PUSHOFF2_STEPS
    assert counts == {**{k: 0 for k in counts}, "pair": steps + 2}, counts
    assert not bool(aux.overflow), "overflow during the push-off"
    pos, vel = relaxed_of(st, spec)
    push_launches = counts["pair"]
    print(f"config5 push-off N={n}: {CFG5_PUSHOFF_STEPS} soft steps at A "
          f"100 and {CFG5_PUSHOFF2_STEPS} at A {CFG5_PUSHOFF2_A:g} (pair "
          f"kernel, soft layout; cap {spec.cap}, Npad {spec.n_pad}) "
          f"{dt:.3f} s {n * steps / dt:.1f} particle-steps/s "
          f"peak_mem={push_peak:.3f} GiB launches={push_launches} on {smi}")
    del engine, st, aux
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    s, s0, hi = config5_sampler(melt, pos, vel, dev)
    pspec = s.engine.spec
    assert (n, pspec.cells_per_dim[0], pspec.cap, pspec.n_pad) == sizes[1], (
        pspec)
    # kernel 1 against the plain force on the production start
    prod = pair_kernel_vs_plain(
        "config5 pair kernel", f"se_usig_fene_wca config5 N={n}", s.state,
        pspec, len(melt["bonds"]), plain_calls=2, plain_warm=1)

    stride, period = s.stride, s.update_period
    per_period = stride * period
    warm = s.run(per_period)
    temps = [round(float(t), 4) for m in warm for t in m["temperature"]]
    print(f"config5 N={n} warm: S(k0) at the start {s0:.4f}, grid [0, "
          f"{hi:.4f}]; 1 period, T by stride {temps}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    timed = s.run(CFG5_TIMED_PERIODS * per_period)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    steps = CFG5_TIMED_PERIODS * per_period
    temps = [round(float(t), 4) for m in timed for t in m["temperature"]]
    last = timed[-1]
    print(f"config5 N={n}: {CFG5_TIMED_PERIODS} periods ({steps} steps) "
          f"{dt:.3f} s {n * steps / dt:.1f} particle-steps/s "
          f"T by stride {temps} "
          f"PE/N={float(last['potential_energy'][-1]) / n:.4f} "
          f"S(k0)={float(last['cv'][-1][0]):.4f} "
          f"round_trips={[m['round_trips'] for m in timed]} "
          f"update_applied={[m['update_applied'] for m in timed]} "
          f"n_updates={s.n_updates} launches={counts} on {smi}")
    assert counts == {**{k: 0 for k in counts},
                      "pair": CFG5_TIMED_PERIODS * period
                      * (stride + 1)}, counts
    prof = device_profile(lambda: s.run(per_period))
    untraced_ms = 1e3 * dt / CFG5_TIMED_PERIODS
    prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
    prof["tracing_overhead_ms"] = prof["wall_ms"] - untraced_ms
    prof["busy_ms_per_stride"] = prof["busy_ms"] / period
    prod_peak = torch.cuda.max_memory_allocated() / gib
    print(f"profile config5 N={n} one period ({period} strides): "
          f"{json.dumps(prof)} peak_mem_production={prod_peak:.3f} GiB "
          f"on {smi}")
    # one more period: with no round trip the gate's cap
    # (max_defer_periods 4) forces the first bias update here
    (last,) = s.run(per_period)
    V = s.bias.grid.V.cpu().numpy()
    print(f"config5 N={n} period {len(s.history)}: round_trips="
          f"{last['round_trips']} update_applied={last['update_applied']} "
          f"n_updates={s.n_updates} V in [{V.min():.4f}, {V.max():.4f}]")
    assert last["update_applied"] and s.n_updates >= 1, last
    assert np.isfinite(V).all() and np.abs(V).max() > 0.0
    hist = s.history
    for m in hist:
        for k in ("cv", "temperature", "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert not np.any(m["nlist_overflow"]), m
        assert not np.any(m["cell_width_violation"]), m
        if not m["update_applied"]:
            assert m["round_trips"] < 1.0, m
    for m in timed:
        t = np.asarray(m["temperature"])
        assert np.all((CFG5_T_BAND[0] < t) & (t < CFG5_T_BAND[1])), t
    assert s.n_updates == sum(bool(m["update_applied"]) for m in hist)
    assert len(hist) == 3 + CFG5_TIMED_PERIODS
    return {"push_launches": push_launches, "launches": counts["pair"],
            "variants": prod}


# Phase 22: the packed example YAMLs through the port's CLI, as written
# (only the output paths move).  Per YAML: the T band of the last stride
# (PERF.md §2: the direct paths' bands; config5_flux.yaml's melt thermalizes
# as config2's), and the exact kernel launches of the build (the production
# engine's init and first biased force; the start-in-grid check's CV
# values; config3's lag seed) and per stride of the run, derived as phases
# 10, 15 and 18 derive theirs.  A melt's build also runs its push-off on
# the pair kernel's soft layout, counted by the same counter: its init and
# one launch per step.
CLI_YAMLS = {
    "config2_diblock_sk": dict(
        band=CFG2_T_BAND, build={"pair": 2}, per_stride={"pair": 101}),
    "config3_nucleation_2dcv": dict(
        band=CFG3_T_BAND, build={"pair": 2, "values": 2 + 2, "force": 2},
        per_stride={"pair": 91, "fused": 10, "values": 2}),
    "config5_flux": dict(
        band=CFG2_T_BAND, build={"pair": 2}, per_stride={"pair": 51}),
    "triclinic_packed": dict(
        band=TRIC_T_BAND, build={"pair": 2, "values": 2, "force": 1},
        per_stride={"pair": 51, "values": 51, "force": 50}),
}
# A YAML whose pack overflows its cap as written (the reference's CLI
# refuses it too) runs once more at this cap, as phase 10 retries Config 3
# at cap 36: config5_flux.yaml's cap 40 leaves 22% over the mean of 32.8
# beads per cell, and over init seeds 0-7 the post-push-off maxima are
# 39-43 in both packages, over 40 in 3 of 8 seeds in the JAX package's CLI
# and 4 of 8 in the port, the YAML's own seed among the port's
# (scripts/pushoff_occupancy.py; ROADMAP.md §3).
CLI_RETRY_CAP = 48
# the metric keys of a metadynamics run, the CSV log's columns (one per
# element: cv_0, ...)
METAD_KEYS = ("bias_V", "cell_width_violation", "cv", "cv_out_of_grid",
              "hill_height", "nlist_overflow", "nlist_stale",
              "potential_energy", "step", "temperature")


def cli_yaml(name: str, out_dir: pathlib.Path, **output) -> dict:
    """examples/<name>.yaml read by the port's reader, its output paths moved
    into ``out_dir`` and ``output`` added."""
    from metadyn_tpu_torch.io.config import load_config
    cfg = load_config(ROOT / "examples" / f"{name}.yaml")
    out = cfg.setdefault("output", {})
    out.update(output)
    for k in ("hill_file", "log_file", "grid_file", "checkpoint"):
        if k in out:
            out[k] = str(out_dir / pathlib.Path(out[k]).name)
    return cfg


def cli_checks(name: str, cfg: dict, runner) -> list:
    """What one CLI run wrote, read back with the port's readers: the hill
    file's rows and columns, the grid dump, the CSV log's columns with no
    overflow, T of the last stride in the band.  Returns the failures."""
    import numpy as np
    from metadyn_tpu_torch.io.grid_file import load_grid
    from metadyn_tpu_torch.io.hill_log import read_hills
    from metadyn_tpu_torch.io.metrics import read_csv

    bad = []
    out, mcfg = cfg["output"], cfg["metadynamics"]
    n_steps = int(cfg["run"]["n_steps"])
    flux = mcfg.get("mode") == "flux_tempered"
    n_hills = 0 if flux else n_steps // int(mcfg["stride"])
    if "hill_file" in out:
        h = read_hills(out["hill_file"])
        d = len(cfg["cvs"])
        if h["step"].shape[0] != n_hills or h["center"].shape != (n_hills, d):
            bad.append(f"hill file: {h['step'].shape[0]} rows, centres "
                       f"{h['center'].shape}, want {n_hills} x {d}")
        if h["cv_names"] != [f"cv_{c['name']}" for c in cfg["cvs"]]:
            bad.append(f"hill file columns {h['cv_names']}")
    if "grid_file" in out:
        bias, meta = load_grid(out["grid_file"])
        mode = mcfg.get("mode", "standard")
        if meta["mode"] != mode or (not flux and bias.n_hills != n_hills):
            bad.append(f"grid dump: {meta}, {bias.n_hills} hills")
        if not np.isfinite(bias.grid.V.numpy()).all():
            bad.append("grid dump: V not finite")
    hist = runner.sampler.history
    if "log_file" in out:
        log = read_csv(out["log_file"])
        over = [v for k, v in log.items() if k.startswith("nlist_overflow")]
        if not all((v == 0).all() for v in over) or not over:
            bad.append("log: nlist_overflow set")
        if len(next(iter(log.values()))) != len(hist):
            bad.append(f"log: {len(next(iter(log.values())))} rows for "
                       f"{len(hist)} metric rows")
        if not flux:
            want = sorted(
                k if np.ndim(hist[0][k]) == 0 else f"{k}_{i}"
                for k in METAD_KEYS
                for i in range(max(1, np.size(hist[0][k]))))
            if sorted(log) != want:
                bad.append(f"log columns {sorted(log)}")
    temps = np.concatenate([np.atleast_1d(m["temperature"]) for m in hist])
    band = CLI_YAMLS[name]["band"]
    if not (np.isfinite(temps).all() and band[0] < temps[-1] < band[1]):
        bad.append(f"T of the last stride {temps[-1]:.4f} outside {band}")
    return bad


def cli_yamls(dev, smi: str) -> dict:
    """Phase 22: the four packed example YAMLs through
    metadyn_tpu_torch.cli.CliRun on the card, at full size and full n_steps
    (config2_diblock_sk, config3_nucleation_2dcv and config5_flux with the
    build's push-off, triclinic_packed), then the triclinic resume leg and
    the device-to-host transfers per report block of config3's CLI run
    against phase 10's directly built sampler.  Every check of the phase is
    gathered and the phase fails at its end, after printing them all.
    Returns {yaml: (build counts, run counts)}."""
    import tempfile
    import numpy as np
    import torch
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.cli import CliRun
    from metadyn_tpu_torch.utils.profiling import device_profile

    t22 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    bad, counts, runners = [], {}, {}
    for name, want in CLI_YAMLS.items():
        d = tmp / name
        d.mkdir()
        cfg = cli_yaml(name, d)
        retry = ""
        for cap in (cfg["engine"].get("cap"), CLI_RETRY_CAP):
            cfg["engine"]["cap"] = cap
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            try:
                runner = CliRun(cfg, device=dev)
            except RuntimeError as e:
                # the reference refuses a pack overflow too; the cap is
                # the example's, its margin the push-off's draw
                if "overflow at pack" not in str(e) or cap == CLI_RETRY_CAP:
                    raise
                retry = (f" (as written, cap {cap}: refused, '{e}'; run at "
                         f"cap {CLI_RETRY_CAP})")
                print(f"cli {name}: as written, cap {cap}: {e}; retry at "
                      f"cap {CLI_RETRY_CAP}")
                continue
            break
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        st = runner.sampler.state
        spec = runner.sampler.engine.spec
        occ = int((st.pid < spec.n_real).reshape(spec.cap, spec.n_cells)
                  .sum(0).max())
        build_counts = read_counts()
        reset_counts()
        t1 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t1
        run_counts = read_counts()
        n = runner.sampler.engine.spec.n_real
        n_steps = runner.n_steps
        mcfg = cfg["metadynamics"]
        strides = n_steps // int(mcfg["stride"])
        want_build = {k: want["build"].get(k, 0) for k in build_counts}
        pushoff = int(cfg["system"]["init"].get("prerelax_steps", 0))
        if pushoff:
            want_build["pair"] += pushoff + 1
        want_run = {k: strides * want["per_stride"].get(k, 0)
                    for k in run_counts}
        if build_counts != want_build:
            bad.append(f"{name}: build launches {build_counts}, want "
                       f"{want_build}")
        if run_counts != want_run:
            bad.append(f"{name}: run launches {run_counts}, want {want_run}")
        bad += [f"{name}: {b}" for b in cli_checks(name, cfg, runner)]
        counts[name] = (build_counts, run_counts)
        runners[name] = runner
        last = runner.sampler.history[-1]
        t_last = float(np.atleast_1d(last["temperature"])[-1])
        print(f"cli {name}: N={n}{retry} cap {spec.cap} (the pack's "
              f"largest cell {occ}) build {t_build:.3f} s (push-off "
              f"{pushoff} steps)"
              f" run {n_steps} steps {t_run:.3f} s wall "
              f"{t_build + t_run:.3f} s {n * n_steps / t_run:.1f} "
              f"particle-steps/s T_last={t_last:.4f} "
              f"build_launches={build_counts} run_launches={run_counts} "
              f"on {smi}")

    # the resume leg: K steps with a checkpoint, --resume for K more,
    # against one straight run of 2K steps
    name = "triclinic_packed"
    legs = {}
    for leg in ("resumed", "straight"):
        d = tmp / f"resume_{leg}"
        d.mkdir()
        cfg = cli_yaml(name, d, checkpoint="ck.npz", grid_file="grid.npz")
        k = int(cfg["run"]["n_steps"])
        if leg == "straight":
            cfg["run"]["n_steps"] = 2 * k
            CliRun(cfg, device=dev).run()
        else:
            CliRun(cfg, device=dev).run()
            CliRun(cfg, resume=True, device=dev).run()
        legs[leg] = cfg["output"]
    from metadyn_tpu_torch.io.grid_file import load_grid
    same_hills = (open(legs["resumed"]["hill_file"], "rb").read()
                  == open(legs["straight"]["hill_file"], "rb").read())
    va = load_grid(legs["resumed"]["grid_file"])[0].grid.V
    vb = load_grid(legs["straight"]["grid_file"])[0].grid.V
    dv = float((va - vb).abs().max())
    if not (same_hills and torch.equal(va, vb)):
        bad.append(f"resume leg: hill files equal {same_hills}, "
                   f"max|dV| {dv:.3e}")
    print(f"cli {name} resume leg: {k} + {k} steps (--resume) against "
          f"{2 * k} straight: hill files equal={same_hills} grid V "
          f"bitwise equal={torch.equal(va, vb)} max|dV|={dv:.3e}")

    # device-to-host transfers per report block: config3's CLI run against
    # phase 10's directly built sampler, over the same strides
    r3 = runners["config3_nucleation_2dcv"]
    block = r3.report
    direct = (config3_sampler(PackedEngine, dev, 32, True)
              or config3_sampler(PackedEngine, dev, 36, True))
    direct.run(CFG3_STRIDE)
    p_cli = device_profile(lambda: r3.advance(block))
    p_dir = device_profile(lambda: direct.run(block))
    n_blocks = -(-block // CFG3_STRIDE // r3.sampler._block)
    if p_cli["d2h_count"] > p_dir["d2h_count"] + n_blocks:
        bad.append(f"config3 CLI d2h {p_cli['d2h_count']} > direct "
                   f"{p_dir['d2h_count']} + {n_blocks}")
    print(f"cli config3 d2h per report block ({block} steps, "
          f"{block // CFG3_STRIDE} strides, chunks_per_block "
          f"{r3.sampler._block}): cli {p_cli['d2h_count']} direct "
          f"(phase 10's sampler, chunks_per_block 2) {p_dir['d2h_count']}; "
          f"busy_ms cli {p_cli['busy_ms']:.1f} direct "
          f"{p_dir['busy_ms']:.1f}; wall_ms cli {p_cli['wall_ms']:.1f} "
          f"direct {p_dir['wall_ms']:.1f} on {smi}")
    print(f"cli phase 22: {time.perf_counter() - t22:.1f} s")
    shutil.rmtree(tmp, ignore_errors=True)
    for b in bad:
        print(f"cli FAILED: {b}", file=sys.stderr)
    assert not bad, bad
    return counts


# Phase 23: Config 1 (examples/config1_lj_lamellar.yaml) through the CLI:
# T of the last stride (kT 1.5; from the fcc start at kT 1.5 the liquid
# warms to ~1.35-1.45 by step 500: the JAX package's CLI on the CPU gave
# 1.350, the port on the CPU 1.39-1.44 over seeds 1-4)
CFG1_T_BAND = (1.3, 1.7)
CFG1_KINDS = ("langevin", "nvt_nh", "nvt_bdp")


def config1_cli(dev, smi: str) -> dict:
    """Phase 23: examples/config1_lj_lamellar.yaml through
    metadyn_tpu_torch.cli.CliRun on the card, as written (only the output
    paths moved: 864 particles, all-pairs, row_block 216, 500 steps,
    stride 25), then with integrator.kind nvt_nh and nvt_bdp.  Per run:
    build and run wall seconds and particle-steps/s; 20 hill records, T of
    the last stride in its band, V finite with max > 0, the hill file, CSV
    log and grid dump read back; no packed kernel launched.  Returns
    {kind: rate}."""
    import tempfile
    import numpy as np
    import torch
    from metadyn_tpu_torch.cli import CliRun
    from metadyn_tpu_torch.io.grid_file import load_grid
    from metadyn_tpu_torch.io.hill_log import read_hills
    from metadyn_tpu_torch.io.metrics import read_csv

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_cfg1_"))
    bad, rates = [], {}
    for kind in CFG1_KINDS:
        d = tmp / kind
        d.mkdir()
        cfg = cli_yaml("config1_lj_lamellar", d)
        cfg["integrator"]["kind"] = kind
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        runner = CliRun(cfg, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        t1 = time.perf_counter()
        runner.run()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t1
        n = runner.sampler.state.n
        n_steps = runner.n_steps
        n_hills = n_steps // int(cfg["metadynamics"]["stride"])
        out = cfg["output"]
        h = read_hills(out["hill_file"])
        bias, meta = load_grid(out["grid_file"])
        V = bias.grid.V.numpy()
        log = read_csv(out["log_file"])
        hist = runner.sampler.history
        t_last = float(hist[-1]["temperature"])
        if h["step"].shape[0] != n_hills or bias.n_hills != n_hills:
            bad.append(f"{kind}: {h['step'].shape[0]} hill rows, grid "
                       f"{bias.n_hills} hills, want {n_hills}")
        if not (np.isfinite(V).all() and V.max() > 0.0):
            bad.append(f"{kind}: V finite {np.isfinite(V).all()}, max "
                       f"{V.max()}")
        if len(log["step"]) != len(hist) or log["nlist_overflow"].any():
            bad.append(f"{kind}: log rows {len(log['step'])} for "
                       f"{len(hist)} strides, overflow "
                       f"{log['nlist_overflow'].any()}")
        if not CFG1_T_BAND[0] < t_last < CFG1_T_BAND[1]:
            bad.append(f"{kind}: T of the last stride {t_last:.4f} outside "
                       f"{CFG1_T_BAND}")
        if any(read_counts().values()):
            bad.append(f"{kind}: packed kernels launched {read_counts()}")
        rates[kind] = n * n_steps / t_run
        print(f"config1 cli {kind}: N={n} build {t_build:.3f} s run "
              f"{n_steps} steps {t_run:.3f} s {rates[kind]:.1f} "
              f"particle-steps/s {1e3 * t_run / n_steps:.3f} ms/step "
              f"T_last={t_last:.4f} hills={h['step'].shape[0]} "
              f"V_max={V.max():.4f} mode={meta['mode']} on {smi}")
    shutil.rmtree(tmp, ignore_errors=True)
    for b in bad:
        print(f"config1 FAILED: {b}", file=sys.stderr)
    assert not bad, bad
    return rates


# Phase 24's neighbour-list sampler rebuilds its list every 5 steps: at
# liq64k (T 1, dt 0.005) a 10-step block moves ~40 particles past skin/2 =
# 0.2 (the witness line of each run; the first run, NVIDIA H100 80GB HBM3,
# 700 W: 43, max 0.2295), and at skin 0.55 the trigger still fired by the
# second stride, so some steps of those blocks ran on a stale list
NB_REBUILD = 5


def pid_order_forces(state):
    """(n, 3) forces of a packed state, by particle id."""
    return state.f[:, state.slot_of.long()].T


def engines_cross_check(dev, smi: str) -> dict:
    """Phase 24: the three engines on liq64k's 62,500 particles
    (bench_data/liq64k.npz): AllPairsEngine (row_block 1024),
    NeighborEngine (CellSpec.create(L, n, 2.5, skin=0.4)) and PackedEngine
    with the pair kernel in its sentinel layout (bench.py's spec), LJ r_cut
    2.5 unshifted, from the same positions: forces max|df| <= 1e-4 max|f| +
    1e-3, PE and virial rtol 1e-4; then the half-skin witness and
    MetadSampler on NeighborEngine with bench.py's CVs as particle-order
    LamellarOPs.  Returns the pair kernel's launches in the cross-check."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        AllPairsEngine, Box, CellSpec, GridSpec, HillSpec, LamellarOP,
        MetadSampler, NeighborEngine, PackedEngine, PackedSpec, WallSpec,
        WELL_TEMPERED, lj_kernel, lj_tables, make_langevin_step, make_state,
        make_system,
    )
    from metadyn_tpu_torch.core.box import minimum_image
    from metadyn_tpu_torch.utils.profiling import device_profile

    t24 = time.perf_counter()
    d = np.load(ROOT / "bench_data" / "liq64k.npz")
    pos, vel, L = d["pos"], d["vel"], float(d["L"])
    n = pos.shape[0]
    system = make_system(n, dev)
    box = Box.cubic(L, dev)
    params = lj_tables(1, r_cut=2.5, shift=False, device=dev)
    state0 = make_state(pos, box, vel=vel, device=dev)
    res, peak = {}, {}
    ap = AllPairsEngine(system, pair_params=params, pair_kernel=lj_kernel,
                        row_block=1024, device=dev)
    cell = CellSpec.create(L, n, 2.5, skin=0.4)
    nb = NeighborEngine(system, cell, params, lj_kernel, rebuild_every=10,
                        device=dev)
    for name, eng in (("all_pairs", ap), ("neighbor", nb)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, aux = eng.init(state0)
        torch.cuda.synchronize()
        res[name] = (st.force, st.potential_energy, st.virial,
                     time.perf_counter() - t0, aux)
        peak[name] = torch.cuda.max_memory_allocated()
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    pk = PackedEngine(spec, dev, rebuild_every=10)
    pst, ovf = pk.pack_state(pos, box, np.zeros(n, np.int32),
                             np.ones(n, np.float32), np.ones(n, np.float32),
                             vel=vel)
    assert not ovf, "cell capacity overflow at pack (phase 24)"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pst, paux = pk.init(pst)
    pst = pk.refresh_energy(pst, paux)
    torch.cuda.synchronize()
    launches = read_counts()["pair"]
    res["packed"] = (pid_order_forces(pst), pst.potential_energy,
                     pst.virial, time.perf_counter() - t0, None)
    f_ref = res["all_pairs"][0]
    fmax = float(f_ref.abs().max())
    lines = []
    for name in ("neighbor", "packed"):
        f, pe, w = res[name][:3]
        df = float((f - f_ref).abs().max())
        dpe = abs(float(pe - res["all_pairs"][1])) / abs(
            float(res["all_pairs"][1]))
        dw = float(((w - res["all_pairs"][2]).abs()
                    / res["all_pairs"][2].abs()).max())
        lines.append(f"{name} vs all_pairs: max|df|={df:.3e} "
                     f"(max|f|={fmax:.3e}) rel_dPE={dpe:.3e} "
                     f"rel_dvirial={dw:.3e}")
        assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (name, df)
        assert dpe <= 1e-4 and dw <= 1e-4, (name, dpe, dw)
    nb_aux = res["neighbor"][4]
    assert not bool(nb_aux.overflow), "neighbour list overflow (phase 24)"
    print(f"engines N={n}: " + "; ".join(lines) + "; first force call s: "
          + ", ".join(f"{k} {v[3]:.3f}" for k, v in res.items())
          + f"; pair kernel launches {launches}; {cell}; peak memory "
          "of the first force call (the neighbour list's build in it): "
          + ", ".join(f"{k} {v / 2 ** 30:.2f} GiB" for k, v in peak.items())
          + f" on {smi}")
    del res, f_ref

    # the half-skin witness: 10 steps on the skin-0.4 list, counting the
    # particles beyond skin/2 (the rebuild's stale trigger) after 5 and 10
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(0)
    st, aux = nb.init(state0)
    step = make_langevin_step(lambda s: nb.force_into(s, aux), system,
                              0.005, KT, 1.0)
    p0, witness = st.pos, []
    for i in range(10):
        st = step(st, g)
        if i + 1 in (NB_REBUILD, 10):
            disp = torch.linalg.vector_norm(
                minimum_image(st.pos - p0, st.box), dim=1)
            witness.append(f"after {i + 1} steps max displacement "
                           f"{float(disp.max()):.4f}, "
                           f"{int((disp > 0.2).sum())} particles beyond 0.2")
    _, aux = nb.rebuild(st, aux)
    print(f"neighbor half-skin witness (skin 0.4, skin/2 = 0.2): "
          f"{'; '.join(witness)}; stale after a 10-step block="
          f"{bool(aux.stale)}")

    # the sampler on NeighborEngine: bench.py's CVs, grid and bias cadence,
    # the list rebuilt every NB_REBUILD steps (see NB_REBUILD)
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004], dev)
    nb = NeighborEngine(system, cell, params, lj_kernel,
                        rebuild_every=NB_REBUILD, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sampler = MetadSampler(
        system, state0, nb,
        [LamellarOP.create([1.0], [[0, 0, 3]], name="a", device=dev),
         LamellarOP.create([1.0], [[0, 3, 0]], name="b", device=dev)],
        gspec, HillSpec.create(W=0.1, stride=STRIDE, mode=WELL_TEMPERED,
                               deltaT=5.0),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=KT, gamma=1.0),
        seed=0, bias_every=5, chunks_per_block=8,
        walls=WallSpec.at_grid_edges(gspec, k=2000.0))
    sampler.run(STRIDE)                                     # warm stride
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = sampler.run(2 * STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = n * 2 * STRIDE / dt
    peak = torch.cuda.max_memory_allocated()
    assert not any(read_counts().values()), read_counts()
    for m in hist:
        assert not m["nlist_overflow"], m
        assert not m["nlist_stale"], m
        assert 0.9 < float(m["temperature"]) < 1.1, m
        for k in ("cv", "bias_V", "hill_height", "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
    prof = device_profile(lambda: sampler.run(STRIDE))
    prof["busy_share_untraced"] = prof["busy_ms"] / (1e3 * dt / 2)
    last = hist[-1]
    print(f"neighbor sampler (skin 0.4, rebuild_every {NB_REBUILD}, "
          f"bias_every 5): "
          f"2 strides {dt:.3f} s {rate:.1f} particle-steps/s "
          f"T={float(last['temperature']):.4f} "
          f"PE/N={float(last['potential_energy']) / n:.4f} "
          f"cv={last['cv'].tolist()} peak {peak / 2 ** 30:.2f} GiB on {smi}")
    print(f"profile neighbor sampler one stride: {json.dumps(prof)} "
          f"on {smi}")
    print(f"engines phase 24: {time.perf_counter() - t24:.1f} s")
    return launches


def double_well_card(dev, smi: str) -> None:
    """Phase 25: the double-well sampler (scripts/fes_oracle.py's,
    ForceField(external=) through the sampler's callable adapter) on the
    card: 200 strides of 50 steps, ms per step, 200 hills, a finite bias
    that rose above 0."""
    import importlib.util
    import numpy as np
    import torch
    # the oracle's own sampler, loaded by path (scripts/ is no package)
    spec = importlib.util.spec_from_file_location(
        "fes_oracle", ROOT / "scripts" / "fes_oracle.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)

    s = oracle.double_well_sampler(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = s.run(200 * 50)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    V = s.bias.grid.V.cpu().numpy()
    assert s.bias.n_hills == 200 and len(hist) == 200, s.bias.n_hills
    assert np.isfinite(V).all() and V.max() > 0.0, V.max()
    print(f"double well: 200 strides of 50 steps {dt:.3f} s "
          f"{1e3 * dt / 10000:.4f} ms/step hills={s.bias.n_hills} "
          f"V_max={V.max():.4f} x_last={float(hist[-1]['cv'][0]):.4f} "
          f"on {smi}")


def main() -> int:
    t_main = time.perf_counter()
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

    # 19.-21. Config 5: the soft layout against the plain sweep at both
    # push-off starts; the push-off witness at 2,048 beads and the slice
    # against the plain path at 16,384; the 1M push-off and flux-tempered
    # run
    t19 = time.perf_counter()
    for ln in ptxas_lines(KERNEL, SOFT_KERNELS):
        print(f"build: csrc/{KERNEL}.cu soft layout {ln}")
    _, soft2 = soft_kernel_vs_plain(diblock_melt(512, 16, 21.3), dev,
                                    "config2 N=8192")
    melt5 = config5_melt(65536)
    soft5_start, soft5 = soft_kernel_vs_plain(
        melt5, dev, f"config5 N={melt5['n']}", calls=10, plain_calls=2,
        plain_warm=1)
    config5_pushoff_witness(dev, smi[0])
    config5_kernel_vs_plain(dev)
    cfg5 = config5_1m(soft5_start, melt5, dev, smi[0])
    del soft5_start
    print(f"config5 phases 19-21: {time.perf_counter() - t19:.1f} s")

    # 22. the packed example YAMLs through the port's CLI, the resume leg,
    # the CLI's host transfers against the direct sampler's
    cli = cli_yamls(dev, smi[0])

    # 23.-25. the particle-order engines: Config 1 through the CLI, the
    # three engines against each other at 62,500 particles and the
    # neighbour-list sampler, the double-well sampler
    t23 = time.perf_counter()
    config1_cli(dev, smi[0])
    cross_launches = engines_cross_check(dev, smi[0])
    double_well_card(dev, smi[0])
    print(f"particle-order phases 23-25: {time.perf_counter() - t23:.1f} s")
    print(f"chip_smoke wall: {time.perf_counter() - t_main:.1f} s")

    def cli_launches(kernel: str) -> dict:
        """This kernel's launches on the CLI paths: each YAML's build (the
        melts' push-off on the soft layout is in the pair kernel's) and
        run."""
        out = {}
        for name, (build, run) in cli.items():
            if build[kernel]:
                out[f"cli {name} build"] = build[kernel]
            if run[kernel]:
                out[f"cli {name} run ({int(run[kernel])} in all)"] = run[
                    kernel]
        return out

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
           if k.startswith("pair")},
        **cfg5["variants"]}
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
                                "triclinic": tric_counts["pair"],
                                "config5 N=1048576 (2 periods of 4 "
                                "strides)": cfg5["launches"],
                                **cli_launches("pair"),
                                "engines cross-check N=62500 (phase 24: "
                                "init and energy refresh)": cross_launches},
              variants={k: dict(zip(keys, v)) for k, v in variants.items()}),
        entry(f"{KERNEL} soft layout", KERNEL,
              "XLA roll sweep, metadyn_tpu/ops/packed.py:830 (no "
              "pallas_call)", cfg5["push_launches"],
              soft5[f"soft config5 N={melt5['n']}"],
              design=staged + "; the soft pair on the per-slot se/hs "
              "layout with FENE bonds (a layout of the port alone)",
              launches_by_path={"config5 push-off N=1048576 (1000 + 500 "
                                "steps and two inits)": cfg5["push_launches"],
                                "config2 push-off (2000 steps and the "
                                "init)": CFG2_PUSHOFF_STEPS + 1,
                                "cli config2_diblock_sk push-off (in its "
                                "build)": cli["config2_diblock_sk"][0][
                                    "pair"] - 2,
                                "cli config5_flux push-off (in its build)":
                                cli["config5_flux"][0]["pair"] - 2,
                                "per stride": 0},
              variants={k: dict(zip(keys, v))
                        for k, v in {**soft2, **soft5}.items()}),
        entry("packed_order_values", packed_order_cuda.KERNEL,
              "metadyn_tpu/ops/packed_order_pallas.py:257",
              lag_counts["values"], order["values"],
              design=staged + ", prefiltered to the CVs' reach, one hit "
              "queue across a warp's i rows, a partials row per cell",
              launches_by_path={"config3 mts_lag": lag_counts["values"],
                                "triclinic": tric_counts["values"],
                                **cli_launches("values")},
              variants=tric_variants("values", "validity")),
        entry("packed_order_force", packed_order_cuda.KERNEL,
              "metadyn_tpu/ops/packed_order_pallas.py:309",
              exact_counts["force"], order["force"],
              design=staged + ", prefiltered to the CVs' reach",
              launches_by_path={"config3 exact": exact_counts["force"],
                                "triclinic": tric_counts["force"],
                                **cli_launches("force")},
              variants=tric_variants("force", "validity")),
        entry(packed_fused_cuda.KERNEL, packed_fused_cuda.KERNEL,
              "metadyn_tpu/ops/packed_fused_pallas.py:296",
              lag_counts["fused"], order["fused"],
              design=staged + ", one staging prefiltered to the larger of "
              "the LJ and CV cut-offs for the LJ and the CV math",
              launches_by_path={"config3 mts_lag": lag_counts["fused"],
                                **cli_launches("fused")},
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
