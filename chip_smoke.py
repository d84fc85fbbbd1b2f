#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Five workloads, all at full size, then the example YAMLs through the
port's CLI (phase 22), the particle-order path (phases 23-25), Config 3
on the x-slab decomposition (phases 26-27), the well-tempered ensemble
(phase 28), multiple walkers on the one card (phase 29), the moving box
and the walkers x space product (phases 30-34), the 2-D decomposition,
hill-list mode and the neighbour table (phases 35-39), and kernel 4's parts
subsets, GSD trajectories and the sort-based pack (phases 40-42):

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
 26. the slab path's kernel variants against their plain versions on
     Config 3 (fcc + noise 0.05, cap 32) cut into 2 and 1 x-slabs, on each
     shard's extended grid (9 x 14 x 14 and 16 x 14 x 14 cells): kernel 2
     with the interior cell_mask, kernel 4 in the monomial mode unmasked
     and masked, kernel 1's masked energy and virial; the shards' masked
     value sums against the unsharded kernel; kernel 4's monomial mode
     against its recurrence mode on the whole 62,500 grid; times per call
     and bounds;
 27. Config 3 on parallel/spatial.SpatialPackedEngine with 2 shards on
     the one card: 20 lagged steps at gamma = 0 against PackedEngine
     (positions to 1e-3, CVs rtol 1e-4, PE rtol 1e-5; the slab path's
     variants launched); the sharded repack against repack_incremental
     bit for bit (1 and 2 shards); Config 3 lagged timed with 1 and 2
     shards as phase 10 times it (exact launches per stride, one profiled
     stride); the CLI with engine.spatial_devices = 2 (500 steps; on one
     card both shards share it).
 28. the well-tempered ensemble (examples/config6_wte.yaml: the potential
     energy is the CV, kernel 1 computes energy and virial on every force
     call) at init.n_cells 25 (62,500 particles, the grid scaled per
     particle): 20 steps
     at gamma 0 of the kernel engine against the plain-force engine
     (positions 1e-3, U and the CV trace rtol 1e-5); 20 timed strides of
     25 (exactly 26 launches per stride, every one with energy; four
     profiled strides); the kernel with energy against its plain version
     on that run's state; the YAML as written through the CLI (2,048
     particles, 2000 steps: T of the last stride in 1.1-2.0, 80 hills, the
     files read back);
 29. multiple walkers on the one card (parallel/walkers.py): kernel 1's
     walker batch (8 walkers of liq64k, each + noise 0.02) against 8
     single launches, to the bit, and against the plain batched version,
     with times and the bound; WalkerSampler with 2 walkers, add_hills
     False and gamma 0 against two MetadSamplers under the same frozen
     grid (20 steps, positions 1e-4); 8 x liq64k (bench.py's settings,
     500,000 particles) timed: 1 warm and 2 timed strides, exactly 501
     launches per stride for all 8 walkers, one device-to-host read per
     rebuild block, 8 hills per stride, one profiled stride;
     examples/config4_walkers.yaml through the CLI (8 x 864) and its
     resume leg, bit for bit; the flux walkers (4 on the double well of
     tests/test_flux_walkers.py, the callable engine on the card): one
     update period, the pooled histograms, a finite bias.
 30. NPT at 62,500: the liquid on 13^3 cells (cap 48; 14^3 cells leave no
     width headroom against r_list) with kernel 1's energy and virial on
     every force call; its mean NVT pressure over 4 strides of 100; 20
     steps of isotropic SCR-NPT at gamma 0, kernel engine against the
     plain-force engine (positions 1e-3, box L rtol 1e-5); NPT timed (1
     warm and 2 timed strides of 500, bias_every 5: exactly 501 launches
     per stride, all with energy; the box trace; no cell-width violation)
     and one profiled stride, its device-to-host copies no more than phase
     5's; kernel 1 (a) with energy against its plain version on the moved
     box (the cell matrix read from device memory);
 31. box metadynamics (AspectRatio, anisotropic SCR with box_bias, the
     two-argument integrator factory) at 62,500: 3 strides of 100, the CV
     equal to the box's L_x / L_y, exact launches; the PackedMSD CV biased
     under isotropic SCR: its value against the plain float64 one;
 32. NPT walkers: 4 x the liquid on 13^3 cells, SCR-NPT + the WTE energy
     CV in one batch, every walker in a box of its own: kernel 1 on the
     batch against 4 single launches, to the bit, and against the plain
     batched version; 4 timed strides of 100 (101 launches per stride, all
     with energy), the rate summed over walkers;
 33. Config 5 at 1,048,576 beads on 2 x-slabs of the card
     (SpatialPackedEngine, 33 x-planes per shard; ShardedPackedMesh 48^3,
     24 columns per shard) from phase 21's relaxed melt: S(k0), its bias
     force and the bias virial against the single-grid PackedMesh; one
     warm and one timed flux period (exact launches: one per shard per
     force call), peak memory, one profiled period;
 34. walkers x space: 4 x liq64k on 2 x-slabs of the nested
     SpatialPackedEngine: kernel 1's walker batch under the interior mask
     against 4 single masked launches (to the bit) and its plain version;
     20 steps at gamma 0 against phase 29's unsharded walker batch; 1 warm
     and 2 timed strides (exact launches), the rate summed over walkers.
     Phase 22 runs examples/config4_walkers_sk_dd.yaml (4 walkers x 2
     slabs, the sharded S(k) CV) as written, with its resume leg;
 35. the kernels on the 2-D blocks' extended grids: Config 3 on 2 x 2
     blocks (9 x 9 x 14 each): kernel 1 forces only and with energy under
     the interior mask, kernel 2 masked, kernel 3, each against its plain
     version; the blocks' sums and gathered forces against the single
     grid's kernels; kernel 1's walker batch under the mask on block 0
     (4 x liq64k + noise 0.02) against 4 single launches (bits);
 36. Config 3 exact on SpatialPackedEngine2D (2 x 2): 20 steps at gamma 0
     against PackedEngine, the 2-D repack against repack_incremental
     (bits), timed as phase 11 (exact launches: 4 per force call) with
     its busy ms and device-to-host copies beside phase 11's;
 37. Config 5 at 1M on 2 x 2 blocks with ShardedPackedMesh2D 48^3 from
     phase 21's relaxed melt: S(k0), bias force and virial against
     PackedMesh; two calls of the mesh CVs (Config 2's PackedMesh, Config
     5's PackedMesh and the pencils) bit for bit; the fixed-point scatter
     against the float index_add it replaced; one warm, one timed and one
     profiled flux period (exact launches), peak memory;
 38. examples/config4_walkers_sk_dd.yaml through the CLI on
     spatial_devices [2, 2] (exact launches, the files) and its resume leg
     (bits); walkers x 2-D space: 4 x liq64k on the nested blocks, one
     timed stride (exact launches, 4 walkers per launch);
 39. hill-list mode: liq64k's lamellar CVs without a grid (exact launches
     as grid mode, V and dV/ds against float64 and evaluate_on_grid), the
     spill grid and the overflow flag at capacity 8; the neighbour table
     at Config 3 (its values and forces against kernels 2 and 3, exact
     launches, timed beside phase 11);
 40. kernel 4's parts subsets (csrc/packed_fused_parts.cu, a timing mode
     with no production caller) at Config 3 on the lagged path's state:
     each of the 8 subsets in the recurrence and the monomial mode against
     its plain version at kernel 4's gates, the outputs it leaves out
     exactly zero, timed with the launch, the kernel alone on the device
     (the profiler's kernel events) and the wrapper on the device, with
     its bound; the split of kernel 4's device time into staging ({}) and
     what lj, vals and force each add; every subset launched, none on any
     main path (every path's read_counts fails on a "fused parts" launch,
     and the kernels line prints those reads by path);
 41. examples/config1_lj_lamellar.yaml through the CLI to an npz and to
     a .gsd trajectory (the native core): the frames equal to the bit,
     rdf equal, the .gsd's two legs (the second --resume) byte for byte
     the straight run's frames with each leg's own step count, as the
     reference's CLI writes them;
 42. ops/packed.pack on the card at Config 5's 1M production start against
     pack_host, every array to the bit, both timed, pack's peak memory.

After each timed run one more stride runs under torch.profiler, and a line
reports the GPU's busy share of it and the top kernels.  The launch counts
of each path are set to 0 just before its timed strides and read just
after: the pair kernel's from phases 5 and 15, the values and fused
kernels' from phase 10, the force kernel's from phase 11 (the lagged path
never runs it inside a stride), the soft layout's from the 1M push-off
(phase 21; it runs no launch inside a stride), the slab path's variants
from phase 27 (the masked fused kernel and the masked energy per timed
stride, the masked values kernel in the run with the sampler's
construction, where the lag's exact seed runs it); the v1 kernel and the
unmasked monomial mode have no production caller and no main-path
launches.  Phase 24's cross-check
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
# pair (the switching function; its force); a Q_6 bond in the monomial
# mode (u and the monomials of degrees 2, 3 and 6, 28 sums: 77; the
# degree-5 monomials, three 21-term dot products and the projection: 164).  Estimates to within ~50%:
# the bound they give is a floor, not a prediction.
FLOP_PER_PAIR = {"lj": 24, "lj_energy": 37, "soft": 20, "soft_energy": 34,
                 "bond": 45, "q6_value": 150, "q6_force": 300,
                 "coord_value": 20, "coord_force": 30,
                 "q6_mono_value": 77, "q6_mono_force": 164}


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


def pairs_within(state, spec, rc: float, cell_mask=None) -> int:
    """Unordered pairs of real slots closer than ``rc``, by a roll sweep
    over the 27 neighbour cells: the pair work these inputs need.  With
    ``cell_mask`` (C,), only the ordered pairs whose i cell is masked in
    count, halved: the work of a function weighted by the mask."""
    import torch
    from metadyn_tpu_torch.ops.packed import OFFSETS, _tables, shift_rows_cart
    cap, C = spec.cap, spec.n_cells
    dims = (2, 3, 4)
    x = state.r.reshape(3, cap, *spec.cells_per_dim)
    real = (state.pid < spec.n_real).reshape(cap, *spec.cells_per_dim)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    xi = state.r.reshape(3, 1, cap, C)
    real_i = real.reshape(1, cap, C)
    if cell_mask is not None:
        real_i = real_i & (cell_mask > 0).reshape(1, 1, C)
    count = 0
    for oi, o in enumerate(OFFSETS):
        back = (-o[0], -o[1], -o[2])
        xj = torch.roll(x, back, dims).reshape(3, cap, C) + shifts[oi][:, None]
        rj = torch.roll(real, back, (1, 2, 3)).reshape(cap, 1, C)
        d = xi - xj[:, :, None, :]
        r2 = (d * d).sum(0)
        count += int(((r2 < rc * rc) & (r2 > 1e-12) & real_i & rj).sum())
    return count // 2


def near_cutoff_slots(state, spec, rel: float = 1e-5):
    """(Npad,) bool: the real slots with a real partner whose r² lies
    within rel·rc² of rc².  Such a pair sits inside the cut-off for one f32
    rounding of r² and outside it for another (the kernel's fused
    multiply-adds against the plain version's separate ones), and the
    unshifted LJ force jumps there by |F(r_cut)|: their slots are held to
    that jump (pair_close's ``exempt``), every other slot to the gate."""
    import torch
    from metadyn_tpu_torch.ops.packed import OFFSETS, _tables, shift_rows_cart
    cap, C = spec.cap, spec.n_cells
    dims = (2, 3, 4)
    rc2 = float(spec.r_cut) ** 2
    x = state.r.reshape(3, cap, *spec.cells_per_dim)
    real = (state.pid < spec.n_real).reshape(cap, *spec.cells_per_dim)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    xi = state.r.reshape(3, 1, cap, C)
    near = torch.zeros((cap, C), dtype=torch.bool, device=state.r.device)
    for oi, o in enumerate(OFFSETS):
        back = (-o[0], -o[1], -o[2])
        xj = torch.roll(x, back, dims).reshape(3, cap, C) + shifts[oi][:, None]
        rj = torch.roll(real, back, (1, 2, 3)).reshape(cap, 1, C)
        d = xi - xj[:, :, None, :]
        r2 = (d * d).sum(0)
        near |= ((r2 - rc2).abs() <= rel * rc2).logical_and(rj).any(0)
    return (near & real.reshape(cap, C)).reshape(-1)


def lj_jump(spec) -> float:
    """|F(r_cut)| of the unshifted LJ pair at the uniform sigma and
    epsilon (1 where per-slot)."""
    s6 = (float(spec.uniform_sigma or 1.0) / float(spec.r_cut)) ** 6
    return abs(24.0 * float(spec.uniform_eps or 1.0) * (2.0 * s6 * s6 - s6)
               / float(spec.r_cut))


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


def lanes_of(terms):
    """Per-CV terms → one flat lane tensor."""
    import torch
    return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])


def lanes_close(name: str, cvs, terms, ref, rtol: float) -> float:
    """max|Δlane| ≤ rtol·max|lane| within each CV's lanes; returns the
    largest max|Δlane|."""
    import numpy as np
    worst = 0.0
    for cv, t, r in zip(cvs, terms, ref):
        d = float((lanes_of([t]) - lanes_of([r])).abs().max())
        scale = float(lanes_of([r]).abs().max())
        assert np.isfinite(d) and d <= rtol * scale, (name, cv.name, d, scale)
        worst = max(worst, d)
    return worst


def force_close(name: str, a, b, rtol: float, atol_frac: float) -> tuple:
    """|a − b| ≤ rtol·|b| + atol_frac·max|b|; returns (max|a − b|,
    max|b|)."""
    import numpy as np
    d = (a - b).abs()
    bmax = float(b.abs().max())
    worst = float((d - rtol * b.abs()).max())
    assert np.isfinite(bmax) and worst <= atol_frac * bmax, (name, worst,
                                                              bmax)
    return float(d.max()), bmax


def pair_close(tag: str, a, b, with_energy: bool, exempt=None,
               jump: float = 0.0) -> tuple:
    """Hold a pair kernel's state ``a`` against the plain force's ``b``:
    max|df| <= 1e-4 max|f| + 1e-3, PE and virial rtol 1e-5.  With
    ``exempt`` ((Npad,) bool, near_cutoff_slots) those slots are held to
    that bound plus 2 ``jump`` instead.  Returns (max|df|, a report)."""
    import numpy as np
    d = (a.f - b.f).abs().amax(-2)
    df = float(d.max())
    fmax = float(b.f.abs().max())
    tol = 1e-4 * fmax + 1e-3
    line = ""
    if exempt is not None and bool(exempt.any()):
        worst = float(d[exempt].max())
        assert np.isfinite(worst) and worst <= tol + 2.0 * jump, (
            tag, worst, jump)
        line = (f" ({int(exempt.sum())} slots with a pair within 1e-5 of "
                f"r_cut^2: max|df| {worst:.3e} against the jump "
                f"{jump:.3e})")
        df = float(d[~exempt].max())
    assert np.isfinite(df) and df <= tol, (tag, df, fmax)
    line = f"max|df|/max|f|={df / fmax:.3e} (max|f|={fmax:.3e})" + line
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
                         plain_warm: int = 3, cutoff: bool = False) -> dict:
    """The pair kernel against the plain pair force on ``st``, forces only
    and with energy (pair_close; with ``cutoff``, the slots of pairs at
    the cut-off held to its jump), with times per call and the bound; one
    line each.  Returns {key, key + "+energy": (max abs error, kernel ms,
    plain ms, bound ms, bound by)}."""
    import torch
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

    pairs = pairs_within(st, spec, spec.r_cut)
    exempt = near_cutoff_slots(st, spec) if cutoff else None
    out = {}
    for we in (False, True):
        a = packed_lj_force_cuda(st, spec, with_energy=we)
        b = packed_lj_force(st, spec, with_energy=we)
        torch.cuda.synchronize()
        err, line = pair_close(f"{label} {key}", a, b, we, exempt,
                               lj_jump(spec))
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
    initial pack overflows ``cap``.  ``engine_cls(spec, dev,
    rebuild_every=10)`` builds the engine."""
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
    """name -> (wrapper, counter attribute): each wrapper's launches, and
    those of the slab path's variants (counted apart as well)."""
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )
    from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda
    return {"pair": (packed_lj_force_cuda, "launches"),
            "values": (order_values_cuda, "launches"),
            "force": (order_force_cuda, "launches"),
            "fused": (fused_lj_order_force_cuda, "launches"),
            "v1": (packed_lj_force_v1_cuda, "launches"),
            "pair masked": (packed_lj_force_cuda, "masked_launches"),
            "values masked": (order_values_cuda, "masked_launches"),
            "fused mono": (fused_lj_order_force_cuda, "mono_launches"),
            "fused mono masked": (fused_lj_order_force_cuda,
                                  "masked_launches")}


def reset_counts() -> None:
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    fused_lj_order_force_cuda.parts_launches.clear()


# (the function that read, "fused parts") of every read_counts() call: the
# kernels line sums them by reader
PARTS_READS: list = []


def read_counts() -> dict:
    """Every counter of counters(), and "fused parts": the launches of
    kernel 4's parts subsets summed.  Each read is kept in PARTS_READS under
    the function that made it, and fails if a parts subset was launched:
    they are a timing mode (phase 40 reads its own counts), never on a
    main path."""
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda,
    )
    out = {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}
    out["fused parts"] = sum(fused_lj_order_force_cuda.parts_launches.values())
    reader = sys._getframe(1).f_code.co_name
    PARTS_READS.append((reader, out["fused parts"]))
    assert out["fused parts"] == 0, (
        f"{reader}: kernel 4's parts subsets launched on a main path "
        f"{dict(fused_lj_order_force_cuda.parts_launches)}")
    return out


def parts_reads_by_path() -> dict:
    """The "fused parts" counts of every main path's reads, summed by the
    function that read them (launches_by_path of the kernels line)."""
    out: dict = {}
    for reader, n in PARTS_READS:
        key = f"{reader} (read_counts 'fused parts')"
        out[key] = out.get(key, 0) + n
    return out


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

    # kernel 2: value terms and s
    tk = order_values_cuda(st, spec, cvs)
    tp = order_values_plain(st, spec, cvs)
    sk = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tk)])
    sp = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tp)])
    torch.cuda.synchronize()
    err = float((lanes_of(tk) - lanes_of(tp)).abs().max())
    ds = float(((sk - sp).abs() / sp.abs()).max())
    assert np.isfinite(err) and ds <= 2e-5, (ds, sk, sp)
    lanes_close("values", cvs, tk, tp, 2e-5)
    values_vs_stencil("config3 order_values", tk, st, spec, cvs)
    out["values"] = (err, cuda_ms(lambda: order_values_cuda(st, spec, cvs)),
                     cuda_ms(lambda: order_values_plain(st, spec, cvs)))
    print(f"order_values kernel_vs_plain: s={sk.tolist()} rel_ds={ds:.3e} "
          f"max|dlane|={err:.3e} kernel_ms={out['values'][1]:.4f} "
          f"plain_ms={out['values'][2]:.4f}")

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
    lanes_close("fused values", cvs, tk4, tp4, 2e-4)
    values_vs_stencil("config3 fused_lj_order", tk4, st, spec, cvs, 2e-4)
    force_vs_stencil("config3 fused_lj_order", gk4, st, spec, cvs, auxs)
    el = float((lanes_of(tk4) - lanes_of(tp4)).abs().max())
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
                  per_stride: dict, smi: str, engine_cls=None,
                  tag: str = None, out: dict = None) -> dict:
    """Phases 10, 11 and 27: Config 3 timed, with the physics checks and
    exact launch counts per stride.  Returns the launch counts of the last
    run; ``out`` gets the rate, the profile and the launches of the timed
    sampler's construction (its seed evaluation)."""
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.utils.profiling import device_profile
    import numpy as np
    import torch

    tag = tag or f"config3 mts_lag={mts_lag}"
    for cap in (32, 36):
        reset_counts()
        s = config3_sampler(engine_cls or PackedEngine, dev, cap, mts_lag)
        built = read_counts()
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
    if out is not None:
        out.update(rates=[n * CFG3_STRIDE * n_timed / r[0] for r in runs],
                   profile=prof, build=built, state=s.state, cvs=s.cvs,
                   spec=s.engine.spec)
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
            "variants": prod, "relaxed": (pos, vel)}


# Phase 22: the packed example YAMLs through the port's CLI, as written
# (only the output paths move).  Per YAML: the T band of the last stride
# (PERF.md §2: the direct paths' bands; config5_flux.yaml's melt thermalizes
# as config2's), and the exact kernel launches of the build (the production
# engine's init and first biased force; the start-in-grid check's CV
# values; config3's lag seed) and per stride of the run, derived as phases
# 10, 15 and 18 derive theirs.  A melt's build also runs its push-off on
# the pair kernel's soft layout, counted by the same counter: its init and
# one launch per step.
# config4_walkers_sk_dd's T of the last stride: the sc start at spacing 2
# (rho 0.125) at kT 1; on the CPU the port's walkers were at 0.95-1.02 by
# step 40
C4SK_T_BAND = (0.6, 1.4)
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
    # 4 walkers of 343 on 2 x-slabs, the S(k) CV sharded: its walkers step
    # one by one (the mesh CV takes one state), each force call one launch
    # per shard; the refresh masked with energy
    "config4_walkers_sk_dd": dict(
        band=C4SK_T_BAND, build={"pair": 4 * 2 * 2},
        per_stride={"pair": 4 * 21 * 2, "pair masked": 4 * 2}),
}
# the resume legs: K steps with a checkpoint, --resume for K more, against
# one straight 2K-step run
CLI_RESUME = ("triclinic_packed", "config4_walkers_sk_dd")
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


def cli_checks(name: str, cfg: dict, runner, band=None) -> list:
    """What one CLI run wrote, read back with the port's readers: the hill
    file's rows (one per stride and walker) and columns, the grid dump, the
    CSV log's columns with no overflow, T of the last stride in the band
    (every walker's; ``band`` defaults to the YAML's in CLI_YAMLS).
    Returns the failures."""
    import numpy as np
    from metadyn_tpu_torch.io.grid_file import load_grid
    from metadyn_tpu_torch.io.hill_log import read_hills
    from metadyn_tpu_torch.io.metrics import read_csv

    bad = []
    out, mcfg = cfg["output"], cfg["metadynamics"]
    n_steps = int(cfg["run"]["n_steps"])
    flux = mcfg.get("mode") == "flux_tempered"
    n_walkers = int(mcfg.get("n_walkers", 1))
    n_hills = 0 if flux else n_walkers * n_steps // int(mcfg["stride"])
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
        if not flux and n_walkers == 1:
            want = sorted(
                k if np.ndim(hist[0][k]) == 0 else f"{k}_{i}"
                for k in METAD_KEYS
                for i in range(max(1, np.size(hist[0][k]))))
            if sorted(log) != want:
                bad.append(f"log columns {sorted(log)}")
    temps = np.concatenate([np.atleast_1d(m["temperature"]).reshape(-1)
                            for m in hist])
    last = np.atleast_1d(hist[-1]["temperature"]).reshape(-1)
    if n_walkers == 1:
        last = last[-1:]
    band = band or CLI_YAMLS[name]["band"]
    if not (np.isfinite(temps).all()
            and ((band[0] < last) & (last < band[1])).all()):
        bad.append(f"T of the last stride {last} outside {band}")
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
        st = getattr(runner.sampler, "states", None) or runner.sampler.state
        spec = runner.sampler.engine.spec
        occ = int((st.pid < spec.n_real).reshape(-1, spec.cap, spec.n_cells)
                  .sum(1).max())
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

    # the resume legs: K steps with a checkpoint, --resume for K more,
    # against one straight run of 2K steps
    from metadyn_tpu_torch.io.grid_file import load_grid
    for name in CLI_RESUME:
        legs = {}
        for leg in ("resumed", "straight"):
            d = tmp / f"resume_{name}_{leg}"
            d.mkdir()
            cfg = cli_yaml(name, d, checkpoint="ck.npz",
                           grid_file="grid.npz")
            k = int(cfg["run"]["n_steps"])
            if leg == "straight":
                cfg["run"]["n_steps"] = 2 * k
                CliRun(cfg, device=dev).run()
            else:
                CliRun(cfg, device=dev).run()
                CliRun(cfg, resume=True, device=dev).run()
            legs[leg] = cfg["output"]
        same_hills = (open(legs["resumed"]["hill_file"], "rb").read()
                      == open(legs["straight"]["hill_file"], "rb").read())
        va = load_grid(legs["resumed"]["grid_file"])[0].grid.V
        vb = load_grid(legs["straight"]["grid_file"])[0].grid.V
        dv = float((va - vb).abs().max())
        if not (same_hills and torch.equal(va, vb)):
            bad.append(f"{name} resume leg: hill files equal {same_hills}, "
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


# phases 26-27 (the slab decomposition, parallel/spatial.py): Config 3 cut
# into SPATIAL_SHARDS x-slabs of the 14 x-planes on the one card
SPATIAL_SHARDS = 2


def spatial_ext_states(st, spec, n_dev: int, dev) -> tuple:
    """Config 3's state cut into ``n_dev`` slabs on ``dev`` (the islands'
    halo extension, parallel/spatial.Slabs.halo_states): per shard an
    extended PackedState with the columns both the kernels and their plain
    versions read (r, pid, se, hs).  Returns (slabs, states)."""
    from metadyn_tpu_torch.parallel.spatial import Slabs
    slabs = Slabs(spec, [dev] * n_dev)
    return slabs, slabs.halo_states(st, pid=True, attrs=("se", "hs"))


def spatial_engine(n_dev: int):
    """An engine_cls for config3_sampler: SpatialPackedEngine with n_dev
    shards on the one card."""
    from metadyn_tpu_torch.parallel.spatial import SpatialPackedEngine

    def make(spec, dev, rebuild_every):
        return SpatialPackedEngine(spec, [dev] * n_dev,
                                   rebuild_every=rebuild_every)
    return make


def spatial_kernels_vs_plain(dev) -> dict:
    """Phase 26: the kernel variants of the slab path against their plain
    versions at its shapes: Config 3 (fcc + noise 0.05, cap 32) cut into 1
    and SPATIAL_SHARDS slabs, on each shard's extended grid: kernel 2 with
    the interior mask, kernel 4 in the monomial mode unmasked and masked,
    kernel 1's masked energy and virial; then kernel 4's monomial mode
    against its recurrence mode on the whole 62,500 grid.  Gates of §2:
    values lanes rtol 2e-5, fused lanes 2e-4, bias forces rtol 2e-3 + 2e-4
    max, LJ forces 1e-3 max, pair forces 1e-4 max + 1e-3, PE and virial
    rtol 1e-5.  Returns per variant and grid (max abs error, kernel ms,
    plain ms, bound ms, bound by)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import Box, PackedEngine
    from metadyn_tpu_torch.cv.packed_order import order_values_plain
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        fused_lj_order_force_cuda, fused_lj_order_force_plain,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import order_values_cuda

    pos, vel, L, a, spec = config3_inputs(32, noise=0.05)
    n = pos.shape[0]
    engine = PackedEngine(spec, dev, rebuild_every=10)
    st, overflow = engine.pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel)
    assert not overflow, "cell capacity overflow at pack (phase 26)"
    cvs = config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t)
            in enumerate(zip(cvs, order_values_plain(st, spec, cvs)))]
    fp = FLOP_PER_PAIR
    out = {}

    def fused_flops(sx, se, mask, mono):
        q6v, q6f = (("q6_mono_value", "q6_mono_force") if mono
                    else ("q6_value", "q6_force"))
        q6, co, lj = (pairs_within(se, sx, rc)
                      for rc in (cvs[0].r_cut, cvs[1].r_cut, sx.r_cut))
        q6m, com = (pairs_within(se, sx, rc, mask) if mask is not None
                    else p for rc, p in ((cvs[0].r_cut, q6),
                                         (cvs[1].r_cut, co)))
        return (lj * fp["lj"] + q6 * fp[q6f] + co * fp["coord_force"]
                + q6m * fp[q6v] + com * fp["coord_value"])

    for n_dev in (SPATIAL_SHARDS, 1):
        slabs, exts = spatial_ext_states(st, spec, n_dev, dev)
        sx = slabs.spec_ext
        tag = f"shards={n_dev} ext {sx.cells_per_dim}"
        summed = None
        for k, se in enumerate(exts):
            m = slabs.interior[k]
            first = k == 0
            # kernel 2 with the interior mask
            tk = order_values_cuda(se, sx, cvs, cell_mask=m)
            tp = order_values_plain(se, sx, cvs, cell_mask=m)
            torch.cuda.synchronize()
            err = lanes_close(f"{tag} values masked", cvs, tk, tp, 2e-5)
            summed = tk if summed is None else tuple(
                tuple(x + y for x, y in zip(u, v)) for u, v in zip(summed, tk))
            if first:
                q6m, com = (pairs_within(se, sx, cv.r_cut, m) for cv in cvs)
                out[("values masked", n_dev)] = (
                    err, cuda_ms(lambda: order_values_cuda(se, sx, cvs,
                                                           cell_mask=m)),
                    cuda_ms(lambda: order_values_plain(se, sx, cvs,
                                                       cell_mask=m),
                            calls=10),
                    *bound(12 * sx.n_pad + 4 * sx.n_cells,
                           q6m * fp["q6_value"] + com * fp["coord_value"]))
            # kernel 4 in the monomial mode, unmasked and masked
            for key, mask in (("fused mono", None), ("fused mono masked", m)):
                fk, gk, tk4 = fused_lj_order_force_cuda(
                    se, sx, cvs, auxs, mono=True, cell_mask=mask)
                fpl, gpl, tp4 = fused_lj_order_force_plain(
                    se, sx, cvs, auxs, mono=True, cell_mask=mask)
                torch.cuda.synchronize()
                ef, fmax = force_close(f"{tag} {key} f_lj", fk, fpl, 0.0, 1e-3)
                eg, gmax = force_close(f"{tag} {key} g", gk, gpl, 2e-3, 2e-4)
                el = lanes_close(f"{tag} {key} lanes", cvs, tk4, tp4, 2e-4)
                if first:
                    out[(key, n_dev)] = (
                        max(ef, eg, el),
                        cuda_ms(lambda: fused_lj_order_force_cuda(
                            se, sx, cvs, auxs, mono=True, cell_mask=mask)),
                        cuda_ms(lambda: fused_lj_order_force_plain(
                            se, sx, cvs, auxs, mono=True, cell_mask=mask),
                            calls=10),
                        *bound(36 * sx.n_pad + 4 * sx.n_cells * (
                            mask is not None),
                            fused_flops(sx, se, mask, True)))
                print(f"phase 26 {tag} shard {k} {key} kernel_vs_plain: "
                      f"max|df_lj|={ef:.3e} (max|f_lj|={fmax:.3e}) "
                      f"max|dg|={eg:.3e} (max|g|={gmax:.3e}) "
                      f"max|dlane|={el:.3e}")
            # kernel 1's energy and virial under the interior mask
            ak = packed_lj_force_cuda(se, sx, with_energy=True, cell_mask=m)
            bp = packed_lj_force(se, sx, with_energy=True, cell_mask=m)
            torch.cuda.synchronize()
            e1, line = pair_close(f"{tag} pair masked energy", ak, bp, True)
            if first:
                lj = pairs_within(se, sx, sx.r_cut)
                ljm = pairs_within(se, sx, sx.r_cut, m)
                out[("pair masked energy", n_dev)] = (
                    e1, cuda_ms(lambda: packed_lj_force_cuda(
                        se, sx, with_energy=True, cell_mask=m)),
                    cuda_ms(lambda: packed_lj_force(
                        se, sx, with_energy=True, cell_mask=m), calls=10),
                    *bound(pair_kernel_bytes(sx, True) + 4 * sx.n_cells,
                           lj * fp["lj"]
                           + ljm * (fp["lj_energy"] - fp["lj"])))
            print(f"phase 26 {tag} shard {k} values masked max|dlane|="
                  f"{err:.3e}; pair masked energy {line}")
        # the shards' masked sums against the unmasked kernel on the grid
        whole = order_values_cuda(st, spec, cvs)
        torch.cuda.synchronize()
        es = lanes_close(f"{tag} summed masked values", cvs, summed, whole,
                         2e-5)
        print(f"phase 26 {tag}: the shards' masked value sums vs the "
              f"unsharded kernel max|dlane|={es:.3e}")

    # kernel 4's monomial mode against its recurrence mode, whole grid
    fm, gm, tm = fused_lj_order_force_cuda(st, spec, cvs, auxs, mono=True)
    fr, gr, tr = fused_lj_order_force_cuda(st, spec, cvs, auxs)
    sm = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tm)])
    sr = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tr)])
    torch.cuda.synchronize()
    ds = float(((sm - sr).abs() / sr.abs()).max())
    el = lanes_close("mono vs recurrence lanes", cvs, tm, tr, 2e-5)
    assert ds <= 2e-5, (ds, sm, sr)
    ef, _ = force_close("mono vs recurrence f_lj", fm, fr, 0.0, 1e-3)
    eg, gmax = force_close("mono vs recurrence g", gm, gr, 2e-3, 2e-4)
    mono_ms = cuda_ms(lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                                        mono=True))
    rec_ms = cuda_ms(lambda: fused_lj_order_force_cuda(st, spec, cvs, auxs))
    fpl, gpl, tpl = fused_lj_order_force_plain(st, spec, cvs, auxs,
                                               mono=True)
    torch.cuda.synchronize()
    force_close("mono vs plain mono g, whole grid", gm, gpl, 2e-3, 2e-4)
    lanes_close("mono vs plain mono lanes, whole grid", cvs, tm, tpl, 2e-4)
    out[("fused mono", "whole")] = (
        max(ef, eg, el), mono_ms,
        cuda_ms(lambda: fused_lj_order_force_plain(st, spec, cvs, auxs,
                                                   mono=True), calls=10),
        *bound(36 * spec.n_pad, fused_flops(spec, st, None, True)))
    print(f"phase 26 fused mono vs recurrence N={n} whole grid: "
          f"rel_ds={ds:.3e} s_mono={sm.tolist()} s_rec={sr.tolist()} "
          f"max|dlane|={el:.3e} max|df_lj|={ef:.3e} max|dg|={eg:.3e} "
          f"(max|g|={gmax:.3e}) mono_ms={mono_ms:.4f} "
          f"recurrence_ms={rec_ms:.4f}")
    for (key, grid), v in out.items():
        print(f"phase 26 {key} [{grid}]: max_abs_err={v[0]:.3e} "
              f"kernel_ms={v[1]:.4f} plain_ms={v[2]:.4f} "
              f"bound_ms={v[3]:.5f} ({v[4]})")
    torch.cuda.empty_cache()
    return out


def spatial_slice(dev, smi: str, unsharded_rates: list) -> dict:
    """Phase 27: Config 3 on SpatialPackedEngine.  (1) 20 lagged steps at
    gamma = 0 with SPATIAL_SHARDS shards against PackedEngine, both on the
    kernels, from one state: positions to 1e-3, CV values rtol 1e-4, PE
    rtol 1e-5; (2) the sharded repack against repack_incremental on a
    displaced state, bit for bit; (3) Config 3 lagged timed with 1 and
    SPATIAL_SHARDS shards as phase 10 times it, with exact launches per
    stride; (4) the CLI with engine.spatial_devices = 2: a short run, on
    one card with both shards on it.  Returns {shards: (launches per timed run, rates, profile,
    launches of the timed sampler's construction)} and under "slice" the
    launches of (1)'s sharded run, construction included."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.ops.packed import (
        repack_incremental, unpack_positions,
    )
    from metadyn_tpu_torch.parallel.spatial import make_sharded_repack

    t27 = time.perf_counter()
    finals = []
    for cls in (PackedEngine, spatial_engine(SPATIAL_SHARDS)):
        reset_counts()
        s = config3_sampler(cls, dev, 32, mts_lag=True, gamma=0.0, stride=20)
        assert s is not None, "cell capacity overflow at pack (phase 27)"
        m = s.run(20)[-1]
        counts = read_counts()
        assert all(counts[k] > 0 for k in ("pair", "values", "fused")), counts
        if cls is not PackedEngine:
            # the slab path's variants: the seed's masked values, the
            # masked energy of each refresh, the masked mono fused kernel
            assert all(counts[k] > 0 for k in (
                "values masked", "pair masked", "fused mono masked")), counts
        finals.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                       np.asarray(m["cv"]), float(m["potential_energy"]),
                       counts))
    L = float(s.state.box.L_host[0])
    dpos = finals[0][0] - finals[1][0]
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    dcv = float(np.max(np.abs(finals[0][1] - finals[1][1])
                       / np.abs(finals[0][1])))
    dpe = abs(finals[0][2] - finals[1][2]) / abs(finals[0][2])
    assert dpos <= 1e-3 and dcv <= 1e-4 and dpe <= 1e-5, (dpos, dcv, dpe)
    print(f"phase 27 spatial shards={SPATIAL_SHARDS} vs PackedEngine "
          f"mts_lag gamma=0 20 steps: max|dpos|={dpos:.3e} rel_dcv={dcv:.3e} "
          f"rel_dPE={dpe:.3e} cv={finals[1][1].tolist()} "
          f"launches={finals[1][3]} (unsharded {finals[0][3]})")

    # the sharded repack, bit for bit, on the run's state displaced
    spec = s.engine.spec
    st = s.state
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    disp = 0.15 * torch.randn(st.r.shape, generator=gen, device=dev)
    st = st.replace(r=torch.where((st.pid < spec.n_real)[None], st.r + disp,
                                  st.r))
    ref, bad_ref = repack_incremental(st, spec)
    for n_dev in (1, SPATIAL_SHARDS):
        out, bad = make_sharded_repack(spec, [dev] * n_dev)(st)
        assert not bool(bad_ref) and not bool(bad), (bad_ref, bad)
        for k in ("r", "v", "f", "image", "pid", "typ", "slot_of"):
            assert torch.equal(getattr(out, k), getattr(ref, k)), k
        for k in ref.attrs:
            assert torch.equal(out.attrs[k], ref.attrs[k]), k
        moved = int((ref.pid != st.pid).sum())
        print(f"phase 27 sharded repack shards={n_dev}: bit for bit against "
              f"repack_incremental ({moved} of {spec.n_pad} slots changed; "
              f"attrs {sorted(ref.attrs)})")

    # Config 3 lagged, timed as phase 10 times it
    res = {"slice": finals[1][3]}
    for n_dev in (1, SPATIAL_SHARDS):
        got = {}
        counts = config3_timed(
            dev, True, warm=(2, 2), n_runs=2, n_timed=4,
            per_stride={"pair": 91 * n_dev, "pair masked": n_dev,
                        "fused": 10 * n_dev,
                        "fused mono masked": 10 * n_dev, "values": 2},
            smi=smi, engine_cls=spatial_engine(n_dev),
            tag=f"config3 mts_lag=True spatial shards={n_dev}", out=got)
        # the masked values kernel runs in the seed evaluation only
        assert got["build"]["values masked"] > 0, got["build"]
        res[n_dev] = (counts, got["rates"], got["profile"], got["build"])
    print(f"phase 27 config3 lagged particle-steps/s: unsharded (phase 10) "
          f"{unsharded_rates}; "
          + "; ".join(f"shards={k} {res[k][1]}" for k in (1, SPATIAL_SHARDS))
          + f" on {smi}; launches of the timed samplers' construction: "
          + "; ".join(f"shards={k} {res[k][3]}" for k in (1, SPATIAL_SHARDS)))

    # the CLI with engine.spatial_devices = 2: on the visible cards in
    # turn, so on one card both shards share it
    import tempfile
    import metadyn_tpu_torch.cli as cli
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    cfg = cli_yaml("config3_nucleation_2dcv", out_dir)
    cfg["engine"]["spatial_devices"] = 2
    n_cards = torch.cuda.device_count()
    # 13 x-planes at the YAML's skin 0.4 and cap 48 do not split in two:
    # bench_config3's spec (skin 0.3, cap 32: 14^3 cells); 500 steps, as
    # the fcc start's T dips to ~0.48 and returns to the band by ~400
    # (phase 10 warms 4 strides of 100)
    cfg["engine"].update(skin=0.3, cap=32)
    cfg["run"]["n_steps"] = 500
    t0 = time.perf_counter()
    run = cli.CliRun(cfg, device="cuda")
    run.run()
    bad = cli_checks("config3_nucleation_2dcv", cfg, run)
    assert not bad, bad
    shards = run.sampler.engine.devices
    print(f"phase 27 cli spatial_devices=2 on {n_cards} card(s), shards on "
          f"{[str(d) for d in shards]}: 500 steps in "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"spatial phase 27: {time.perf_counter() - t27:.1f} s")
    return res


def spatial_entries(sp_kern: dict, sp: dict, entry, keys) -> list:
    """The kernels line's entries of the slab path's variants (phases 26
    and 27): each timed on shard 0's extended grid of the 2-shard path,
    with the 1-shard grid (and, for the monomial mode, the whole unsharded
    grid) as variants; launches from phase 27's runs: ``launches`` is the
    timed 2-shard run's (4 strides), or, for the masked values kernel,
    which runs only in the sampler's seed evaluation, that sampler's
    construction."""
    n2 = SPATIAL_SHARDS
    per_stride = {n: sp[n][0] for n in (1, n2)}
    built = {n: sp[n][3] for n in (1, n2)}

    def grids(key):
        out = {f"shards={g} extended grid" if g != "whole" else
               "unsharded grid (62,500)": dict(zip(keys, v))
               for (k, g), v in sp_kern.items() if k == key}
        return out

    def by_path(count_key):
        out = {}
        for n in (1, n2):
            out[f"config3 mts_lag spatial shards={n} (4 timed strides)"] = \
                per_stride[n][count_key]
            out[f"config3 mts_lag spatial shards={n} (construction of the "
                "timed sampler)"] = built[n][count_key]
        out[f"config3 mts_lag spatial shards={n2}, 20 steps at gamma 0 "
            "(construction included)"] = sp["slice"][count_key]
        return out

    staged = "the staged block-per-cell kernel (csrc/cell_stage.cuh)"
    return [
        entry("packed_order_values cell_mask", "packed_order",
              "metadyn_tpu/ops/packed_order_pallas.py:257 (cell_mask: "
              ":258,263,274-294)", built[n2]["values masked"],
              sp_kern[("values masked", n2)],
              design=staged + "; each cell's partials row times its weight",
              launches_by_path=by_path("values masked"),
              variants=grids("values masked")),
        entry("packed_fused_lj_order mono", "packed_fused_lj_order",
              "metadyn_tpu/ops/packed_fused_pallas.py:296 (mono: :50-66,"
              "104-122,171-215,261-292)", per_stride[n2]["fused mono"],
              sp_kern[("fused mono", n2)],
              design=staged + "; Q_6 in the monomial basis, monomials "
              "built by degree halving in registers (the slab path runs "
              "it masked only)",
              launches_by_path=by_path("fused mono"),
              variants=grids("fused mono")),
        entry("packed_fused_lj_order mono cell_mask",
              "packed_fused_lj_order",
              "metadyn_tpu/ops/packed_fused_pallas.py:296 (mono + "
              "cell_mask: :306-310,332-337)",
              per_stride[n2]["fused mono masked"],
              sp_kern[("fused mono masked", n2)],
              design=staged + "; the monomial mode, each cell's partials "
              "row times its weight",
              launches_by_path=by_path("fused mono masked"),
              variants=grids("fused mono masked")),
        entry("packed_lj_force cell_mask energy", "packed_lj_force",
              "XLA packed_lj_force(cell_mask=) in the reference's spatial "
              "island, metadyn_tpu/parallel/spatial.py:276 (its Pallas "
              "kernel, packed_pallas2.py:301, is forces only there)",
              per_stride[n2]["pair masked"],
              sp_kern[("pair masked energy", n2)],
              design=staged + "; each block's energy and virial sums "
              "times its cell's weight",
              launches_by_path=by_path("pair masked"),
              variants=grids("pair masked energy")),
    ]


# Phase 28: the well-tempered ensemble (examples/config6_wte.yaml: the total
# potential energy is the CV; kernel 1 with energy and virial on every force
# call).  Path 2 is the YAML at init.n_cells 25 (62,500 particles) with its
# grid scaled per particle as the YAML's comment derives it: the range times
# N/2048, sigma times sqrt(N/2048) (energy fluctuations grow as sqrt(N)).
WTE_KT = 1.5
WTE_STRIDE = 25
# kT 1.5.  The kinetic T of a WTE run swings far more than the 2,048
# particles' sqrt(2/3N) = 1.8%: its bias force is dVds times the last force
# call's (biased) force, which feeds back on itself, as in the reference.
# The JAX package's CLI on the CPU ran the YAML at T 1.30-1.83 over strides
# 21-80 (mean 1.43, sd 0.10); the port's plain path on the CPU ended at
# 1.70, 1.53 and 1.43, the card's first run at 1.663
WTE_T_BAND = (1.1, 2.0)


def wte_sampler(dev, engine_cls, n_cells: int = 25, gamma: float = 1.0,
                stride: int = WTE_STRIDE, seed: int = 3):
    """examples/config6_wte.yaml built by hand at ``n_cells`` (the YAML's
    8 gives 2,048 particles): fcc a 1.72, packed LJ r_cut 2.5 unshifted,
    skin 0.4, a repack check every 5 steps, energy on every force call,
    PotentialEnergyCV on the 141-point well-tempered grid scaled per
    particle, W 3, deltaT 3000, Langevin dt 0.004 at kT 1.5; the CLI's
    velocities (seed 3)."""
    import numpy as np
    from metadyn_tpu_torch import (
        Box, GridSpec, HillSpec, MetadSampler, PackedSpec, PotentialEnergyCV,
        WELL_TEMPERED, fcc_lattice, make_packed_langevin_step, make_system,
    )
    pos = fcc_lattice(n_cells, 1.72)
    n, L = pos.shape[0], n_cells * 1.72
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, shift_energy=False)
    engine = engine_cls(spec, dev, rebuild_every=5, with_energy=True)
    vel = np.random.default_rng(seed).normal(
        0, np.sqrt(WTE_KT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    state, ovf = engine.pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf, "cell capacity overflow at pack"
    k = n / 2048
    grid = GridSpec.create([-16000.0 * k], [-2000.0 * k], [141],
                           [120.0 * np.sqrt(k)], dev)
    return MetadSampler(
        make_system(n, dev), state, engine, [PotentialEnergyCV(name="U")],
        grid, HillSpec.create(W=3.0, stride=stride, mode=WELL_TEMPERED,
                              deltaT=3000.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=WTE_KT,
                                            gamma=gamma),
        seed=seed, chunks_per_block=16)


def min_image_max(a, b, L: float) -> float:
    import numpy as np
    d = a - b
    d -= L * np.round(d / L)
    return float(np.abs(d).max())


def wte_phase(dev, smi: str) -> dict:
    """Phase 28 (paths 2 and 3): 20 steps at gamma 0 of the kernel engine
    against the plain-force engine from one start (positions 1e-3, U and
    the CV trace rtol 1e-5, stride 5 so 4 hills feed the bias); path 2
    timed (4 warm and 20 timed strides: exactly stride + 1 launches per
    stride, every one with energy; four profiled strides); then kernel 1
    with energy against its plain version on that run's state (the
    per-slot se/hs layout, 62,500); examples/config6_wte.yaml through the
    CLI as written.  Returns the kernel's variants and launches."""
    import tempfile
    import numpy as np
    import torch
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.cli import CliRun
    from metadyn_tpu_torch.ops.packed import unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.utils.profiling import device_profile

    t28 = time.perf_counter()
    L = 25 * 1.72
    runs = []
    for cls in (PackedEngine, plain_force_engine()):
        s = wte_sampler(dev, cls, gamma=0.0, stride=5)
        hist = s.run(20)
        spec, n = s.engine.spec, s.engine.spec.n_real
        runs.append((unpack_positions(s.state, spec).cpu().numpy(),
                     np.array([float(m["cv"][0]) for m in hist]),
                     float(hist[-1]["potential_energy"]), s.bias.n_hills))
    dpos = min_image_max(runs[0][0], runs[1][0], L)
    dcv = float(np.max(np.abs(runs[0][1] - runs[1][1])
                       / np.abs(runs[1][1])))
    du = abs(runs[0][2] - runs[1][2]) / abs(runs[1][2])
    assert runs[0][3] == runs[1][3] == 4, (runs[0][3], runs[1][3])
    assert dpos <= 1e-3 and dcv <= 1e-5 and du <= 1e-5, (dpos, dcv, du)
    print(f"wte slice_kernel_vs_plain gamma=0 20 steps (stride 5): "
          f"max|dpos|={dpos:.3e} CV trace max rel={dcv:.3e} rel_dU="
          f"{du:.3e} cv={runs[0][1].tolist()}")

    s = wte_sampler(dev, PackedEngine)
    s.run(4 * WTE_STRIDE)
    n_timed = 20
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.energy_launches = 0
    t0 = time.perf_counter()
    hist = s.run(n_timed * WTE_STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = packed_lj_force_cuda.launches
    energy = packed_lj_force_cuda.energy_launches
    counts = read_counts()
    want = n_timed * (WTE_STRIDE + 1)
    assert launches == energy == want, (launches, energy, want)
    assert counts == {**{k: 0 for k in counts}, "pair": want}, counts
    for m in hist:
        for k in ("cv", "bias_V", "hill_height", "temperature"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert not m["nlist_overflow"] and not m["cell_width_violation"], m
    last = hist[-1]
    rate = n * WTE_STRIDE * n_timed / dt
    prof = device_profile(lambda: s.run(4 * WTE_STRIDE))
    busy = prof["busy_ms"] / 4
    untraced_ms = 1e3 * dt / n_timed
    print(f"wte N={n}: {n_timed} strides of {WTE_STRIDE} {dt:.3f} s "
          f"{rate:.1f} particle-steps/s launches={launches} (with energy "
          f"{energy}, {want // n_timed} per stride) U/N="
          f"{float(last['cv'][0]) / n:.4f} T={float(last['temperature']):.4f}"
          f" hills={s.bias.n_hills} on {smi}")
    print(f"profile wte N={n} four strides: busy_ms per stride={busy:.3f} "
          f"untraced stride ms={untraced_ms:.3f} busy share untraced="
          f"{busy / untraced_ms:.3f} {json.dumps(prof)} on {smi}")
    # the kernel against its plain version on the run's state (the fcc
    # start's forces nearly cancel: no test of the force there)
    variants = pair_kernel_vs_plain(f"wte N={n} after 28 strides", "se_hs",
                                    s.state, spec, 0)
    del s

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_wte_"))
    cfg = cli_yaml("config6_wte", tmp)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runner = CliRun(cfg, device=dev)
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli_counts = read_counts()
    bad = cli_checks("config6_wte", cfg, runner, band=WTE_T_BAND)
    n_cli = runner.sampler.engine.spec.n_real
    strides = runner.n_steps // WTE_STRIDE
    if cli_counts["pair"] != 2 + strides * (WTE_STRIDE + 1):
        bad.append(f"launches {cli_counts}")
    t_last = float(runner.sampler.history[-1]["temperature"])
    print(f"cli config6_wte: N={n_cli} {runner.n_steps} steps wall "
          f"{wall:.3f} s (build and run) T_last={t_last:.4f} hills="
          f"{runner.sampler.bias.n_hills} launches={cli_counts['pair']} "
          f"checks failed={bad} on {smi}")
    shutil.rmtree(tmp, ignore_errors=True)
    assert not bad, bad
    print(f"wte phase 28: {time.perf_counter() - t28:.1f} s")
    return {"variants": variants, "launches": launches,
            "cli_launches": cli_counts["pair"]}


# Phase 29: multiple walkers on the one card (parallel/walkers.py), kernel 1
# launched once per force call over the walker batch.  Path 1 is bench.py's
# liquid (liq64k) times WALKERS, each walker from the same positions with
# fresh velocities from seed 1000 + w (the CLI's); C4_T_BAND holds
# examples/config4_walkers.yaml's T of the last stride (kT 1, 200 steps
# from the fcc start, T still climbing back from its first-stride dip: the
# port's plain path on the CPU gave 0.79-0.87 over the 8 walkers)
WALKERS = 8
C4_T_BAND = (0.7, 1.0)


def liq_walker_states(dev, spec, engine, cvs, W: int, noise: float = 0.0):
    """W packed walkers of liq64k: the same positions (plus ``noise`` times
    a normal draw per walker, so kernel checks see walkers that differ)
    and fresh Maxwell-Boltzmann velocities at KT from seed 1000 + w."""
    import numpy as np
    from metadyn_tpu_torch import Box
    d = np.load(ROOT / "bench_data" / "liq64k.npz")
    pos, L = d["pos"], float(d["L"])
    n = pos.shape[0]
    amps = {cv.attr_name: np.ones(n, np.float32) for cv in cvs}
    out = []
    for w in range(W):
        rng = np.random.default_rng(1000 + w)
        vel = rng.normal(0, np.sqrt(KT), (n, 3)).astype(np.float32)
        vel -= vel.mean(axis=0)
        p = pos + noise * rng.normal(size=pos.shape).astype(np.float32)
        st, ovf = engine.pack_state(
            p, Box.cubic(L, dev), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, np.float32), vel=vel,
            extra_attrs=amps)
        assert not ovf, "cell capacity overflow at pack"
        out.append(st)
    return out


def liq_parts(dev):
    """bench.py's spec, CVs, grid and walls on the card."""
    import numpy as np
    from metadyn_tpu_torch import (
        GridSpec, PackedLamellar, PackedSpec, WallSpec,
    )
    d = np.load(ROOT / "bench_data" / "liq64k.npz")
    n, L = d["pos"].shape[0], float(d["L"])
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    cvs = [PackedLamellar.create([[0, 0, 3]], n, dev, name="a"),
           PackedLamellar.create([[0, 3, 0]], n, dev, name="b")]
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004], dev)
    return spec, cvs, gspec, WallSpec.at_grid_edges(gspec, k=2000.0)


def walkers_phase(dev, smi: str, single_rate: float) -> dict:
    """Phase 29 (paths 1, 3 and 4): kernel 1's walker batch (W = 8 on
    liq64k + noise 0.02 per walker) against 8 single launches, to the bit,
    and against the plain batched version (phase 3's gates), with times
    and bounds; WalkerSampler with W = 2, add_hills=False, gamma 0 against
    two MetadSamplers under the same frozen grid (20 steps, positions to
    1e-4); path 1 timed (1 warm and 2 timed strides: 501 launches per
    stride, 8 walkers each; one device-to-host read per rebuild block;
    n_hills 8 per stride; one profiled stride); examples/config4_walkers.
    yaml through the CLI with its resume leg, bit for bit; the flux
    walkers on the double well (one period, pooled histograms)."""
    import tempfile
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        AxisPosition, Box, FluxTemperedSampler, ForceField, GridSpec,
        HillSpec, MetadSampler, PackedEngine, WalkerSampler, WELL_TEMPERED,
        make_langevin_step, make_packed_langevin_step, make_state,
        make_system,
    )
    from metadyn_tpu_torch.bias.metad import BiasState, deposit
    from metadyn_tpu_torch.cli import CliRun
    from metadyn_tpu_torch.core import packed_engine
    from metadyn_tpu_torch.core.batch import stack_walkers, walker
    from metadyn_tpu_torch.io.grid_file import load_grid
    from metadyn_tpu_torch.ops.packed import packed_lj_force, unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.utils.profiling import device_profile

    t29 = time.perf_counter()
    spec, cvs, gspec, walls = liq_parts(dev)
    n = spec.n_real
    engine = PackedEngine(spec, dev, rebuild_every=10)
    states = liq_walker_states(dev, spec, engine, cvs, WALKERS, noise=0.02)
    batch = stack_walkers(states)
    pairs = [pairs_within(st, spec, spec.r_cut) for st in states]
    out = {"variants": {}}
    for we in (False, True):
        a = packed_lj_force_cuda(batch, spec, with_energy=we)
        one = [packed_lj_force_cuda(st, spec, with_energy=we)
               for st in states]
        same = all(torch.equal(a.f[w], one[w].f) for w in range(WALKERS))
        if we:
            same &= all(torch.equal(a.potential_energy[w],
                                    one[w].potential_energy)
                        and torch.equal(a.virial[w], one[w].virial)
                        for w in range(WALKERS))
        assert same, f"walker batch with_energy={we} differs from single " \
                     "launches"
        b = packed_lj_force(batch, spec, with_energy=we)
        torch.cuda.synchronize()
        errs = [pair_close(f"walkers w={w}", walker(a, w), walker(b, w), we)
                for w in range(WALKERS)]
        err = max(e[0] for e in errs)
        del a, b, one
        ms = cuda_ms(lambda: packed_lj_force_cuda(batch, spec,
                                                  with_energy=we))
        ms_one = cuda_ms(lambda: [packed_lj_force_cuda(st, spec,
                                                       with_energy=we)
                                  for st in states])
        plain = cuda_ms(lambda: packed_lj_force(batch, spec, with_energy=we),
                        calls=3, warm=1)
        kind = spec.pair_kind + ("_energy" if we else "")
        bms, by = bound(WALKERS * pair_kernel_bytes(spec, we),
                        sum(pairs) * FLOP_PER_PAIR[kind])
        key = f"sentinel W={WALKERS} liq64k{' +energy' if we else ''}"
        out["variants"][key] = (err, ms, plain, bms, by)
        out["variants"][f"{key} as {WALKERS} single launches"] = (
            0.0, ms_one, plain, bms, by)
        print(f"walker batch W={WALKERS} N={n} with_energy={we}: equal to "
              f"{WALKERS} single launches to the bit={same}; vs plain "
              f"batched: {errs[int(np.argmax([e[0] for e in errs]))][1]} "
              f"batch_ms={ms:.4f} single_launches_ms={ms_one:.4f} "
              f"plain_ms={plain:.4f} bound_ms={bms:.5f} ({by}; "
              f"{sum(pairs)} pairs within r_cut over the walkers) on {smi}")
    del batch, states
    torch.cuda.empty_cache()

    def build(W, bias_every, gamma=1.0, stride=STRIDE, bias=None,
              add_hills=True, seed=0):
        eng = PackedEngine(spec, dev, rebuild_every=10)
        return WalkerSampler(
            make_system(n, dev),
            stack_walkers(liq_walker_states(dev, spec, eng, cvs, W)), eng,
            cvs, gspec, HillSpec.create(W=0.1, stride=stride,
                                        mode=WELL_TEMPERED, deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT,
                                                gamma=gamma),
            seed=seed, walls=walls, initial_bias=bias, add_hills=add_hills,
            bias_every=bias_every, chunks_per_block=8)

    # W = 2 under a frozen grid against two single samplers
    frozen = BiasState.zeros(gspec)
    for c in ((0.0, 0.0), (0.004, -0.002), (-0.003, 0.001)):
        frozen, _ = deposit(HillSpec.create(W=0.1, stride=1), frozen,
                            torch.tensor(c, device=dev), 0)
    ws = build(2, 5, gamma=0.0, stride=20, bias=frozen, add_hills=False)
    ws.run(20)
    eng1 = PackedEngine(spec, dev, rebuild_every=10)
    starts = liq_walker_states(dev, spec, eng1, cvs, 2)
    dmax = 0.0
    for w in range(2):
        single = MetadSampler(
            make_system(n, dev), starts[w], eng1, cvs, gspec,
            HillSpec.create(W=0.1, stride=20, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT,
                                                gamma=0.0),
            walls=walls, initial_bias=frozen, add_hills=False, bias_every=5)
        single.run(20)
        dmax = max(dmax, min_image_max(
            unpack_positions(walker(ws.states, w), spec).cpu().numpy(),
            unpack_positions(single.state, spec).cpu().numpy(),
            float(single.state.box.L_host[0])))
    assert dmax <= 1e-4 and ws.bias.n_hills == frozen.n_hills, dmax
    print(f"walkers W=2 add_hills=False gamma=0 20 steps against two "
          f"MetadSamplers under the same frozen grid: max|dpos|={dmax:.3e}")
    del ws

    # path 1: 8 x liq64k timed
    s = build(WALKERS, 5)
    s.run(STRIDE)
    hills0 = s.bias.n_hills
    n_timed = 2
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.walkers = 0
    t0 = time.perf_counter()
    hist = s.run(n_timed * STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["pair"]
    walker_launches = packed_lj_force_cuda.walkers
    assert launches == n_timed * (STRIDE + 1), counts
    assert counts == {**{k: 0 for k in counts}, "pair": launches}, counts
    assert walker_launches == WALKERS * launches, walker_launches
    assert s.bias.n_hills - hills0 == WALKERS * n_timed, s.bias.n_hills
    for m in hist:
        for k in ("cv", "bias_V", "hill_height", "temperature",
                  "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert m["cv"].shape == (WALKERS, 2), m["cv"].shape
        assert not m["nlist_overflow"].any(), m
        assert not m["cell_width_violation"].any(), m
        assert ((0.9 < m["temperature"]) & (m["temperature"] < 1.1)).all(), m
        assert (m["hill_height"] > 0).all(), m
    rate = WALKERS * n * STRIDE * n_timed / dt
    last = hist[-1]
    out.update(launches=launches, rate=rate)
    print(f"walkers {WALKERS} x liq64k bias_every=5: {n_timed} strides "
          f"{dt:.3f} s {rate:.1f} particle-steps/s summed over walkers "
          f"({rate / single_rate:.3f} x phase 5's single liquid "
          f"{single_rate:.1f}) launches={launches} ({launches // n_timed} "
          f"per stride, {walker_launches} walker-launches) hills/stride="
          f"{(s.bias.n_hills - hills0) // n_timed} T="
          f"{np.round(last['temperature'], 4).tolist()} on {smi}")
    # the host's reads of the stride: one repack check per rebuild block
    # (each reads the (W,) flags once: PackedEngine._rebuild_walkers),
    # counted where the engine calls it; the profiler's device-to-host
    # copies (those reads and the metrics' one transfer) are the
    # cross-check (in one run it caught 50 of the 51)
    n_blocks = STRIDE // 10
    checks = [0]
    real = packed_engine.needs_repack

    def counted(*a, **kw):
        checks[0] += 1
        return real(*a, **kw)

    packed_engine.needs_repack = counted
    try:
        prof = device_profile(lambda: s.run(STRIDE))
    finally:
        packed_engine.needs_repack = real
    untraced_ms = 1e3 * dt / n_timed
    prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
    print(f"profile walkers {WALKERS} x liq64k one stride: "
          f"{json.dumps(prof)}; repack checks {checks[0]} for {n_blocks} "
          f"rebuild blocks (one read of the {WALKERS} walkers' flags "
          f"each), device-to-host copies {prof['d2h_count']} (the checks "
          f"and 1 metrics transfer) on {smi}")
    assert checks[0] == n_blocks, checks
    assert prof["d2h_count"] <= n_blocks + 1, prof["d2h_count"]
    del s
    torch.cuda.empty_cache()

    # config4_walkers.yaml through the CLI, as written, then its resume leg
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_walkers_"))
    (tmp / "run").mkdir()
    cfg = cli_yaml("config4_walkers", tmp / "run")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = CliRun(cfg, device=dev)
    runner.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli_counts = read_counts()
    bad = cli_checks("config4_walkers", cfg, runner, band=C4_T_BAND)
    stride4 = int(cfg["metadynamics"]["stride"])
    if cli_counts["pair"] != 2 + (runner.n_steps // stride4) * (stride4 + 1):
        bad.append(f"launches {cli_counts}")
    w4 = runner.sampler.n_walkers
    print(f"cli config4_walkers: {w4} walkers x "
          f"{runner.sampler.engine.spec.n_real} {runner.n_steps} steps wall "
          f"{wall:.3f} s T_last="
          f"{np.round(runner.sampler.history[-1]['temperature'], 4).tolist()}"
          f" hills={runner.sampler.bias.n_hills} launches="
          f"{cli_counts['pair']} checks failed={bad} on {smi}")
    legs = {}
    for leg in ("resumed", "straight"):
        d = tmp / f"resume_{leg}"
        d.mkdir()
        cfg = cli_yaml("config4_walkers", d, checkpoint="ck.npz",
                       grid_file="grid.npz")
        k = int(cfg["run"]["n_steps"])
        if leg == "straight":
            cfg["run"]["n_steps"] = 2 * k
            CliRun(cfg, device=dev).run()
        else:
            CliRun(cfg, device=dev).run()
            CliRun(cfg, resume=True, device=dev).run()
        legs[leg] = cfg["output"]
    same_hills = (open(legs["resumed"]["hill_file"], "rb").read()
                  == open(legs["straight"]["hill_file"], "rb").read())
    va = load_grid(legs["resumed"]["grid_file"])[0].grid.V
    vb = load_grid(legs["straight"]["grid_file"])[0].grid.V
    if not (same_hills and torch.equal(va, vb)):
        bad.append(f"resume leg: hill files equal {same_hills}, max|dV| "
                   f"{float((va - vb).abs().max()):.3e}")
    print(f"cli config4_walkers resume leg: {k} + {k} steps (--resume) "
          f"against {2 * k} straight: hill files equal={same_hills} grid V "
          f"bitwise equal={torch.equal(va, vb)}")
    shutil.rmtree(tmp, ignore_errors=True)
    assert not bad, bad

    # the flux walkers on the double well (tests/test_flux_walkers.py's):
    # the callable engine on the card
    system = make_system(1, dev)

    def dw(pos, state, system):
        x = pos[0, 0]
        return (3.0 * (x * x - 1.0) ** 2
                + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2))

    st0 = make_state(np.asarray([[1.0, 0.0, 0.0]], np.float32),
                     Box.cubic(50.0, dev), device=dev)
    fs = FluxTemperedSampler(
        system, stack_walkers([st0] * 4),
        ForceField(external=dw, device=dev).bind(system),
        [AxisPosition(0, 0, name="x")],
        GridSpec.create([-1.5], [1.5], [61], [0.1], dev),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=0.6, gamma=2.0),
        kT=0.6, stride=50, update_period=4, seed=0, min_round_trips=0)
    fs.begin_measurement()
    t0 = time.perf_counter()
    h = fs.run(200)
    dtf = time.perf_counter() - t0
    V = fs.bias.grid.V.cpu().numpy()
    pooled = float(fs._meas_h.sum())
    assert fs.n_updates == 1 and pooled == 4 * 200, (fs.n_updates, pooled)
    assert np.isfinite(V).all() and np.abs(V).max() > 0, V
    print(f"flux walkers: 4 walkers on the double well, one period (stride "
          f"50 x 4) {dtf:.3f} s, pooled visits {pooled:g}, round trips "
          f"{h[-1]['round_trips']:g}, |V|max={np.abs(V).max():.4f}, x_last="
          f"{np.round(h[-1]['cv'][:, -1, 0], 4).tolist()} on {smi}")
    print(f"walkers phase 29: {time.perf_counter() - t29:.1f} s")
    return out


# Phases 30-34: the moving box and the walkers x space product.  The NPT
# phases run bench.py's liquid on 13^3 cells (cap 48, Npad 105,456): its
# 14^3 cells are 3.054 wide against r_list 3.05, so the barostat's first
# compression would trip the cell-width check (the reference's caveat,
# metadyn_tpu/integrate/packed.py:108-113); 13^3 cells are 3.288 wide, 7.8%
# of headroom.  Pressure: the liquid's own mean NVT pressure over the warm
# strides of phase 30.  The SCR barostat's time scale: tau_p 2, kappa 0.1
# (the reference's defaults).
NPT_CELLS = 13
NPT_CAP = 48
NPT_STRIDE = 100
NPT_WARM = 4
NPT_TAU_P = 2.0
# the box over the timed strides: the barostat moves it, within 2% of the
# start at 62,500 particles
NPT_L_BAND = 0.02
WALKERS_NPT = 4
# the WTE walkers' kinetic T swings around kT under their bias force (phase
# 28's band, centred on kT 1)
NPT_WTE_T_BAND = (0.7, 1.3)
WALKERS_DD = 4
SLABS = 2


def npt_spec(dev):
    """bench.py's liquid spec on 13^3 cells, with its CVs, grid and
    walls."""
    import dataclasses
    spec, cvs, gspec, walls = liq_parts(dev)
    return (dataclasses.replace(spec, cells_per_dim=(NPT_CELLS,) * 3,
                                cap=NPT_CAP), cvs, gspec, walls)


def pressure_of(state, spec, mass: float = 1.0):
    """The instantaneous pressure (Σ m v² + Σ W_d) / 3V; (W,) for a walker
    batch (a device tensor)."""
    import torch
    valid = (state.pid < spec.n_real).to(torch.float32)[..., None, :]
    ke2 = mass * torch.sum(state.v * state.v * valid, dim=(-2, -1))
    return (ke2 + state.virial.sum(-1)) / (3.0 * state.box.volume)


def npt_sampler(dev, spec, cvs, gspec, walls, state, pressure, engine_cls,
                gamma: float = 1.0, stride: int = NPT_STRIDE,
                bias_every: int = 5, seed: int = 0):
    """bench.py's sampler on ``state`` under isotropic SCR-NPT at
    ``pressure`` (kernel 1 with energy and virial on every force call)."""
    from metadyn_tpu_torch import (
        HillSpec, MetadSampler, WELL_TEMPERED, make_system,
    )
    from metadyn_tpu_torch.integrate.packed import make_packed_npt_scr_step
    engine = engine_cls(spec, dev, rebuild_every=10, with_energy=True)
    return MetadSampler(
        make_system(spec.n_real, dev), state, engine, cvs, gspec,
        HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_npt_scr_step(
            f, spec, dt=0.005, kT=KT, pressure=pressure, gamma=gamma,
            tau_p=NPT_TAU_P, engine=engine),
        seed=seed, bias_every=bias_every, walls=walls, chunks_per_block=8)


def npt_phase(dev, smi: str, nvt_d2h: int) -> dict:
    """Phase 30: NPT at 62,500.  The liquid under NVT on 13^3 cells (kernel
    1 with energy) for NPT_WARM strides, its mean pressure measured at each
    stride's end; 20 steps of SCR-NPT at gamma 0 (barostat noise from the
    same generator) of the kernel engine against the plain-force engine
    (positions 1e-3, box L rtol 1e-5); the NPT run timed (1 warm and 2
    timed strides of 500, bias_every 5: exactly 501 launches per stride,
    every one with energy; the box trace; no cell-width violation; T in
    0.9-1.1) and one profiled stride, whose device-to-host copies must not
    exceed phase 5's NVT liquid's (``nvt_d2h``); then kernel 1 (a) with
    energy against its plain version on the moved box, read from device
    memory.  Returns the pressure, the state and the kernel's numbers."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        HillSpec, MetadSampler, PackedEngine, WELL_TEMPERED,
        make_packed_langevin_step, make_system,
    )
    from metadyn_tpu_torch.ops.packed import unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.utils.profiling import device_profile

    t30 = time.perf_counter()
    spec, cvs, gspec, walls = npt_spec(dev)
    n = spec.n_real
    starts = liq_walker_states(dev, spec, PackedEngine(spec, dev), cvs, 1)
    # NVT warm strides, the pressure at each stride's end
    eng = PackedEngine(spec, dev, rebuild_every=10, with_energy=True)
    nvt = MetadSampler(
        make_system(n, dev), starts[0], eng, cvs, gspec,
        HillSpec.create(W=0.1, stride=NPT_STRIDE, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT),
        seed=0, bias_every=5, walls=walls, chunks_per_block=8)
    ps = []
    for _ in range(NPT_WARM):
        nvt.run(NPT_STRIDE)
        ps.append(float(pressure_of(nvt.state, spec)))
    p0 = float(np.mean(ps))
    start = nvt.state
    print(f"npt N={n}: {NPT_CELLS}^3 cells (width "
          f"{float(start.box.L[0]) / NPT_CELLS:.4f} against r_list "
          f"{spec.r_list:.2f}), cap {spec.cap}, Npad {spec.n_pad}; NVT "
          f"pressure over {NPT_WARM} strides of {NPT_STRIDE}: "
          f"{np.round(ps, 5).tolist()} mean {p0:.5f}")
    del nvt

    # 20 steps at gamma 0: kernel engine against the plain-force engine
    runs = []
    for cls in (PackedEngine, plain_force_engine()):
        s = npt_sampler(dev, spec, cvs, gspec, walls, start, p0, cls,
                        gamma=0.0, stride=20)
        s.run(20)
        runs.append((unpack_positions(s.state, spec).cpu().numpy(),
                     s.state.box.L.cpu().numpy()))
        assert not s.state.box.fixed
    dL = float(np.max(np.abs(runs[0][1] - runs[1][1]) / runs[1][1]))
    dpos = min_image_max(runs[0][0], runs[1][0], float(runs[1][1][0]))
    moved = float(np.max(np.abs(runs[1][1] / float(start.box.L[0]) - 1)))
    assert dpos <= 1e-3 and dL <= 1e-5 and moved > 0.0, (dpos, dL, moved)
    print(f"npt slice_kernel_vs_plain gamma=0 20 steps: max|dpos|="
          f"{dpos:.3e} box L rel={dL:.3e} (the box moved by {moved:.3e})")

    # timed
    s = npt_sampler(dev, spec, cvs, gspec, walls, start, p0, PackedEngine,
                    stride=STRIDE)
    s.run(STRIDE)
    n_timed = 2
    L0 = s.state.box.L.cpu().numpy()
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.energy_launches = 0
    t0 = time.perf_counter()
    hist = s.run(n_timed * STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    energy = packed_lj_force_cuda.energy_launches
    want = n_timed * (STRIDE + 1)
    assert counts == {**{k: 0 for k in counts}, "pair": want}, counts
    assert energy == want, energy
    for m in hist:
        for k in ("cv", "bias_V", "temperature", "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert not m["nlist_overflow"] and not m["cell_width_violation"], m
        assert 0.9 < float(m["temperature"]) < 1.1, m
    L1 = s.state.box.L.cpu().numpy()
    assert np.all(np.abs(L1 / L0 - 1) < NPT_L_BAND) and not np.array_equal(
        L0, L1), (L0, L1)
    rate = n * STRIDE * n_timed / dt
    print(f"npt N={n} P={p0:.5f} bias_every=5: {n_timed} strides {dt:.3f} s "
          f"{rate:.1f} particle-steps/s launches={counts['pair']} (with "
          f"energy {energy}, {want // n_timed} per stride) box L "
          f"{L0[0]:.5f} -> {L1[0]:.5f} T={float(hist[-1]['temperature']):.4f}"
          f" P_end={float(pressure_of(s.state, spec)):.5f} on {smi}")
    prof = device_profile(lambda: s.run(STRIDE))
    untraced_ms = 1e3 * dt / n_timed
    prof["busy_share_untraced"] = prof["busy_ms"] / untraced_ms
    print(f"profile npt N={n} one stride: {json.dumps(prof)}; device-to-"
          f"host copies {prof['d2h_count']} against phase 5's NVT liquid "
          f"{nvt_d2h} on {smi}")
    assert prof["d2h_count"] <= nvt_d2h, (prof["d2h_count"], nvt_d2h)
    variants = pair_kernel_vs_plain(
        f"npt N={n} after {4 + n_timed} strides, the box moved on the device",
        "sentinel device box", s.state, spec, 0, cutoff=True)
    out = {"pressure": p0, "state": s.state, "launches": counts["pair"],
           "rate": rate, "variants": variants}
    del s
    torch.cuda.empty_cache()
    print(f"npt phase 30: {time.perf_counter() - t30:.1f} s")
    return out


def box_meta_phase(dev, smi: str, npt: dict) -> dict:
    """Phase 31: box metadynamics and the MSD CV at 62,500, from phase
    30's NPT state.  (1) AspectRatio biased under anisotropic SCR-NPT with
    box_bias (a two-argument integrator factory, bias_every 1): 3 strides
    of 100, the CV equal to L_x / L_y of the box, 3 hills, the box's shape
    moved, exactly 101 launches per stride with energy.  (2) PackedMSD
    biased under isotropic SCR-NPT: 2 strides of 100, its value against
    the plain version (float64 on the host from the unwrapped positions of
    the run's state and the packed reference positions, rtol 1e-5)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        GridSpec, HillSpec, MetadSampler, PackedEngine, WELL_TEMPERED,
        make_system,
    )
    from metadyn_tpu_torch.cv.aspect_ratio import AspectRatio, box_bias_fn_for
    from metadyn_tpu_torch.cv.packed import PackedMSD, msd_reference_attrs
    from metadyn_tpu_torch.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu_torch.ops.packed import pack_host

    t31 = time.perf_counter()
    spec, _, _, _ = npt_spec(dev)
    n, p0, st0 = spec.n_real, npt["pressure"], npt["state"]
    cv = AspectRatio()
    eng = PackedEngine(spec, dev, rebuild_every=10, with_energy=True)
    grid = GridSpec.create([0.9], [1.1], [81], [0.005], dev)

    def factory(f, bias):
        return make_packed_npt_scr_step(
            f, spec, dt=0.005, kT=KT, pressure=p0, tau_p=NPT_TAU_P,
            anisotropic=True, box_bias_fn=box_bias_fn_for(cv, bias),
            engine=eng)

    s = MetadSampler(make_system(n, dev), st0, eng, [cv], grid,
                     HillSpec.create(W=1.0, stride=NPT_STRIDE,
                                     mode=WELL_TEMPERED, deltaT=10.0),
                     factory, seed=1, chunks_per_block=8)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = s.run(3 * NPT_STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {**{k: 0 for k in counts},
                      "pair": 3 * (NPT_STRIDE + 1)}, counts
    L = s.state.box.L.cpu().numpy()
    cvv = [float(m["cv"][0]) for m in hist]
    assert s.bias.n_hills == 3 and all(np.isfinite(cvv)), (s.bias.n_hills,
                                                          cvv)
    assert abs(cvv[-1] - L[0] / L[1]) <= 1e-6 and L[0] != L[1], (cvv, L)
    for m in hist:
        assert not m["nlist_overflow"] and not m["cell_width_violation"], m
    print(f"box metadynamics N={n} (AspectRatio, anisotropic SCR, "
          f"box_bias): 3 strides of {NPT_STRIDE} {dt:.3f} s "
          f"{n * 3 * NPT_STRIDE / dt:.1f} particle-steps/s cv={cvv} box L="
          f"{np.round(L, 5).tolist()} hills={s.bias.n_hills} "
          f"launches={counts['pair']} on {smi}")
    box_launches = counts["pair"]
    del s

    # the MSD CV, its reference positions the phase-30 state's unwrapped
    # positions, packed with the slots
    from metadyn_tpu_torch.ops.packed import unpack_positions
    ref = (unpack_positions(st0, spec) + st0.image[:, st0.slot_of.long()]
           .T.to(torch.float32) * st0.box.L).cpu().numpy()
    vel = st0.v[:, st0.slot_of.long()].T.cpu().numpy()
    box = st0.box
    st, ovf = pack_host(unpack_positions(st0, spec).cpu().numpy(),
                        type(box).from_lengths(*box.L.tolist(), dev), spec,
                        np.zeros(n, np.int32), np.ones(n, np.float32),
                        np.ones(n, np.float32), dev, vel=vel,
                        image=st0.image[:, st0.slot_of.long()].T.cpu()
                        .numpy(),
                        extra_attrs=msd_reference_attrs(ref))
    assert not ovf
    msd = PackedMSD(n_real=n)
    eng = PackedEngine(spec, dev, rebuild_every=10, with_energy=True)
    s = MetadSampler(
        make_system(n, dev), st, eng, [msd],
        GridSpec.create([0.0], [2.0], [81], [0.02], dev),
        HillSpec.create(W=0.5, stride=NPT_STRIDE, mode=WELL_TEMPERED,
                        deltaT=10.0),
        lambda f: make_packed_npt_scr_step(f, spec, dt=0.005, kT=KT,
                                           pressure=p0, tau_p=NPT_TAU_P,
                                           engine=eng),
        seed=2, bias_every=5, chunks_per_block=8)
    t0 = time.perf_counter()
    hist = s.run(2 * NPT_STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fin = s.state
    uw = (unpack_positions(fin, spec).double()
          + fin.image[:, fin.slot_of.long()].T.double()
          * fin.box.L.double()).cpu().numpy()
    plain = float(np.mean(np.sum((uw - ref) ** 2, axis=1)))
    got = float(msd.value(fin, None))
    rel = abs(got - plain) / plain
    assert rel <= 1e-5 and float(hist[-1]["cv"][0]) > 0.0, (got, plain)
    print(f"msd N={n} (PackedMSD biased, isotropic SCR): 2 strides of "
          f"{NPT_STRIDE} {dt:.3f} s cv={[float(m['cv'][0]) for m in hist]} "
          f"value {got:.7f} against the plain float64 {plain:.7f} "
          f"(rel {rel:.3e}) hills={s.bias.n_hills} on {smi}")
    del s
    torch.cuda.empty_cache()
    print(f"box phase 31: {time.perf_counter() - t31:.1f} s")
    return {"launches": box_launches}


def npt_walkers_phase(dev, smi: str, npt: dict) -> dict:
    """Phase 32: NPT walkers.  WALKERS_NPT x the liquid on 13^3 cells under
    isotropic SCR-NPT at phase 30's pressure with the WTE energy CV (phase
    28's grid scaled per particle), one batch, every walker its own box.
    After one warm stride of 100 (the boxes then differ): kernel 1 on the
    batch against WALKERS_NPT single launches to the bit, and against the
    plain batched version (phase 3's gates), with times and the bound;
    then 4 timed strides of 100 (exactly 101 launches per stride, every one
    with energy, for all walkers), the rate summed over walkers."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        GridSpec, HillSpec, PackedEngine, PotentialEnergyCV, WalkerSampler,
        WELL_TEMPERED, make_system,
    )
    from metadyn_tpu_torch.core.batch import stack_walkers, walker
    from metadyn_tpu_torch.integrate.packed import make_packed_npt_scr_step
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

    t32 = time.perf_counter()
    spec, _, _, _ = npt_spec(dev)
    n, W = spec.n_real, WALKERS_NPT
    eng = PackedEngine(spec, dev, rebuild_every=10, with_energy=True)
    states = stack_walkers(liq_walker_states(dev, spec, eng, [], W))
    k = n / 2048
    grid = GridSpec.create([-16000.0 * k], [-2000.0 * k], [141],
                           [120.0 * np.sqrt(k)], dev)
    s = WalkerSampler(
        make_system(n, dev), states, eng, [PotentialEnergyCV(name="U")],
        grid, HillSpec.create(W=3.0, stride=NPT_STRIDE, mode=WELL_TEMPERED,
                              deltaT=3000.0),
        lambda f: make_packed_npt_scr_step(f, spec, dt=0.005, kT=KT,
                                           pressure=npt["pressure"],
                                           tau_p=NPT_TAU_P, engine=eng),
        seed=3, chunks_per_block=8)
    assert s.batched
    s.run(NPT_STRIDE)
    batch = s.states
    L = batch.box.L.cpu().numpy()
    assert len({tuple(r) for r in L.tolist()}) == W, L
    out = {"variants": {}}
    pairs = [pairs_within(walker(batch, w), spec, spec.r_cut)
             for w in range(W)]
    exempt = [near_cutoff_slots(walker(batch, w), spec) for w in range(W)]
    for we in (False, True):
        a = packed_lj_force_cuda(batch, spec, with_energy=we)
        one = [packed_lj_force_cuda(walker(batch, w), spec, with_energy=we)
               for w in range(W)]
        same = all(torch.equal(a.f[w], one[w].f) for w in range(W))
        if we:
            same &= all(torch.equal(a.virial[w], one[w].virial)
                        and torch.equal(a.potential_energy[w],
                                        one[w].potential_energy)
                        for w in range(W))
        assert same, f"own-box batch with_energy={we} differs from single " \
                     "launches"
        b = packed_lj_force(batch, spec, with_energy=we)
        torch.cuda.synchronize()
        errs = [pair_close(f"npt walkers w={w}", walker(a, w), walker(b, w),
                           we, exempt[w], lj_jump(spec)) for w in range(W)]
        err = max(e[0] for e in errs)
        del a, b, one
        ms = cuda_ms(lambda: packed_lj_force_cuda(batch, spec,
                                                  with_energy=we))
        ms_one = cuda_ms(lambda: [packed_lj_force_cuda(walker(batch, w),
                                                       spec, with_energy=we)
                                  for w in range(W)])
        plain = cuda_ms(lambda: packed_lj_force(batch, spec, with_energy=we),
                        calls=3, warm=1)
        kind = spec.pair_kind + ("_energy" if we else "")
        bms, by = bound(W * pair_kernel_bytes(spec, we),
                        sum(pairs) * FLOP_PER_PAIR[kind])
        key = f"sentinel W={W} own boxes liq64k{' +energy' if we else ''}"
        out["variants"][key] = (err, ms, plain, bms, by)
        out["variants"][f"{key} as {W} single launches"] = (
            0.0, ms_one, plain, bms, by)
        print(f"npt walkers batch W={W} N={n} with_energy={we}, boxes L_x "
              f"{np.round(L[:, 0], 5).tolist()}: equal to {W} single "
              f"launches to the bit={same}; vs plain batched: "
              f"{errs[int(np.argmax([e[0] for e in errs]))][1]} batch_ms="
              f"{ms:.4f} single_launches_ms={ms_one:.4f} plain_ms="
              f"{plain:.4f} bound_ms={bms:.5f} ({by}) on {smi}")
    n_timed = 4
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.energy_launches = 0
    packed_lj_force_cuda.walkers = 0
    t0 = time.perf_counter()
    hist = s.run(n_timed * NPT_STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = n_timed * (NPT_STRIDE + 1)
    assert counts == {**{k: 0 for k in counts}, "pair": want}, counts
    assert packed_lj_force_cuda.energy_launches == want
    assert packed_lj_force_cuda.walkers == W * want
    for m in hist:
        assert np.all(np.isfinite(m["cv"])), m
        assert not m["nlist_overflow"].any(), m
        assert not m["cell_width_violation"].any(), m
        assert ((NPT_WTE_T_BAND[0] < m["temperature"])
                & (m["temperature"] < NPT_WTE_T_BAND[1])).all(), m
    rate = W * n * NPT_STRIDE * n_timed / dt
    L = s.states.box.L.cpu().numpy()
    print(f"npt walkers {W} x liq64k + WTE: {n_timed} strides of "
          f"{NPT_STRIDE} {dt:.3f} s {rate:.1f} particle-steps/s summed over "
          f"walkers launches={counts['pair']} ({want // n_timed} per stride, "
          f"{W} walkers each, all with energy) boxes L_x "
          f"{np.round(L[:, 0], 5).tolist()} T="
          f"{np.round(hist[-1]['temperature'], 4).tolist()} hills="
          f"{s.bias.n_hills} on {smi}")
    out.update(launches=counts["pair"], rate=rate)
    del s, batch
    torch.cuda.empty_cache()
    print(f"npt walkers phase 32: {time.perf_counter() - t32:.1f} s")
    return out


def config5_slabs(melt: dict, relaxed: tuple, dev, smi: str) -> dict:
    """Phase 33: Config 5 at 1,048,576 beads on SLABS x-slabs of the card:
    SpatialPackedEngine (kernel 1 per shard, 33 x-planes each of 66) and
    ShardedPackedMesh (48^3, 24 columns per shard) under
    FluxTemperedSampler, from phase 21's relaxed melt, as
    tests/test_config5.py:64-130 composes them.  On the production pack:
    S(k0), its bias force (autograd) and the bias virial against the
    single-grid PackedMesh (value rtol 2e-4; force rtol 2e-2, atol 1e-5;
    virial rtol 2e-4, atol 1e-6, the reference's own); then one warm and
    one timed period (exactly 2 x 51 launches per stride, 2 of them
    masked with energy), peak memory, one profiled period."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        Box, FluxTemperedSampler, GridSpec, PackedMesh, PackedSpec,
        make_packed_langevin_step, make_system,
    )
    from metadyn_tpu_torch.parallel.mesh import ShardedPackedMesh
    from metadyn_tpu_torch.parallel.spatial import SpatialPackedEngine
    from metadyn_tpu_torch.utils.profiling import device_profile

    t33 = time.perf_counter()
    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pos, vel = relaxed
    n, L, types = melt["n"], melt["L"], melt["types"]
    spec = PackedSpec.create(L, n, r_cut=WCA_RC, skin=0.5, cap=48,
                             fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    devs = [dev] * SLABS
    engine = SpatialPackedEngine(spec, devs, rebuild_every=1)
    k0 = 2 * np.pi * 4 / L
    cv = ShardedPackedMesh.create((48, 48, 48), spec, devs, n_real=n, k0=k0,
                                  width=0.3, box_L=L, name="dsa")
    one = PackedMesh.create((48, 48, 48), L, n_real=n, k0=k0, width=0.3,
                            name="dsa")
    st, ovf = engine.pack_state(
        pos, Box.cubic(L, dev), types, np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={**melt["bp"], cv.attr_name: np.asarray(
            [1.0, -1.0], np.float32)[types]})
    assert not ovf, "cell capacity overflow at the production pack"
    t_pack = time.perf_counter() - t33
    system = make_system(n, dev, types=types, bonds=melt["bonds"])
    grads = []
    for c in (cv, one):
        r = st.r.detach().requires_grad_(True)
        v = c.value(st.replace(r=r), system)
        (g,) = torch.autograd.grad(v, r)
        grads.append((float(v.detach()), g,
                      c.bias_virial(st, system, torch.tensor(1.0,
                                                             device=dev))))
        del r, v, g
    (v2, g2, w2), (v1, g1, w1) = grads
    dv = abs(v2 - v1) / abs(v1)
    gbad = float(((g2 - g1).abs() - 2e-2 * g1.abs()).max())
    wbad = float(((w2 - w1).abs() - 2e-4 * w1.abs()).max())
    gmax = float(g1.abs().max())
    print(f"config5 slabs N={n}: S(k0) sharded {v2:.7f} single grid "
          f"{v1:.7f} (rel {dv:.3e}); bias force max|dg|="
          f"{float((g2 - g1).abs().max()):.3e} of max|g| {gmax:.3e}; bias "
          f"virial sharded {w2.tolist()} single {w1.tolist()}; halo "
          f"{cv.halo} columns; {spec.cells_per_dim[0] // SLABS} x-planes "
          f"and {48 // SLABS} mesh columns per shard; the pack "
          f"{t_pack:.1f} s, the checks "
          f"{time.perf_counter() - t33 - t_pack:.1f} s")
    assert dv <= 2e-4 and gbad <= 1e-5 and wbad <= 1e-6, (dv, gbad, wbad)
    del grads, g1, g2
    torch.cuda.empty_cache()
    s0 = v1
    hi = max(8.0 * s0, 10.0)
    s = FluxTemperedSampler(
        system, st, engine, [cv],
        GridSpec.create([0.0], [hi], [101], [hi / 40], dev),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0, gamma=2.0),
        kT=1.0, stride=CFG5_STRIDE, update_period=CFG5_PERIOD, seed=0,
        bias_every=1)
    per_period = CFG5_STRIDE * CFG5_PERIOD
    s.run(per_period)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    timed = s.run(per_period)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = CFG5_PERIOD * (CFG5_STRIDE + 1) * SLABS
    assert counts == {**{k: 0 for k in counts}, "pair": want,
                      "pair masked": CFG5_PERIOD * SLABS}, counts
    for m in s.history:
        for k in ("cv", "temperature", "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert not np.any(m["nlist_overflow"]), m
    t = np.asarray(timed[-1]["temperature"])
    assert np.all((CFG5_T_BAND[0] < t) & (t < CFG5_T_BAND[1])), t
    rate = n * per_period / dt
    peak = torch.cuda.max_memory_allocated() / gib
    print(f"config5 slabs N={n} {SLABS} shards: 1 period ({per_period} "
          f"steps) {dt:.3f} s {rate:.1f} particle-steps/s T by stride "
          f"{np.round(t, 4).tolist()} S(k0)={float(timed[-1]['cv'][-1][0]):.4f}"
          f" launches={counts} peak_mem={peak:.3f} GiB on {smi}")
    prof = device_profile(lambda: s.run(per_period))
    prof["busy_share_untraced"] = prof["busy_ms"] / (1e3 * dt)
    prof["busy_ms_per_stride"] = prof["busy_ms"] / CFG5_PERIOD
    print(f"profile config5 slabs N={n} one period ({CFG5_PERIOD} strides; "
          f"the extended grids' gathers are the index_select kernels): "
          f"{json.dumps(prof)} on {smi}")
    del s, st, engine
    torch.cuda.empty_cache()
    print(f"config5 slabs phase 33: {time.perf_counter() - t33:.1f} s")
    return {"launches": counts["pair"], "masked": counts["pair masked"],
            "rate": rate}


def walkers_space_phase(dev, smi: str, unsharded_rate: float) -> dict:
    """Phase 34: walkers x space.  WALKERS_DD x liq64k (bench.py's spec,
    14^3 cells) on SLABS x-slabs (7 planes each) of the nested
    SpatialPackedEngine.  Kernel 1's walker batch on each shard's extended
    grid under the interior mask, with energy, against WALKERS_DD single
    masked launches to the bit and against the plain batched version
    (phase 3's gates), with times and the bound; 20 steps at gamma 0 of
    the walkers on the slabs against phase 29's unsharded walkers
    (PackedEngine's batch: positions 1e-3, CVs rtol 1e-4); then 1 warm and
    2 timed strides of 500 (exactly 2 x 501 launches per stride, one per
    shard for all walkers; 2 masked with energy), the rate summed over
    walkers."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        HillSpec, PackedEngine, WalkerSampler, WELL_TEMPERED,
        make_packed_langevin_step, make_system,
    )
    from metadyn_tpu_torch.core.batch import stack_walkers, walker
    from metadyn_tpu_torch.ops.packed import packed_lj_force, unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.parallel.spatial import Slabs, SpatialPackedEngine

    t34 = time.perf_counter()
    spec, cvs, gspec, walls = liq_parts(dev)
    n, W = spec.n_real, WALKERS_DD
    devs = [dev] * SLABS
    batch = stack_walkers(liq_walker_states(
        dev, spec, PackedEngine(spec, dev), cvs, W, noise=0.02))
    slabs = Slabs(spec, devs)
    out = {"variants": {}}
    for k, se in enumerate(slabs.halo_states(batch)):
        m = slabs.interior[k]
        sx = slabs.spec_ext
        a = packed_lj_force_cuda(se, sx, with_energy=True, cell_mask=m)
        one = [packed_lj_force_cuda(walker(se, w), sx, with_energy=True,
                                    cell_mask=m) for w in range(W)]
        same = all(torch.equal(a.f[w], one[w].f)
                   and torch.equal(a.potential_energy[w],
                                   one[w].potential_energy)
                   and torch.equal(a.virial[w], one[w].virial)
                   for w in range(W))
        assert same, f"shard {k}: masked walker batch differs from single " \
                     "launches"
        # the plain version reads se and hs, pairs_within the pids
        sp = slabs.halo_states(batch, pid=True, attrs=("se", "hs"))[k]
        b = packed_lj_force(sp, sx, with_energy=True, cell_mask=m)
        torch.cuda.synchronize()
        errs = [pair_close(f"walkers x space shard {k} w={w}", walker(a, w),
                           walker(b, w), True,
                           near_cutoff_slots(walker(sp, w), sx), lj_jump(sx))
                for w in range(W)]
        err = max(e[0] for e in errs)
        del a, b, one
        ms = cuda_ms(lambda: packed_lj_force_cuda(se, sx, with_energy=True,
                                                  cell_mask=m))
        ms_one = cuda_ms(lambda: [packed_lj_force_cuda(
            walker(se, w), sx, with_energy=True, cell_mask=m)
            for w in range(W)])
        plain = cuda_ms(lambda: packed_lj_force(sp, sx, with_energy=True,
                                                cell_mask=m), calls=3, warm=1)
        pairs = sum(pairs_within(walker(sp, w), sx, sx.r_cut, cell_mask=m)
                    for w in range(W))
        bms, by = bound(W * pair_kernel_bytes(sx, True),
                        pairs * FLOP_PER_PAIR["lj_energy"])
        if k == 0:
            key = f"sentinel W={W} x cell_mask, shard 0 of {SLABS} liq64k"
            out["variants"][key] = (err, ms, plain, bms, by)
            out["variants"][f"{key} as {W} single launches"] = (
                0.0, ms_one, plain, bms, by)
        print(f"walkers x space shard {k} ({sx.cells_per_dim} cells, W={W}, "
              f"masked energy): equal to {W} single launches to the bit="
              f"{same}; vs plain: "
              f"{errs[int(np.argmax([e[0] for e in errs]))][1]} batch_ms="
              f"{ms:.4f} single_launches_ms={ms_one:.4f} plain_ms="
              f"{plain:.4f} bound_ms={bms:.5f} ({by}; {pairs} masked pairs) "
              f"on {smi}")
        del sp
    del batch
    torch.cuda.empty_cache()

    def build(engine, gamma=1.0, stride=STRIDE):
        return WalkerSampler(
            make_system(n, dev),
            stack_walkers(liq_walker_states(dev, spec, engine, cvs, W)),
            engine, cvs, gspec,
            HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT,
                                                gamma=gamma),
            seed=0, walls=walls, bias_every=5, chunks_per_block=8)

    runs = []
    for eng in (PackedEngine(spec, dev, rebuild_every=10),
                SpatialPackedEngine(spec, devs, rebuild_every=10,
                                    nested=True)):
        s = build(eng, gamma=0.0, stride=20)
        assert s.batched
        m = s.run(20)[-1]
        runs.append(([unpack_positions(walker(s.states, w), spec).cpu()
                      .numpy() for w in range(W)], np.asarray(m["cv"])))
    L = float(np.load(ROOT / "bench_data" / "liq64k.npz")["L"])
    dpos = max(min_image_max(a, b, L) for a, b in zip(runs[0][0],
                                                       runs[1][0]))
    dcv = float(np.max(np.abs(runs[1][1] - runs[0][1])
                       / np.abs(runs[0][1]).max()))
    assert dpos <= 1e-3 and dcv <= 1e-4, (dpos, dcv)
    print(f"walkers x space gamma=0 20 steps: {W} walkers on {SLABS} slabs "
          f"against phase 29's unsharded batch: max|dpos|={dpos:.3e} CV "
          f"max rel={dcv:.3e}")

    s = build(SpatialPackedEngine(spec, devs, rebuild_every=10,
                                  nested=True))
    s.run(STRIDE)
    n_timed = 2
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.walkers = 0
    t0 = time.perf_counter()
    hist = s.run(n_timed * STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = n_timed * (STRIDE + 1) * SLABS
    assert counts == {**{k: 0 for k in counts}, "pair": want,
                      "pair masked": n_timed * SLABS}, counts
    assert packed_lj_force_cuda.walkers == W * want
    for m in hist:
        assert np.all(np.isfinite(m["cv"])), m
        assert not m["nlist_overflow"].any(), m
        assert ((0.9 < m["temperature"]) & (m["temperature"] < 1.1)).all(), m
    rate = W * n * STRIDE * n_timed / dt
    print(f"walkers x space {W} x liq64k on {SLABS} slabs bias_every=5: "
          f"{n_timed} strides {dt:.3f} s {rate:.1f} particle-steps/s summed "
          f"over walkers ({rate / unsharded_rate:.3f} x phase 29's unsharded "
          f"8 walkers' {unsharded_rate:.1f}) launches={counts} on {smi}")
    del s
    torch.cuda.empty_cache()
    print(f"walkers x space phase 34: {time.perf_counter() - t34:.1f} s")
    out.update(launches=counts["pair"], masked=counts["pair masked"],
               rate=rate)
    return out


# Phases 35-39: the 2-D decomposition (SpatialPackedEngine2D on 2 x 2
# blocks of the one card, the pencil-FFT ShardedPackedMesh2D), hill-list
# mode and the neighbour-table path.
BLOCKS = (2, 2)
N_BLOCKS = BLOCKS[0] * BLOCKS[1]


def engine_2d(shape=BLOCKS, **kw):
    """An engine_cls for config3_sampler: SpatialPackedEngine2D with the
    shape's shards all on the one card."""
    from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D

    def make(spec, dev, rebuild_every):
        return SpatialPackedEngine2D(spec, [dev] * (shape[0] * shape[1]),
                                     shape, rebuild_every=rebuild_every, **kw)
    return make


def table_engine(r_nb: float, K: int):
    """An engine_cls for config3_sampler: PackedEngine keeping the slot
    neighbour table (r_nb, K)."""
    from metadyn_tpu_torch import PackedEngine

    def make(spec, dev, rebuild_every):
        return PackedEngine(spec, dev, rebuild_every=rebuild_every,
                            nbr_table=(r_nb, K))
    return make


def blocks_kernels(dev, smi: str) -> dict:
    """Phase 35: the kernels on the 2-D blocks' extended grids at full
    size.  Config 3 (fcc + noise 0.05, cap 32, 14^3 cells) on 2 x 2 blocks
    (parallel/spatial2d.Blocks), each a 9 x 9 x 14 extended grid: kernel 1
    forces only and with energy under the interior mask, kernel 2 under the
    mask, kernel 3, each against its plain version on the same grid
    (phase 8's and 26's gates); the four blocks' summed energy and virial
    (rtol 1e-5) and CV value sums (rtol 2e-5) against the single grid's
    kernels, the forces gathered from the blocks' interiors against the
    single grid's; then kernel 1's walker batch under the mask on block 0
    (4 x liq64k + noise 0.02, as phase 34) against 4 single masked launches
    to the bit and the plain batched version.  Returns per variant (max
    abs error, kernel ms, plain ms, bound ms, bound by)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import Box, PackedEngine
    from metadyn_tpu_torch.core.batch import stack_walkers, walker
    from metadyn_tpu_torch.cv.packed_order import (
        order_force_plain, order_values_plain,
    )
    from metadyn_tpu_torch.ops.packed import packed_lj_force
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )
    from metadyn_tpu_torch.parallel.spatial2d import Blocks

    t35 = time.perf_counter()
    pos, vel, L, a, spec = config3_inputs(32, noise=0.05)
    n = pos.shape[0]
    st, overflow = PackedEngine(spec, dev).pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32), np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel)
    assert not overflow, "cell capacity overflow at pack (phase 35)"
    cvs = config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t)
            in enumerate(zip(cvs, order_values_cuda(st, spec, cvs)))]
    blocks = Blocks(spec, [dev] * N_BLOCKS, BLOCKS)
    sx = blocks.spec_ext
    assert sx.cells_per_dim == (9, 9, 14), sx.cells_per_dim
    exts = blocks.halo_states(st, pid=True, attrs=("se", "hs"))
    fp = FLOP_PER_PAIR
    out, fs, gs = {}, [], []
    e_sum = w_sum = t_sum = None
    for k, se in enumerate(exts):
        m = blocks.interior[k]
        tag = f"phase 35 block {k} ext {sx.cells_per_dim}"
        lines = []
        for we in (False, True):
            mask = m if we else None
            ak = packed_lj_force_cuda(se, sx, with_energy=we, cell_mask=mask)
            bp = packed_lj_force(se, sx, with_energy=we, cell_mask=mask)
            torch.cuda.synchronize()
            err, line = pair_close(f"{tag} pair we={we}", ak, bp, we)
            lines.append(f"pair{' masked energy' if we else ''} {line}")
            if we:
                e_sum = (ak.potential_energy if e_sum is None
                         else e_sum + ak.potential_energy)
                w_sum = ak.virial if w_sum is None else w_sum + ak.virial
            else:
                fs.append(ak.f)
            if k == 0:
                lj = pairs_within(se, sx, sx.r_cut)
                ljm = pairs_within(se, sx, sx.r_cut, m)
                flops = lj * fp["lj"] + (ljm * (fp["lj_energy"] - fp["lj"])
                                         if we else 0)
                key = "pair masked energy" if we else "pair"
                out[key] = (
                    err, cuda_ms(lambda: packed_lj_force_cuda(
                        se, sx, with_energy=we, cell_mask=mask)),
                    cuda_ms(lambda: packed_lj_force(
                        se, sx, with_energy=we, cell_mask=mask), calls=10),
                    *bound(pair_kernel_bytes(sx, we) + 4 * sx.n_cells * we,
                           flops))
        tk = order_values_cuda(se, sx, cvs, cell_mask=m)
        tp = order_values_plain(se, sx, cvs, cell_mask=m)
        torch.cuda.synchronize()
        ev = lanes_close(f"{tag} values masked", cvs, tk, tp, 2e-5)
        t_sum = tk if t_sum is None else tuple(
            tuple(x + y for x, y in zip(u, v)) for u, v in zip(t_sum, tk))
        gk = order_force_cuda(se, sx, cvs, auxs)
        gp = order_force_plain(se, sx, cvs, auxs)
        torch.cuda.synchronize()
        eg, gmax = force_close(f"{tag} order force", gk, gp, 2e-3, 2e-4)
        gs.append(gk)
        if k == 0:
            q6m, com = (pairs_within(se, sx, cv.r_cut, m) for cv in cvs)
            q6, co = (pairs_within(se, sx, cv.r_cut) for cv in cvs)
            out["values masked"] = (
                ev, cuda_ms(lambda: order_values_cuda(se, sx, cvs,
                                                      cell_mask=m)),
                cuda_ms(lambda: order_values_plain(se, sx, cvs, cell_mask=m),
                        calls=10),
                *bound(12 * sx.n_pad + 4 * sx.n_cells,
                       q6m * fp["q6_value"] + com * fp["coord_value"]))
            out["force"] = (
                eg, cuda_ms(lambda: order_force_cuda(se, sx, cvs, auxs)),
                cuda_ms(lambda: order_force_plain(se, sx, cvs, auxs),
                        calls=10),
                *bound(24 * sx.n_pad,
                       q6 * fp["q6_force"] + co * fp["coord_force"]))
        print(f"{tag}: {'; '.join(lines)}; values masked max|dlane|="
              f"{ev:.3e}; order force max|dg|={eg:.3e} (max|g|={gmax:.3e})")
    # the blocks against the single grid's kernels
    whole = packed_lj_force_cuda(st, spec, with_energy=True)
    f_whole = packed_lj_force_cuda(st, spec, with_energy=False).f
    t_whole = order_values_cuda(st, spec, cvs)
    g_whole = order_force_cuda(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    dpe = abs(float(e_sum - whole.potential_energy)) / abs(
        float(whole.potential_energy))
    dw = float(((w_sum - whole.virial).abs() / whole.virial.abs()).max())
    es = lanes_close("phase 35 summed masked values vs single grid", cvs,
                     t_sum, t_whole, 2e-5)
    f_blk, g_blk = blocks.gather(fs), blocks.gather(gs)
    ef, fmax = force_close("phase 35 gathered forces vs single grid", f_blk,
                           f_whole, 0.0, 1e-4)
    eg, _ = force_close("phase 35 gathered bias forces vs single grid",
                        g_blk, g_whole, 2e-3, 2e-4)
    assert dpe <= 1e-5 and dw <= 1e-5, (dpe, dw)
    print(f"phase 35 the {N_BLOCKS} blocks against the single grid "
          f"(N={n}): rel_dPE={dpe:.3e} rel_dvirial={dw:.3e} values "
          f"max|dlane|={es:.3e}; gathered forces max|df|={ef:.3e} "
          f"(max|f|={fmax:.3e}, bitwise equal={torch.equal(f_blk, f_whole)})"
          f"; gathered bias forces max|dg|={eg:.3e} (bitwise equal="
          f"{torch.equal(g_blk, g_whole)})")
    del exts, fs, gs, f_blk, g_blk, whole, f_whole, g_whole
    torch.cuda.empty_cache()

    # kernel 1's walker batch under the mask on block 0 of the liquid
    lspec, lcvs, _, _ = liq_parts(dev)
    W = WALKERS_DD
    batch = stack_walkers(liq_walker_states(
        dev, lspec, PackedEngine(lspec, dev), lcvs, W, noise=0.02))
    lb = Blocks(lspec, [dev] * N_BLOCKS, BLOCKS)
    lx, m = lb.spec_ext, lb.interior[0]
    se = lb.halo_states(batch)[0]
    ab = packed_lj_force_cuda(se, lx, with_energy=True, cell_mask=m)
    one = [packed_lj_force_cuda(walker(se, w), lx, with_energy=True,
                                cell_mask=m) for w in range(W)]
    same = all(torch.equal(ab.f[w], one[w].f)
               and torch.equal(ab.potential_energy[w],
                               one[w].potential_energy)
               and torch.equal(ab.virial[w], one[w].virial)
               for w in range(W))
    assert same, "block 0: the masked walker batch differs from single " \
                 "launches"
    sp = lb.halo_states(batch, pid=True, attrs=("se", "hs"))[0]
    bp = packed_lj_force(sp, lx, with_energy=True, cell_mask=m)
    torch.cuda.synchronize()
    errs = [pair_close(f"phase 35 walker batch w={w}", walker(ab, w),
                       walker(bp, w), True,
                       near_cutoff_slots(walker(sp, w), lx), lj_jump(lx))
            for w in range(W)]
    del ab, bp, one
    ms = cuda_ms(lambda: packed_lj_force_cuda(se, lx, with_energy=True,
                                              cell_mask=m))
    ms_one = cuda_ms(lambda: [packed_lj_force_cuda(
        walker(se, w), lx, with_energy=True, cell_mask=m) for w in range(W)])
    plain = cuda_ms(lambda: packed_lj_force(sp, lx, with_energy=True,
                                            cell_mask=m), calls=3, warm=1)
    pairs = sum(pairs_within(walker(sp, w), lx, lx.r_cut, cell_mask=m)
                for w in range(W))
    bms, by = bound(W * pair_kernel_bytes(lx, True),
                    pairs * FLOP_PER_PAIR["lj_energy"])
    err = max(e[0] for e in errs)
    out["walker batch masked"] = (err, ms, plain, bms, by)
    out["walker batch masked as single launches"] = (0.0, ms_one, plain, bms,
                                                     by)
    print(f"phase 35 walker batch W={W} on block 0 ({lx.cells_per_dim} "
          f"cells, masked energy): equal to {W} single launches to the bit="
          f"{same}; vs plain max|df|={err:.3e} batch_ms={ms:.4f} "
          f"single_launches_ms={ms_one:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.5f} ({by}; {pairs} masked pairs) on {smi}")
    del batch, se, sp
    torch.cuda.empty_cache()
    for key, v in out.items():
        print(f"phase 35 {key} [block 0 of {BLOCKS}]: max_abs_err={v[0]:.3e} "
              f"kernel_ms={v[1]:.4f} plain_ms={v[2]:.4f} "
              f"bound_ms={v[3]:.5f} ({v[4]}) on {smi}")
    print(f"blocks phase 35: {time.perf_counter() - t35:.1f} s")
    return out


def config3_blocks(dev, smi: str, exact: dict) -> dict:
    """Phase 36: Config 3 exact (mts_lag off, bias_every 10) on
    SpatialPackedEngine2D, 2 x 2 blocks of the card.  (1) 20 steps at gamma
    0 against PackedEngine from one state: positions to 1e-3, CV values
    rtol 1e-4, PE rtol 1e-5; (2) after that stride the 2-D repack of a
    displaced state against repack_incremental, bit for bit; (3) timed as
    phase 11 times the single grid (2 warm runs of 2 strides, 2 timed
    strides, exact launches per stride: 4 pair launches per force call, 4
    masked at the refresh, 4 masked values and 4 force launches per bias
    evaluation, the stride end's 2 values on the global state), one
    profiled stride; rate, busy ms per stride and device-to-host copies
    beside phase 11's (``exact``)."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import PackedEngine
    from metadyn_tpu_torch.ops.packed import (
        repack_incremental, unpack_positions,
    )
    from metadyn_tpu_torch.parallel.spatial2d import make_sharded_repack_2d

    t36 = time.perf_counter()
    finals = []
    for cls in (PackedEngine, engine_2d()):
        reset_counts()
        s = config3_sampler(cls, dev, 32, mts_lag=False, gamma=0.0,
                            stride=20)
        assert s is not None, "cell capacity overflow at pack (phase 36)"
        m = s.run(20)[-1]
        counts = read_counts()
        finals.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                       np.asarray(m["cv"]), float(m["potential_energy"]),
                       counts))
    assert all(finals[1][3][k] > 0 for k in (
        "pair", "pair masked", "values masked", "force")), finals[1][3]
    L = float(s.state.box.L_host[0])
    dpos = finals[0][0] - finals[1][0]
    dpos -= L * np.round(dpos / L)
    dpos = float(np.abs(dpos).max())
    dcv = float(np.max(np.abs(finals[0][1] - finals[1][1])
                       / np.abs(finals[0][1])))
    dpe = abs(finals[0][2] - finals[1][2]) / abs(finals[0][2])
    assert dpos <= 1e-3 and dcv <= 1e-4 and dpe <= 1e-5, (dpos, dcv, dpe)
    print(f"phase 36 2-D {BLOCKS} vs PackedEngine exact gamma=0 20 steps: "
          f"max|dpos|={dpos:.3e} positions bitwise equal="
          f"{bool((finals[0][0] == finals[1][0]).all())} rel_dcv={dcv:.3e} "
          f"rel_dPE={dpe:.3e} cv={finals[1][1].tolist()} "
          f"launches={finals[1][3]} (single grid {finals[0][3]})")

    spec = s.engine.spec
    st = s.state
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    disp = 0.15 * torch.randn(st.r.shape, generator=gen, device=dev)
    st = st.replace(r=torch.where((st.pid < spec.n_real)[None], st.r + disp,
                                  st.r))
    ref, bad_ref = repack_incremental(st, spec)
    got, bad = make_sharded_repack_2d(spec, [dev] * N_BLOCKS, BLOCKS)(st)
    assert not bool(bad_ref) and not bool(bad), (bad_ref, bad)
    for k in ("r", "v", "f", "image", "pid", "typ", "slot_of"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ref.attrs:
        assert torch.equal(got.attrs[k], ref.attrs[k]), k
    moved = int((ref.pid != st.pid).sum())
    print(f"phase 36 2-D repack {BLOCKS}: bit for bit against "
          f"repack_incremental ({moved} of {spec.n_pad} slots changed)")
    del s, st, ref, got, finals
    torch.cuda.empty_cache()

    got = {}
    counts = config3_timed(
        dev, False, warm=(2, 2), n_runs=1, n_timed=2,
        per_stride={"pair": 101 * N_BLOCKS, "pair masked": N_BLOCKS,
                    "values": 10 * N_BLOCKS + 2,
                    "values masked": 10 * N_BLOCKS,
                    "force": 10 * N_BLOCKS},
        smi=smi, engine_cls=engine_2d(),
        tag=f"config3 exact 2-D blocks={BLOCKS}", out=got)
    prof, base = got["profile"], exact["profile"]
    print(f"phase 36 config3 exact particle-steps/s: 2-D {BLOCKS} "
          f"{got['rates']} against the single grid (phase 11) "
          f"{exact['rates']}; busy ms per stride {prof['busy_ms']:.1f} "
          f"against {base['busy_ms']:.1f}; kernel 1 launches per stride "
          f"{counts['pair'] // 2} against {101}; device-to-host copies per "
          f"stride {prof['d2h_count']} against {base['d2h_count']} on {smi}")
    print(f"config3 blocks phase 36: {time.perf_counter() - t36:.1f} s")
    return {"counts": counts, "rates": got["rates"], "profile": prof,
            "build": got["build"]}


def mesh_repeats(tag: str, cv, st, system) -> None:
    """Two calls of ``cv.value`` and of its autograd bias force give the
    same bits (the fixed-point scatter of cv/mesh.assign)."""
    import torch
    vals, grads = [], []
    for _ in range(2):
        r = st.r.detach().requires_grad_(True)
        v = cv.value(st.replace(r=r), system)
        (g,) = torch.autograd.grad(v, r)
        vals.append(v.detach())
        grads.append(g)
        del r, v, g
    same_v = torch.equal(vals[0], vals[1])
    same_g = torch.equal(grads[0], grads[1])
    print(f"{tag}: two calls of {type(cv).__name__}: values bitwise equal="
          f"{same_v} ({float(vals[0]):.9g}), bias forces bitwise equal="
          f"{same_g}")
    assert same_v and same_g, tag


def scatter_ab(cv, st, dev, smi: str) -> dict:
    """The mesh CV's value and autograd force at Config 5's 1M state with
    the fixed-point scatter (cv/mesh.FixedPointScatter, this slice) and
    with the float index_add it replaced: ms per call and peak memory of
    each, in one call of the script."""
    import torch
    import metadyn_tpu_torch.cv.mesh as cm

    class FloatScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, idx, val, size):
            ctx.save_for_backward(idx)
            return torch.zeros(size, dtype=torch.float32,
                               device=val.device).index_add(0, idx, val)

        @staticmethod
        def backward(ctx, grad):
            (idx,) = ctx.saved_tensors
            return None, grad[idx], None

    def value_and_force():
        r = st.r.detach().requires_grad_(True)
        v = cv.value(st.replace(r=r), None)
        (g,) = torch.autograd.grad(v, r)
        return g

    out = {}
    fixed = cm.FixedPointScatter
    for name, scatter in (("fixed point", fixed), ("float index_add",
                                                   FloatScatter)):
        cm.FixedPointScatter = scatter
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            value_and_force()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2.0 ** 30
            ms = cuda_ms(value_and_force, calls=5, warm=1)
        finally:
            cm.FixedPointScatter = fixed
        out[name] = (ms, peak)
    print(f"phase 37 mesh CV value + autograd force at N={st.pid.numel()} "
          f"slots, {cv.mesh_shape} mesh: " + "; ".join(
              f"{k} {v[0]:.2f} ms, {v[1]:.3f} GiB above the state"
              for k, v in out.items()) + f" on {smi}")
    return out


def config5_blocks(melt: dict, relaxed: tuple, melt2: dict, dev,
                   smi: str, slabs5: dict) -> dict:
    """Phase 37: Config 5 at 1,048,576 beads on 2 x 2 blocks of the card
    (SpatialPackedEngine2D, 33 x 33 x 66 cells per block) with the pencil-
    FFT ShardedPackedMesh2D 48^3 (24 x 24 columns per block) under
    FluxTemperedSampler, from phase 21's relaxed melt.  S(k0), its bias
    force and the bias virial against the single grid's PackedMesh (phase
    33's gates); two calls of each bit for bit, and of PackedMesh on
    Config 2's melt (phase 13); the mesh CV's scatter, fixed point against
    the float index_add it replaced; then one warm, one timed and one
    profiled flux period (exactly 4 x 51 launches per stride, 4 of them
    masked with energy), peak memory, beside phase 33's slabs."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        Box, FluxTemperedSampler, GridSpec, PackedMesh, PackedSpec,
        make_packed_langevin_step, make_system,
    )
    from metadyn_tpu_torch.parallel.mesh2d import ShardedPackedMesh2D
    from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D
    from metadyn_tpu_torch.utils.profiling import device_profile

    t37 = time.perf_counter()
    # Config 2's melt first: PackedMesh 32^3, two calls bit for bit
    s2, _ = config2_sampler(melt2, dev)
    mesh_repeats("phase 37 config2 N=8192", s2.cvs[0], s2.state, s2.system)
    del s2
    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pos, vel = relaxed
    n, L, types = melt["n"], melt["L"], melt["types"]
    spec = PackedSpec.create(L, n, r_cut=WCA_RC, skin=0.5, cap=48,
                             fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    devs = [dev] * N_BLOCKS
    engine = SpatialPackedEngine2D(spec, devs, BLOCKS, rebuild_every=1)
    k0 = 2 * np.pi * 4 / L
    cv = ShardedPackedMesh2D.create((48, 48, 48), spec, devs, BLOCKS,
                                    n_real=n, k0=k0, width=0.3, box_L=L,
                                    name="dsa")
    one = PackedMesh.create((48, 48, 48), L, n_real=n, k0=k0, width=0.3,
                            name="dsa")
    st, ovf = engine.pack_state(
        pos, Box.cubic(L, dev), types, np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={**melt["bp"], cv.attr_name: np.asarray(
            [1.0, -1.0], np.float32)[types]})
    assert not ovf, "cell capacity overflow at the production pack"
    system = make_system(n, dev, types=types, bonds=melt["bonds"])
    grads = []
    for c in (cv, one):
        r = st.r.detach().requires_grad_(True)
        v = c.value(st.replace(r=r), system)
        (g,) = torch.autograd.grad(v, r)
        grads.append((float(v.detach()), g,
                      c.bias_virial(st, system, torch.tensor(1.0,
                                                             device=dev))))
        del r, v, g
    (v2, g2, w2), (v1, g1, w1) = grads
    dv = abs(v2 - v1) / abs(v1)
    gbad = float(((g2 - g1).abs() - 2e-2 * g1.abs()).max())
    wbad = float(((w2 - w1).abs() - 2e-4 * w1.abs()).max())
    print(f"phase 37 config5 blocks N={n}: S(k0) pencils {v2:.9g} single "
          f"grid {v1:.9g} (rel {dv:.3e}); bias force max|dg|="
          f"{float((g2 - g1).abs().max()):.3e} of max|g| "
          f"{float(g1.abs().max()):.3e}; bias virial pencils {w2.tolist()} "
          f"single {w1.tolist()}; halo {cv.halo} columns; "
          f"{spec.cells_per_dim[0] // BLOCKS[0]} x "
          f"{spec.cells_per_dim[1] // BLOCKS[1]} planes and "
          f"{48 // BLOCKS[0]} x {48 // BLOCKS[1]} mesh columns per block")
    assert dv <= 2e-4 and gbad <= 1e-5 and wbad <= 1e-6, (dv, gbad, wbad)
    del grads, g1, g2
    torch.cuda.empty_cache()
    mesh_repeats(f"phase 37 config5 N={n} single grid", one, st, system)
    mesh_repeats(f"phase 37 config5 N={n} pencils {BLOCKS}", cv, st, system)
    ab = scatter_ab(one, st, dev, smi)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_checks = time.perf_counter() - t37
    s0 = v1
    hi = max(8.0 * s0, 10.0)
    s = FluxTemperedSampler(
        system, st, engine, [cv],
        GridSpec.create([0.0], [hi], [101], [hi / 40], dev),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0, gamma=2.0),
        kT=1.0, stride=CFG5_STRIDE, update_period=CFG5_PERIOD, seed=0,
        bias_every=1)
    per_period = CFG5_STRIDE * CFG5_PERIOD
    t_init = time.perf_counter() - t37 - t_checks
    s.run(per_period)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    timed = s.run(per_period)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = CFG5_PERIOD * (CFG5_STRIDE + 1) * N_BLOCKS
    assert counts == {**{k: 0 for k in counts}, "pair": want,
                      "pair masked": CFG5_PERIOD * N_BLOCKS}, counts
    for m in s.history:
        for k in ("cv", "temperature", "potential_energy"):
            assert np.all(np.isfinite(m[k])), (k, m)
        assert not np.any(m["nlist_overflow"]), m
    t = np.asarray(timed[-1]["temperature"])
    assert np.all((CFG5_T_BAND[0] < t) & (t < CFG5_T_BAND[1])), t
    rate = n * per_period / dt
    peak = torch.cuda.max_memory_allocated() / gib
    prof = device_profile(lambda: s.run(per_period))
    prof["busy_share_untraced"] = prof["busy_ms"] / (1e3 * dt)
    prof["busy_ms_per_stride"] = prof["busy_ms"] / CFG5_PERIOD
    print(f"phase 37 seconds: the checks {t_checks:.1f}, the sampler's "
          f"construction {t_init:.1f}, the profile's hand-over "
          f"{prof['post_s']:.1f}")
    print(f"phase 37 config5 blocks N={n} {BLOCKS}: 1 period ({per_period} "
          f"steps) {dt:.3f} s {rate:.1f} particle-steps/s (phase 33's 2 "
          f"slabs {slabs5['rate']:.1f}) T by stride "
          f"{np.round(t, 4).tolist()} S(k0)="
          f"{float(timed[-1]['cv'][-1][0]):.4f} launches={counts} "
          f"peak_mem={peak:.3f} GiB busy_ms_per_stride="
          f"{prof['busy_ms_per_stride']:.1f} on {smi}")
    print(f"profile config5 blocks N={n} one period ({CFG5_PERIOD} strides):"
          f" {json.dumps(prof)} on {smi}")
    del s, st, engine
    torch.cuda.empty_cache()
    print(f"config5 blocks phase 37: {time.perf_counter() - t37:.1f} s")
    return {"launches": counts["pair"], "masked": counts["pair masked"],
            "rate": rate, "scatter": ab}


def cli_blocks(dev, smi: str) -> dict:
    """Phase 38: examples/config4_walkers_sk_dd.yaml through the CLI with
    engine.spatial_devices [2, 2] (4 walkers x 2 x 2 blocks of a 4^3-cell
    box on the card, the pencil-FFT 8^3 S(k)) and only output.* changed:
    a straight run with exact launches (per walker and stride 21 force
    calls of 4 launches, the refresh's 4 masked) and the files; then its
    resume leg (K steps with a checkpoint, --resume for K more) against a
    straight 2K, the hill files and the grid dumps bit for bit."""
    import tempfile
    import torch
    from metadyn_tpu_torch.cli import CliRun
    from metadyn_tpu_torch.io.grid_file import load_grid
    from metadyn_tpu_torch.parallel.mesh2d import ShardedPackedMesh2D
    from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D

    t38 = time.perf_counter()
    name = "config4_walkers_sk_dd"
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_2d_"))
    d = tmp / "straight"
    d.mkdir()
    cfg = cli_yaml(name, d)
    cfg["engine"]["spatial_devices"] = list(BLOCKS)
    W = int(cfg["metadynamics"]["n_walkers"])
    reset_counts()
    t0 = time.perf_counter()
    runner = CliRun(cfg, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build = read_counts()
    assert isinstance(runner.sampler.engine, SpatialPackedEngine2D)
    assert isinstance(runner.sampler.cvs[0], ShardedPackedMesh2D)
    reset_counts()
    t1 = time.perf_counter()
    runner.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t1
    run = read_counts()
    strides = int(cfg["run"]["n_steps"]) // int(cfg["metadynamics"]["stride"])
    per = int(cfg["metadynamics"]["stride"]) + 1
    want_build = {**{k: 0 for k in build}, "pair": W * 2 * N_BLOCKS}
    want_run = {**{k: 0 for k in run}, "pair": strides * W * per * N_BLOCKS,
                "pair masked": strides * W * N_BLOCKS}
    bad = cli_checks(name, cfg, runner, band=C4SK_T_BAND)
    if build != want_build:
        bad.append(f"build launches {build}, want {want_build}")
    if run != want_run:
        bad.append(f"run launches {run}, want {want_run}")
    files = sorted(p.name for p in d.iterdir())
    print(f"phase 38 cli {name} spatial_devices={list(BLOCKS)}: {W} walkers "
          f"x {N_BLOCKS} blocks, N={runner.sampler.engine.spec.n_real} per "
          f"walker, build {t_build:.3f} s run {cfg['run']['n_steps']} steps "
          f"{t_run:.3f} s wall {t_build + t_run:.3f} s build_launches={build}"
          f" run_launches={run} files={files} on {smi}")
    legs = {}
    for leg in ("resumed", "straight"):
        d = tmp / f"resume_{leg}"
        d.mkdir()
        cfg = cli_yaml(name, d, checkpoint="ck.npz", grid_file="grid.npz")
        cfg["engine"]["spatial_devices"] = list(BLOCKS)
        # legs of 2 strides: its walkers step one by one on 4 blocks, ~0.2 s
        # a step on the host
        k = 2 * int(cfg["metadynamics"]["stride"])
        cfg["run"]["n_steps"] = cfg["run"]["report_every"] = k
        if leg == "straight":
            cfg["run"]["n_steps"] = 2 * k
            CliRun(cfg, device=dev).run()
        else:
            CliRun(cfg, device=dev).run()
            CliRun(cfg, resume=True, device=dev).run()
        legs[leg] = cfg["output"]
    same_hills = (open(legs["resumed"]["hill_file"], "rb").read()
                  == open(legs["straight"]["hill_file"], "rb").read())
    va = load_grid(legs["resumed"]["grid_file"])[0].grid.V
    vb = load_grid(legs["straight"]["grid_file"])[0].grid.V
    if not (same_hills and torch.equal(va, vb)):
        bad.append(f"resume leg: hill files equal {same_hills}, max|dV| "
                   f"{float((va - vb).abs().max()):.3e}")
    print(f"phase 38 cli {name} resume leg: {k} + {k} steps (--resume) "
          f"against {2 * k} straight: hill files equal={same_hills} grid V "
          f"bitwise equal={torch.equal(va, vb)}")
    shutil.rmtree(tmp, ignore_errors=True)
    for b in bad:
        print(f"phase 38 FAILED: {b}", file=sys.stderr)
    assert not bad, bad
    walk = walkers_blocks(dev, smi)
    print(f"cli blocks phase 38: {time.perf_counter() - t38:.1f} s")
    return {"build": build, "run": run, **walk}


def walkers_blocks(dev, smi: str) -> dict:
    """Phase 38's walkers x 2-D space with a walker batch: WALKERS_DD x
    liq64k (the lamellar CVs take the batch) on the nested
    SpatialPackedEngine2D, 2 x 2 blocks: 1 warm and 1 timed stride of 100
    (exactly 101 launches per block, one for all walkers; 4 masked with
    energy), T in 0.9-1.1, the rate summed over walkers."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import (
        HillSpec, WalkerSampler, WELL_TEMPERED, make_packed_langevin_step,
        make_system,
    )
    from metadyn_tpu_torch.core.batch import stack_walkers
    from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
    from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D

    spec, cvs, gspec, walls = liq_parts(dev)
    n, W, stride = spec.n_real, WALKERS_DD, 100
    engine = SpatialPackedEngine2D(spec, [dev] * N_BLOCKS, BLOCKS,
                                   rebuild_every=10, nested=True)
    s = WalkerSampler(
        make_system(n, dev),
        stack_walkers(liq_walker_states(dev, spec, engine, cvs, W)),
        engine, cvs, gspec,
        HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT),
        seed=0, walls=walls, bias_every=5, chunks_per_block=8)
    assert s.batched
    s.run(stride)
    torch.cuda.synchronize()
    reset_counts()
    packed_lj_force_cuda.walkers = 0
    t0 = time.perf_counter()
    (m,) = s.run(stride)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = (stride + 1) * N_BLOCKS
    assert counts == {**{k: 0 for k in counts}, "pair": want,
                      "pair masked": N_BLOCKS}, counts
    assert packed_lj_force_cuda.walkers == W * want
    assert np.all(np.isfinite(m["cv"])) and not m["nlist_overflow"].any(), m
    assert ((0.9 < m["temperature"]) & (m["temperature"] < 1.1)).all(), m
    rate = W * n * stride / dt
    print(f"phase 38 walkers x 2-D space {W} x liq64k on {BLOCKS} blocks "
          f"bias_every=5: 1 stride of {stride} {dt:.3f} s {rate:.1f} "
          f"particle-steps/s summed over walkers launches={counts} "
          f"(walkers per launch {packed_lj_force_cuda.walkers // want}) "
          f"T={np.round(m['temperature'], 4).tolist()} on {smi}")
    return {"batch": counts["pair"], "batch masked": counts["pair masked"],
            "batch rate": rate}


# phase 39's hill-list runs: liq64k's two lamellar CVs, bench.py's hill
# widths, stride 500 (capacity 4096) and 50 (capacity 8 with and without
# a spill grid)
HL_SIGMA = 0.004


def hill_list_sampler(dev, capacity: int, stride: int, spill: bool):
    """liq64k (bench.py's spec and CVs) in hill-list mode through
    MetadSampler: grid_spec None, hill_sigma, hill_capacity and, with
    ``spill``, bench.py's grid as the spill grid."""
    from metadyn_tpu_torch import (
        HillSpec, MetadSampler, PackedEngine, WELL_TEMPERED,
        make_packed_langevin_step, make_system,
    )
    spec, cvs, gspec, _ = liq_parts(dev)
    engine = PackedEngine(spec, dev, rebuild_every=10)
    (state,) = liq_walker_states(dev, spec, engine, cvs, 1)
    return MetadSampler(
        make_system(spec.n_real, dev), state, engine, cvs, None,
        HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                        deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=KT),
        seed=0, bias_every=5, chunks_per_block=8,
        hill_sigma=[HL_SIGMA, HL_SIGMA], hill_capacity=capacity,
        spill_grid=gspec if spill else None)


def hill_list_table(dev, smi: str, exact: dict) -> dict:
    """Phase 39: hill-list mode and the neighbour-table path.  (1) liq64k
    in list mode (capacity 4096, stride 500): 1 warm and 2 timed strides
    (exactly 501 launches per stride, as grid mode), then V and dV/ds at
    the last CV point against evaluate_on_grid's V and the analytic sum in
    float64 of the same hills (rtol 1e-5; gradient rtol 1e-4 + 1e-6 max);
    (2) capacity 8, stride 50, 10 strides: with the spill grid the two
    hills past capacity go onto it (no overflow; the spill grid's V equals
    the float64 sum of those two hills at its nodes, atol 1e-6 of its max),
    without one the flag is raised and cv_out_of_grid reports it;
    (3) Config 3 exact at 62,500 with nbr_table = (coordination r_cut +
    skin, 96): the table's values and bias forces against kernels 2 and 3
    on the same state (rtol 2e-5; 2e-3 + 2e-4 max), no overflow; timed as
    phase 11 (per stride 101 pair launches and the stride end's 2 values,
    no order kernel inside a stride), rate and busy ms beside phase 11's."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import Box, GridSpec, PackedEngine
    from metadyn_tpu_torch.bias.hill_list import (
        evaluate_on_grid, value_and_grad,
    )
    from metadyn_tpu_torch.cv.packed_order import make_table_order_force
    from metadyn_tpu_torch.ops.neighbor_table import (
        build_slot_neighbor_table,
    )
    from metadyn_tpu_torch.ops.packed_order_cuda import (
        order_force_cuda, order_values_cuda,
    )

    t39 = time.perf_counter()
    out = {}
    # (1) list mode at capacity 4096
    s = hill_list_sampler(dev, 4096, STRIDE, False)
    s.run(STRIDE)
    n = s.engine.spec.n_real
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hist = s.run(2 * STRIDE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    assert counts == {**{k: 0 for k in counts}, "pair": 2 * (STRIDE + 1)}, \
        counts
    for m in hist:
        assert 0.9 < float(m["temperature"]) < 1.1, m
        assert not m["cv_out_of_grid"] and not m["nlist_overflow"], m
    b = s.bias
    assert int(b.n_hills) == 3 and not bool(b.overflowed)
    c = b.centers[:3].double().cpu().numpy()
    h = b.heights[:3].double().cpu().numpy()

    def sum64(pts):
        """V and dV/ds of the three hills at points (P, 2), float64."""
        dd = (pts[:, None, :] - c[None]) / HL_SIGMA
        g = h * np.exp(-0.5 * (dd ** 2).sum(-1))
        return g.sum(1), (g[..., None] * (-dd / HL_SIGMA)).sum(1)

    # half a width from the last hill's centre: its own term dominates and
    # the gradient is not 0
    x = (c[2] + 0.5 * HL_SIGMA).astype(np.float32)
    V64, dV64 = sum64(x[None].astype(np.float64))
    V, dV = value_and_grad(b, torch.as_tensor(x, device=dev))
    ev = GridSpec.create(list(x - 2 * HL_SIGMA), list(x + 2 * HL_SIGMA),
                         [5, 5], [HL_SIGMA, HL_SIGMA], dev)
    nodes = torch.stack(torch.meshgrid(ev.axis_coords(0), ev.axis_coords(1),
                                       indexing="ij"), -1).reshape(-1, 2)
    Vn64, _ = sum64(nodes.double().cpu().numpy())
    Vg = evaluate_on_grid(b, ev).reshape(-1).double().cpu().numpy()
    dVV = abs(float(V) - V64[0]) / abs(V64[0])
    dVg = float(np.abs(Vg - Vn64).max() / np.abs(Vn64).max())
    dG = float(np.abs(dV.cpu().numpy() - dV64[0]).max())
    assert dVV <= 1e-5 and dVg <= 1e-5, (dVV, dVg)
    assert dG <= 1e-4 * np.abs(dV64).max() + 1e-6, (dG, dV64)
    rate = n * 2 * STRIDE / dt
    print(f"phase 39 hill-list liq64k capacity 4096: 2 strides {dt:.3f} s "
          f"{rate:.1f} particle-steps/s launches={counts} n_hills="
          f"{int(b.n_hills)}; at s={x.tolist()}: V {float(V):.9g} float64 "
          f"{V64[0]:.9g} (rel {dVV:.3e}); evaluate_on_grid on 5 x 5 nodes "
          f"around it against float64: max rel {dVg:.3e}; max|d dV/ds|="
          f"{dG:.3e} of {np.abs(dV64).max():.3e} on {smi}")
    out["list"] = {"launches": counts["pair"], "rate": rate}
    del s, b
    # (2) capacity 8 with and without the spill grid
    from metadyn_tpu_torch.bias.grid import hill_field
    for spill in (True, False):
        s = hill_list_sampler(dev, 8, 50, spill)
        hist = s.run(10 * 50)
        b = s.bias
        assert int(b.n_hills) == 10, int(b.n_hills)
        if spill:
            assert not bool(b.overflowed) and not hist[-1]["cv_out_of_grid"]
            ref = None
            for m in hist[8:]:
                dv, _ = hill_field(b.spill.spec, torch.as_tensor(
                    m["cv"], device=dev).double(), torch.tensor(
                    float(m["hill_height"]), dtype=torch.float64,
                    device=dev))
                ref = dv if ref is None else ref + dv
            dsp = float((b.spill.V.double() - ref).abs().max())
            vmax = float(ref.abs().max())
            assert vmax > 0 and dsp <= 1e-6 * vmax, (dsp, vmax)
            print(f"phase 39 hill-list capacity 8 with the spill grid: 10 "
                  f"hills, 8 in the buffer, the spill grid's V against the "
                  f"float64 sum of the last 2: max|dV|={dsp:.3e} of "
                  f"{vmax:.3e}; overflowed={bool(b.overflowed)}")
        else:
            assert bool(b.overflowed) and hist[-1]["cv_out_of_grid"]
            assert not hist[7]["cv_out_of_grid"]
            first = 1 + next(i for i, m in enumerate(hist)
                             if m["cv_out_of_grid"])
            print(f"phase 39 hill-list capacity 8 without a spill grid: "
                  f"overflowed={bool(b.overflowed)}, cv_out_of_grid from "
                  f"stride {first}")
        del s, b
    torch.cuda.empty_cache()

    # (3) the neighbour table at Config 3
    pos, vel, L, a, spec = config3_inputs(32, noise=0.05)
    cvs = config3_cvs(spec, a)
    r_nb = cvs[1].r_cut + spec.skin
    K = 96
    st, overflow = PackedEngine(spec, dev).pack_state(
        pos, Box.cubic(L, dev), np.zeros(pos.shape[0], np.int32),
        np.ones(pos.shape[0], np.float32), np.ones(pos.shape[0], np.float32),
        vel=vel)
    assert not overflow
    tbl, ovf = build_slot_neighbor_table(st, spec, r_nb, K)
    assert not bool(ovf), "the neighbour table overflows K"
    tv, tf = make_table_order_force(cvs, spec)
    s_t, terms = tv(st, tbl)
    tk = order_values_cuda(st, spec, cvs)
    s_k = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tk)])
    dV = torch.tensor([0.9, -1.3], device=dev)
    g_t = tf(st, tbl, terms, dV)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in enumerate(zip(cvs, tk))]
    g_k = order_force_cuda(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    ds = float(((s_t - s_k).abs() / s_k.abs()).max())
    assert ds <= 2e-5, (ds, s_t, s_k)
    eg, gmax = force_close("phase 39 table force vs kernel 3", g_t, g_k,
                           2e-3, 2e-4)
    most = int((tbl < spec.n_pad).sum(0).max())
    build_ms = cuda_ms(lambda: build_slot_neighbor_table(st, spec, r_nb, K),
                       calls=5, warm=1)
    vals_ms = cuda_ms(lambda: tv(st, tbl), calls=10)
    force_ms = cuda_ms(lambda: tf(st, tbl, terms, dV), calls=10)
    print(f"phase 39 neighbour table Config 3 N={spec.n_real} r_nb={r_nb:.4f}"
          f" K={K}: the most neighbours of a slot {most}; table values vs "
          f"kernel 2 rel_ds={ds:.3e} s={s_t.tolist()}; table force vs kernel "
          f"3 max|dg|={eg:.3e} (max|g|={gmax:.3e}); build_ms={build_ms:.3f} "
          f"values_ms={vals_ms:.3f} force_ms={force_ms:.3f} (plain PyTorch "
          f"gathers) on {smi}")
    del st, tbl, terms, g_t, g_k
    torch.cuda.empty_cache()
    got = {}
    counts = config3_timed(
        dev, False, warm=(2, 2), n_runs=1, n_timed=2,
        per_stride={"pair": 101, "values": 2}, smi=smi,
        engine_cls=table_engine(r_nb, K),
        tag=f"config3 exact nbr_table=({r_nb:.4f}, {K})", out=got)
    prof, base = got["profile"], exact["profile"]
    print(f"phase 39 config3 exact particle-steps/s: nbr_table "
          f"{got['rates']} against the order kernels (phase 11) "
          f"{exact['rates']}; busy ms per stride {prof['busy_ms']:.1f} "
          f"against {base['busy_ms']:.1f} on {smi}")
    out["table"] = {"counts": counts, "rates": got["rates"],
                    "busy_ms": prof["busy_ms"]}
    print(f"hill-list and table phase 39: {time.perf_counter() - t39:.1f} s")
    return out


def blocks_entries(b35: dict, b36: dict, b37: dict, b38: dict, entry,
                   keys) -> list:
    """The kernels line's entries of the 2-D blocks' variants (phase 35,
    timed on block 0's 9 x 9 x 14 extended grid of Config 3, the walker
    batch on block 0 of the liquid's); launches from phase 36's timed run
    (2 strides of Config 3 exact), phase 37's (1 period of Config 5) and
    phase 38's CLI run."""
    staged = "the staged block-per-cell kernel (csrc/cell_stage.cuh)"
    c36, r38 = b36["counts"], b38["run"]

    def var(key):
        return {f"block 0 of {BLOCKS} (9 x 9 x 14) config3": dict(
            zip(keys, b35[key]))}

    return [
        entry("packed_lj_force 2-D blocks", "packed_lj_force",
              "metadyn_tpu/ops/packed_pallas2.py:301 on the reference's "
              "2-D islands, metadyn_tpu/parallel/spatial2d.py:179-185",
              c36["pair"], b35["pair"],
              design=staged + " on a block's (cx_l + 2, cy_l + 2, cz) "
              "extended grid, ghost rows dropped",
              launches_by_path={
                  "config3 exact 2-D 2x2 (2 timed strides)": c36["pair"],
                  "config5 N=1048576 2-D 2x2 (1 period)": b37["launches"],
                  "cli config4_walkers_sk_dd [2, 2] run": r38["pair"]},
              variants=var("pair")),
        entry("packed_lj_force cell_mask energy 2-D blocks",
              "packed_lj_force",
              "XLA packed_lj_force(cell_mask=) in the reference's 2-D "
              "island, metadyn_tpu/parallel/spatial2d.py:188-189",
              c36["pair masked"], b35["pair masked energy"],
              design=staged + "; each block's energy and virial times its "
              "cell's interior weight (ghost planes of x and y 0)",
              launches_by_path={
                  "config3 exact 2-D 2x2 (2 timed strides)":
                  c36["pair masked"],
                  "config5 N=1048576 2-D 2x2 (1 period)": b37["masked"],
                  "cli config4_walkers_sk_dd [2, 2] run":
                  r38["pair masked"]},
              variants=var("pair masked energy")),
        entry("packed_order_values cell_mask 2-D blocks", "packed_order",
              "metadyn_tpu/ops/packed_order_pallas.py:257 on the "
              "reference's 2-D islands, metadyn_tpu/parallel/"
              "spatial2d.py:270", c36["values masked"],
              b35["values masked"],
              design=staged + "; each cell's partials row times its weight",
              launches_by_path={"config3 exact 2-D 2x2 (2 timed strides)":
                                c36["values masked"]},
              variants=var("values masked")),
        entry("packed_order_force 2-D blocks", "packed_order",
              "metadyn_tpu/ops/packed_order_pallas.py:309 on the "
              "reference's 2-D islands, metadyn_tpu/parallel/"
              "spatial2d.py:282", c36["force"], b35["force"],
              design=staged + ", ghost rows dropped",
              launches_by_path={"config3 exact 2-D 2x2 (2 timed strides)":
                                c36["force"]},
              variants=var("force")),
        entry("packed_lj_force walker batch x cell_mask 2-D blocks",
              "packed_lj_force",
              "metadyn_tpu/ops/packed_pallas2.py:301 and metadyn_tpu/"
              "parallel/spatial2d.py:188 (the reference's nested 2-D "
              "islands: one walker per chip plane)", b38["batch masked"],
              b35["walker batch masked"],
              design=staged + "; the walker batch on a block's extended "
              "grid, each block's energy and virial times its cell's "
              "interior weight",
              launches_by_path={f"walkers x 2-D space {WALKERS_DD} x "
                                "liq64k (1 stride of 100; masked, with "
                                "energy)": b38["batch masked"],
                                f"walkers x 2-D space (1 stride; every "
                                f"launch, {WALKERS_DD} walkers each)":
                                b38["batch"]},
              variants={f"{k} block 0 of {BLOCKS} liq64k W={WALKERS_DD}":
                        dict(zip(keys, v)) for k, v in b35.items()
                        if k.startswith("walker batch")}),
    ]


def kernel_ab_device_ms():
    """scripts/kernel_ab.py's device_ms (each call enqueued while the device
    sleeps, between two CUDA events: the device time alone), loaded by
    path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", ROOT / "scripts" / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def kernel_event_ms(fn, match: str, calls: int = 25, warm: int = 3,
                    windows: int = 4) -> float:
    """Median device time in ms of the one kernel whose name holds
    ``match`` that each call of ``fn()`` launches, from torch.profiler's
    kernel events (the device's own start and end): the call's other device
    work (memsets, copies, other kernels) left out.  Late in a long process
    the first profiling window after a stretch without the profiler hands
    over fewer events than kernels ran (11-21 of 25, with or without idle
    host time around the calls), and the next window all of them: a
    window that leaves the events short of ``calls`` is followed by
    another, up to ``windows``.  The median is taken over all the events
    handed over, at least ``calls`` // 2, and never more than ``calls``
    from one window.  The events each window handed over are kept in
    ``kernel_event_ms.handed``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    durs, handed = [], []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        got = [e.duration_ns() / 1e6
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and match in e.name()]
        assert len(got) <= calls, (match, len(got), calls)
        handed.append(len(got))
        durs += got
        if len(durs) >= calls:
            break
    kernel_event_ms.handed = handed
    assert len(durs) >= calls // 2, (match, handed, calls)
    return statistics.median(durs)


kernel_event_ms.handed = []


def parts_bound(parts, mono: bool, n_pad: int, pairs: dict) -> tuple:
    """(bound ms, bound by) of one parts subset: the positions read and the
    forces it writes, and the FP32 operations of the pairs its math needs
    (the LJ pairs with lj, each CV's pairs inside its cut-off with vals or
    force); {} moves the positions alone."""
    fp = FLOP_PER_PAIR
    q6 = "q6_mono" if mono else "q6"
    nbytes = 12 * n_pad * (1 + ("lj" in parts) + ("force" in parts))
    ops = pairs["lj"] * fp["lj"] if "lj" in parts else 0
    for part, suffix in (("vals", "value"), ("force", "force")):
        if part in parts:
            ops += (pairs["q6"] * fp[f"{q6}_{suffix}"]
                    + pairs["coord"] * fp[f"coord_{suffix}"])
    return bound(nbytes, ops)


def staged_regs(parts, mono: bool) -> str:
    """ptxas's registers and spill stores of the order_staged_kernel
    instantiation that a subset runs on Config 3's CV list ([Q6,
    coordination]: kinds mixed, l 6, the fixed value lanes with vals): the
    parts library's (Split), or kernel 4's for the full set."""
    import re
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        ALL_PARTS, KERNEL as FUSED, PARTS_KERNEL,
    )
    full = frozenset(parts) == ALL_PARTS
    bits = [int(p in parts) for p in ("lj", "vals", "force")]
    pat = (f"order_staged_kernelILb{bits[0]}ELb{bits[1]}ELb{bits[2]}ELb0ELi3"
           f"ELi6ELi{2 if bits[1] else 0}ELb{int(mono)}ELb{int(not full)}EE")
    text = " ".join(ptxas_lines(FUSED if full else PARTS_KERNEL, pat))
    regs = re.search(r"Used (\d+) registers", text)
    spill = re.search(r"(\d+) bytes spill stores", text)
    return (f"{regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} bytes spill stores")


def parts_split(dev, smi: str, lag: dict) -> dict:
    """Phase 40: kernel 4's parts subsets at Config 3 (62,500, Npad 87,808,
    the lagged path's state after its timed strides, Q6 + coordination,
    bias coefficients from dV/ds = (0.9, -1.3)).  For each of the 8 subsets
    (the full one is kernel 4 itself) in the recurrence and the monomial
    mode: the kernel against its plain version at kernel 4's gates (f
    atol 1e-3 max|f|, g rtol 2e-3 + 2e-4 max|g|, values rtol 2e-4), the
    outputs it leaves out exactly zero, its time with the launch (cuda_ms),
    the kernel's own device time (kernel_event_ms: the profiler's events of
    order_staged_kernel alone) and the wrapper's (kernel_ab's device_ms:
    with the zeroed outputs' memsets, the geometry copy, the value lanes'
    reduction and, in mono mode, the aux and decode products), its plain
    version's time and its bound.  Prints the split of the kernel's time:
    staging ({}), then what lj, vals and force each add.  The parts
    counters are set to 0 just before and read just after: every subset
    launched.  Returns {variant key: (max abs err, ms, plain ms, bound ms,
    bound by, kernel device ms, wrapper device ms, launches)}."""
    import itertools
    import torch
    from metadyn_tpu_torch.cv.packed_order import order_values_plain
    from metadyn_tpu_torch.ops.packed_fused_cuda import (
        ALL_PARTS, fused_lj_order_force_cuda, fused_lj_order_force_plain,
        parts_key,
    )

    t40 = time.perf_counter()
    st, spec, cvs = lag["state"], lag["spec"], lag["cvs"]
    assert (spec.cap, spec.n_pad) == (32, 87808), (spec.cap, spec.n_pad)
    dV = torch.tensor([0.9, -1.3], device=dev)
    terms = order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in enumerate(zip(cvs, terms))]
    device_ms = kernel_ab_device_ms()
    pairs = {"q6": pairs_within(st, spec, cvs[0].r_cut),
             "coord": pairs_within(st, spec, cvs[1].r_cut),
             "lj": pairs_within(st, spec, spec.r_cut)}
    subsets = [frozenset(c) for k in range(4)
               for c in itertools.combinations(sorted(ALL_PARTS), k)]
    torch.cuda.synchronize()
    reset_counts()
    out, dev_ms, wrap_ms, handed = {}, {}, {}, {}
    for mono in (False, True):
        for parts in subsets:
            def kernel():
                return fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                                 parts=parts, mono=mono)

            def plain():
                return fused_lj_order_force_plain(st, spec, cvs, auxs,
                                                  parts=parts, mono=mono)

            key = parts_key(parts, mono)
            fk, gk, tk = kernel()
            fp, gp, tp = plain()
            torch.cuda.synchronize()
            errs = []
            for part, a, b, rtol, atol in (("lj", fk, fp, 0.0, 1e-3),
                                           ("force", gk, gp, 2e-3, 2e-4)):
                if part in parts:
                    errs.append(force_close(f"{key} {part}", a, b, rtol,
                                            atol)[0])
                else:
                    assert int(torch.count_nonzero(a)) == 0, (key, part)
            if "vals" in parts:
                sk = torch.stack([cv.finalize_value(t)
                                  for cv, t in zip(cvs, tk)])
                sp = torch.stack([cv.finalize_value(t)
                                  for cv, t in zip(cvs, tp)])
                ds = float(((sk - sp).abs() / sp.abs()).max())
                assert ds <= 2e-4, (key, ds, sk, sp)
                lanes_close(f"{key} values", cvs, tk, tp, 2e-4)
                errs.append(float((lanes_of(tk) - lanes_of(tp)).abs().max()))
            else:
                assert int(torch.count_nonzero(lanes_of(tk))) == 0, key
            ms = cuda_ms(kernel)
            dev_ms[key] = kernel_event_ms(kernel, "order_staged_kernel")
            handed[key] = kernel_event_ms.handed
            wrap_ms[key] = device_ms(kernel)
            plain_ms = cuda_ms(plain, calls=5, warm=1)
            out[key] = (max(errs, default=0.0), ms, plain_ms,
                        *parts_bound(parts, mono, spec.n_pad, pairs),
                        dev_ms[key], wrap_ms[key])
    torch.cuda.synchronize()
    counts = dict(fused_lj_order_force_cuda.parts_launches)
    mono_full = fused_lj_order_force_cuda.mono_launches
    counts[parts_key(ALL_PARTS, True)] = mono_full
    counts[parts_key(ALL_PARTS, False)] = (fused_lj_order_force_cuda.launches
                                           - mono_full)
    assert set(counts) == set(out) and all(v > 0 for v in counts.values()), \
        counts
    for key, v in out.items():
        n_launch = counts[key]
        out[key] = (*v, n_launch)
        parts_of = next(p for p in subsets for m in (False, True)
                        if parts_key(p, m) == key)
        print(f"parts {key}: max_abs_err={v[0]:.3e} kernel_ms={v[1]:.4f} "
              f"kernel_device_ms={v[5]:.4f} (events handed over per window "
              f"{handed[key]} of 25) wrapper_device_ms={v[6]:.4f} "
              f"plain_ms={v[2]:.4f} "
              f"bound_ms={v[3]:.5f} ({v[4]}) share={v[3] / v[5]:.4f} "
              f"launches={n_launch} "
              f"({staged_regs(parts_of, key.endswith('mono'))}) on {smi}")
    for mono in (False, True):
        m = " mono" if mono else ""
        base = dev_ms["{}" + m]
        adds = {p: dev_ms["{" + p + "}" + m] - base
                for p in ("lj", "vals", "force")}
        whole = dev_ms["{force, lj, vals}" + m]
        print(f"parts split{m or ' recurrence'} (order_staged_kernel's "
              f"device ms): staging {{}} "
              f"{base:.4f}; + lj {adds['lj']:.4f}, + vals "
              f"{adds['vals']:.4f}, + force {adds['force']:.4f}; staging + "
              f"the three adds {base + sum(adds.values()):.4f} against the "
              f"whole kernel {whole:.4f}; {{vals, force}} "
              f"{dev_ms['{force, vals}' + m]:.4f}; the wrapper's device ms "
              f"{{}} {wrap_ms['{}' + m]:.4f}, whole "
              f"{wrap_ms['{force, lj, vals}' + m]:.4f} on {smi}")
    print(f"parts phase 40: {time.perf_counter() - t40:.1f} s; pairs "
          f"{pairs}")
    return out


def gsd_cli(dev, smi: str) -> dict:
    """Phase 41: GSD trajectories through the CLI on the card.
    examples/config1_lj_lamellar.yaml (the example whose runs write frames:
    packed runs write none, as in the reference), with only output.*
    changed, as written (500 steps, a frame per report of 250) once to an
    npz and once to a .gsd trajectory: the native core wrote, every frame's
    positions, images, box and step equal between the files to the bit,
    rdf on the .gsd equal to rdf on the npz; then the .gsd run's resume leg
    (--resume for 500 more; run.n_steps is per leg) against one straight
    run of 1000 steps: the legs' file is the straight run's frames written
    again with each leg's own step count (the reference's CLI counts each
    leg from 0), byte for byte.  The launch counts are set to 0 before the
    runs and read after (no parts subset).  Returns the walls."""
    import tempfile
    import numpy as np
    import torch
    from metadyn_tpu_torch import cli
    from metadyn_tpu_torch.io.gsd_file import GSDWriter, read_gsd_frames
    from metadyn_tpu_torch.io.trajectory import read_trajectory

    t41 = time.perf_counter()
    reset_counts()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_gsd_"))
    walls, paths, rdfs = {}, {}, {}
    for tag, traj, extra, n_mult, resume in (
            ("npz", "traj.npz", {}, 1, False),
            ("gsd", "traj.gsd", {"checkpoint": "ck.npz"}, 1, False),
            ("gsd resume leg", "traj.gsd", {"checkpoint": "ck.npz"}, 1,
             True),
            ("gsd straight", "straight.gsd", {}, 2, False)):
        d = tmp / ("straight" if n_mult == 2 else traj.split(".")[1])
        d.mkdir(exist_ok=True)
        cfg = cli_yaml("config1_lj_lamellar", d, trajectory=str(d / traj),
                       **extra)
        cfg["run"]["n_steps"] = int(cfg["run"]["n_steps"]) * n_mult
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cli.CliRun(cfg, resume=resume, device=dev)
        r.run()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        paths[tag] = cfg["output"]["trajectory"]
        if tag == "gsd":
            assert r.traj.native, "the GSD writer's native core"
            n = r.sampler.state.n
        if tag in ("npz", "gsd"):
            outp = str(tmp / f"rdf_{tag}.npz")
            assert cli.main(["rdf", paths[tag], "--out", outp]) == 0
            with np.load(outp) as z:
                rdfs[tag] = (z["r"], z["g"])
            if tag == "gsd":
                first = read_gsd_frames(paths[tag])
    npz = read_trajectory(paths["npz"])
    assert len(first) == npz["step"].shape[0] == 2, len(first)
    for i, fr in enumerate(first):
        assert np.array_equal(fr["particles/position"], npz["pos"][i]), i
        assert np.array_equal(fr["particles/image"], npz["image"][i]), i
        assert int(fr["configuration/step"][0]) == int(npz["step"][i]), i
        assert np.array_equal(fr["configuration/box"][:3], npz["box_L"][i])
    assert all(np.array_equal(a, b)
               for a, b in zip(rdfs["npz"], rdfs["gsd"])), "rdf differs"
    counts = read_counts()
    legs = pathlib.Path(paths["gsd resume leg"]).read_bytes()
    straight = read_gsd_frames(paths["gsd straight"])
    leg_steps = [int(f["configuration/step"][0])
                 for f in read_gsd_frames(paths["gsd resume leg"])]
    n_leg = len(straight) // 2
    assert leg_steps == [int(f["configuration/step"][0])
                         for f in straight[:n_leg]] * 2, leg_steps
    expected = tmp / "expected.gsd"
    w = GSDWriter(str(expected))
    for fr, step in zip(straight, leg_steps):
        w.append(fr["particles/position"], fr["particles/image"],
                 fr["configuration/box"][:3], step=step)
    w.close()
    assert legs == expected.read_bytes(), "the two legs' .gsd differs " \
        "from the straight run's frames"
    print(f"gsd phase 41: config1 N={n} walls (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; native core; .gsd and npz frames equal to the bit (2 "
          f"frames), rdf equal; the two legs' file byte for byte the "
          f"straight run's {len(straight)} frames with the legs' steps "
          f"{leg_steps} ({len(legs)} bytes); packed launches "
          f"{ {k: v for k, v in counts.items() if v} }; "
          f"{time.perf_counter() - t41:.1f} s on {smi}")
    shutil.rmtree(tmp, ignore_errors=True)
    return walls


def pack_1m(melt: dict, relaxed: tuple, dev, smi: str) -> dict:
    """Phase 42: ops/packed.pack on the card at Config 5's 1,048,576-bead
    production start (phase 21's relaxed melt, config5_sampler's spec: cap
    48, Npad 13,799,808, the bond partners and the mesh coefficients as
    attributes) against pack_host: every array to the bit.  Prints both
    times (pack cold, then warm; pack_host with its one copy to the card)
    and pack's peak device memory."""
    import numpy as np
    import torch
    from metadyn_tpu_torch import Box, PackedSpec
    from metadyn_tpu_torch.ops.packed import pack, pack_host

    n, L, types = melt["n"], melt["L"], melt["types"]
    pos, vel = relaxed
    spec = PackedSpec.create(L, n, r_cut=WCA_RC, skin=0.5, cap=48,
                             fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    box = Box.cubic(L, dev)
    ones = np.ones(n, np.float32)
    attrs = {**melt["bp"],
             "mesh": np.asarray([1.0, -1.0], np.float32)[types]}
    args = (pos, box, spec, types, ones, ones, dev)
    times = {}
    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    for tag in ("pack cold", "pack warm", "pack_host"):
        fn = pack_host if tag == "pack_host" else pack
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, ovf = fn(*args, vel=vel, extra_attrs=attrs)
        ovf = bool(ovf)
        torch.cuda.synchronize()
        times[tag] = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / gib
        if tag == "pack warm":
            mine, peak_pack = st, peak
        elif tag == "pack_host":
            host = st
        assert not ovf, f"{tag}: overflow at the production pack"
        del st
    fields = ("r", "v", "f", "image", "ref_r", "pid", "typ", "slot_of",
              "potential_energy", "virial")
    for k in fields:
        a, b = getattr(mine, k), getattr(host, k)
        if k == "potential_energy":   # 0-d against pack_host's (1,) zero
            a, b = a.reshape(-1), b.reshape(-1)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert mine.attrs.keys() == host.attrs.keys()
    for k in mine.attrs:
        assert torch.equal(mine.attrs[k], host.attrs[k]), k
    print(f"pack phase 42: config5 N={n} cap {spec.cap} Npad {spec.n_pad}: "
          f"pack equal to pack_host to the bit ({len(fields)} arrays and "
          f"{len(mine.attrs)} attrs); "
          + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
          + f"; pack's peak device memory above its inputs "
          f"{peak_pack:.3f} GiB on {smi}")
    return {"times": times, "peak_gib": peak_pack}


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

    # 2. build, every source at once (the kernels with nvcc, the GSD
    # writer's core with the host compiler)
    from metadyn_tpu_torch.io.gsd_file import NATIVE as GSD_LIB
    order_libs = (packed_order_cuda.KERNEL, packed_fused_cuda.KERNEL,
                  packed_fused_cuda.PARTS_KERNEL)
    build_secs = build_all((KERNEL, packed_v1_cuda.KERNEL) + order_libs
                           + (GSD_LIB,))
    print(f"build: csrc/{GSD_LIB}.cpp {_build.cxx()} "
          f"{' '.join(_build.CXX_FLAGS)} {build_secs[GSD_LIB]:.2f} s")
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
    rates, d2h = {}, {}
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
        d2h[bias_every] = prof["d2h_count"]
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
    lag_out = {}
    lag_counts = config3_timed(
        dev, True, warm=(2, 2), n_runs=2, n_timed=4,
        per_stride={"pair": 91, "fused": 10, "values": 2}, smi=smi[0],
        out=lag_out)
    exact_out = {}
    exact_counts = config3_timed(
        dev, False, warm=(2, 2), n_runs=1, n_timed=2,
        per_stride={"pair": 101, "values": 12, "force": 10}, smi=smi[0],
        out=exact_out)

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

    # 26.-27. the slab decomposition: its kernel variants against their
    # plain versions on the extended grids, the slice against PackedEngine,
    # the sharded repack bit for bit, Config 3 timed with 1 and 2 shards,
    # the CLI's spatial_devices
    t26 = time.perf_counter()
    sp_kern = spatial_kernels_vs_plain(dev)
    sp = spatial_slice(dev, smi[0], lag_out["rates"])
    print(f"spatial phases 26-27: {time.perf_counter() - t26:.1f} s")

    # 28. the well-tempered ensemble: the energy CV on kernel 1 with energy
    # at every force call, at 62,500 and config6_wte.yaml through the CLI
    wte = wte_phase(dev, smi[0])

    # 29. the walkers: kernel 1's walker batch against single launches and
    # the plain version, WalkerSampler against MetadSampler, 8 x liq64k
    # timed, config4_walkers.yaml through the CLI, the flux walkers
    walk = walkers_phase(dev, smi[0], rates[5][0])

    # 30.-34. the moving box and the walkers x space product: NPT at
    # 62,500 (kernel 1 reading the moved cell matrix from device memory),
    # box metadynamics and the MSD CV, NPT walkers with a box each,
    # Config 5 at 1M on two x-slabs with the sharded S(k) CV, walkers on
    # the slabs
    npt = npt_phase(dev, smi[0], d2h[5])
    box = box_meta_phase(dev, smi[0], npt)
    del npt["state"]
    npt_walk = npt_walkers_phase(dev, smi[0], npt)
    relaxed5 = cfg5.pop("relaxed")
    slabs5 = config5_slabs(melt5, relaxed5, dev, smi[0])
    wsp = walkers_space_phase(dev, smi[0], walk["rate"])

    # 35.-39. the 2-D decomposition: the kernels on the blocks' extended
    # grids, Config 3 exact on 2 x 2 blocks, Config 5 at 1M with the
    # pencil-FFT S(k) (and the mesh CV's deterministic scatter), the CLI
    # with spatial_devices [2, 2] and walkers x 2-D space; hill-list mode
    # and the neighbour-table path
    b35 = blocks_kernels(dev, smi[0])
    b36 = config3_blocks(dev, smi[0], exact_out)
    b37 = config5_blocks(melt5, relaxed5, melt, dev, smi[0], slabs5)
    b38 = cli_blocks(dev, smi[0])
    hill_list_table(dev, smi[0], exact_out)

    # 40.-42. the last slice: kernel 4's parts subsets at Config 3 (the
    # split of its time), GSD trajectories through the CLI, the sort-based
    # pack at 1M against pack_host
    parts = parts_split(dev, smi[0], lag_out)
    gsd_cli(dev, smi[0])
    pack_1m(melt5, relaxed5, dev, smi[0])
    del relaxed5
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
        **cfg5["variants"],
        **{f"{k} wte N=62500": v for k, v in wte["variants"].items()},
        **{f"{k} npt N=62500 (phase 30)": v
           for k, v in npt["variants"].items()}}
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
                                "init and energy refresh)": cross_launches,
                                "wte N=62500 (20 strides, every launch "
                                "with energy)": wte["launches"],
                                "cli config6_wte (build and run)":
                                wte["cli_launches"],
                                "npt N=62500 (2 strides, every launch with "
                                "energy, the box read from device memory)":
                                npt["launches"],
                                "box metadynamics N=62500 (3 strides of "
                                "100)": box["launches"],
                                "config5 N=1048576 on 2 slabs (1 period; "
                                "one launch per shard per force call)":
                                slabs5["launches"]},
              variants={k: dict(zip(keys, v)) for k, v in variants.items()}),
        entry(f"{KERNEL} per-walker box", KERNEL,
              "metadyn_tpu/ops/packed_pallas2.py:301 (the reference runs "
              "one NPT walker per chip, one launch each)",
              npt_walk["launches"],
              npt_walk["variants"][f"sentinel W={WALKERS_NPT} own boxes "
                                   "liq64k +energy"],
              design=staged + "; the walker batch, each block reading its "
              "walker's cell matrix (Box.geo, (W, 10)) from device memory",
              launches_by_path={f"npt walkers {WALKERS_NPT} x liq64k + WTE "
                                "(4 strides of 100, all with energy)":
                                npt_walk["launches"]},
              variants={k: dict(zip(keys, v))
                        for k, v in npt_walk["variants"].items()}),
        entry(f"{KERNEL} walker batch x cell_mask", KERNEL,
              "metadyn_tpu/ops/packed_pallas2.py:301 and "
              "metadyn_tpu/parallel/spatial.py:276 (the reference's nested "
              "islands: one walker per chip row, the masked energy as XLA)",
              wsp["masked"],
              wsp["variants"][f"sentinel W={WALKERS_DD} x cell_mask, shard "
                              f"0 of {SLABS} liq64k"],
              design=staged + "; the walker batch on a shard's extended "
              "grid, each block's energy and virial times its cell's "
              "interior weight",
              launches_by_path={f"walkers x space {WALKERS_DD} x liq64k on "
                                f"{SLABS} slabs (2 strides; masked, with "
                                "energy)": wsp["masked"],
                                f"walkers x space (2 strides; every launch, "
                                f"{WALKERS_DD} walkers each)":
                                wsp["launches"],
                                "config5 N=1048576 on 2 slabs (1 period; "
                                "masked, with energy)": slabs5["masked"],
                                "cli config4_walkers_sk_dd run (masked)":
                                cli["config4_walkers_sk_dd"][1][
                                    "pair masked"]},
              variants={k: dict(zip(keys, v))
                        for k, v in wsp["variants"].items()}),
        entry(f"{KERNEL} walker batch", KERNEL,
              "metadyn_tpu/ops/packed_pallas2.py:301 (the reference runs "
              "one walker per chip, one launch each)", walk["launches"],
              walk["variants"][f"sentinel W={WALKERS} liq64k"],
              design=staged + "; the grid of blocks once per walker on a "
              "second grid dimension, the energy reduction one block per "
              "walker",
              launches_by_path={f"walkers {WALKERS} x liq64k (2 strides, "
                                f"{WALKERS} walkers per launch)":
                                walk["launches"]},
              variants={k: dict(zip(keys, v))
                        for k, v in walk["variants"].items()}),
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
        entry("packed_fused_parts", packed_fused_cuda.PARTS_KERNEL,
              "metadyn_tpu/ops/packed_fused_pallas.py:296 (parts, :75, "
              ":143-229)",
              sum(v[-1] for k, v in parts.items()
                  if not k.startswith("{force, lj, vals}")),
              parts["{}"][:5],
              design=staged + ", prefiltered to the larger of the LJ and CV "
              "cut-offs for every subset; the outputs a subset leaves out "
              "are zeros (the wrapper's torch.zeros)",
              launches_by_path={"parts split at config3 N=62500 (phase 40: "
                                "checks and timing)": sum(
                                    v[-1] for k, v in parts.items()
                                    if not k.startswith("{force, lj, vals}")),
                                **parts_reads_by_path()},
              variants={k: {**dict(zip(keys, v[:5])),
                            "kernel_device_ms": v[5],
                            "wrapper_device_ms": v[6], "launches": v[7]}
                        for k, v in parts.items()}),
        *spatial_entries(sp_kern, sp, entry, keys),
        *blocks_entries(b35, b36, b37, b38, entry, keys),
        entry(v1_lib, v1_lib, "metadyn_tpu/ops/packed_pallas.py:185",
              lag_counts["v1"],
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
