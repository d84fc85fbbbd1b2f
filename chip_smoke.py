#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

The workload is the headline one: the 62,500-particle LJ liquid
(bench_data/liq64k.npz) on the packed cell engine (r_cut 2.5, skin 0.55,
cap 40), BAOAB Langevin, two lamellar CVs on a 64x64 well-tempered grid
bias with edge walls, one hill per 500-step stride.  Phases, one line each:

  1. device: the card, and nvidia-smi's name and power limit;
  2. build: the pair-force kernel from metadyn_tpu_torch/csrc with nvcc;
  3. kernel vs plain PyTorch pair force at the workload's shapes, in both
     modes (forces only; with energy and virial), with times per call;
  4. the whole slice for 20 steps at gamma = 0 on the kernel engine and on
     the plain-force engine, from one state: positions must agree;
  5. the slice with bias_every=5: 1 warm stride, 4 timed strides;
  6. the strict slice with bias_every=1: 1 warm stride, 2 timed strides.

After each timed slice one more stride runs under torch.profiler, and a
line reports the GPU's busy share of it and the top kernels.

Then a JSON line describing each kernel, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; without a CUDA device it exits 1 and prints no result.

Run from the repository root:  python3 chip_smoke.py
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
STRIDE = 500
KT = 1.0


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
    from metadyn_tpu_torch.ops.packed import packed_lj_force, unpack_positions
    from metadyn_tpu_torch.ops.packed_cuda import KERNEL, packed_lj_force_cuda
    from metadyn_tpu_torch.utils.profiling import device_profile

    class PlainForceEngine(PackedEngine):
        """The engine with the plain PyTorch pair force in place of the
        kernel: the reference path of phase 4."""

        def _pair_force(self, state, with_energy):
            return packed_lj_force(state, self.spec, with_energy=with_energy)

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

    # 2. build
    secs = _build.build(KERNEL)
    ptxas = [ln.strip() for ln in
             _build.log_path(KERNEL).read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    print(f"build: csrc/{KERNEL}.cu nvcc {' '.join(_build.NVCC_FLAGS[:2])} "
          f"{secs:.2f} s")

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

    # 4. the slice at gamma = 0: kernel engine vs plain-force engine
    finals = []
    for cls in (PackedEngine, PlainForceEngine):
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

    print(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda",
        "source": f"metadyn_tpu_torch/csrc/{KERNEL}.cu",
        "replaces": "metadyn_tpu/ops/packed_pallas2.py:301",
        "launches": rates[5][1],
        "max_abs_err": max(errs.values()),
        "ms": times[False][0], "plain_ms": times[False][1]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
