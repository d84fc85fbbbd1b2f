"""Named phases, traces, a step-rate counter and a device-time profile
(counterpart of ``metadyn_tpu/utils/profiling.py``).

``phase(name)`` marks a region that ``torch.profiler`` shows by name.  The
sampler uses the reference's phase names (``nlist_rebuild``, ``md_steps``,
``cv_eval``, ``energy_refresh``, ``hill_deposit``), so traces of the two
packages read alike.  Outside a profiler run it has no effect on results.

``trace(log_dir)`` captures a ``torch.profiler`` trace of a block (the
host, and the GPU when there is one) into a Chrome-trace file under
``log_dir``; ``StepTimer`` counts steps and particle-steps per second of
wall time::

    with trace("/tmp/tb"):
        sampler.run(5000)
    timer = StepTimer(n_particles=n)
    sampler.run(5000); timer.lap(5000)   # synchronizes a CUDA device first
    print(timer.report())

``device_profile(fn)`` runs ``fn()`` once under ``torch.profiler`` and
reports how much of the wall time the GPU was busy, and on what.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def phase(name: str):
    """Named region in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when a CUDA device is there) into
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format: Perfetto and
    ``chrome://tracing`` read it); the counterpart of
    ``jax.profiler.start_trace``/``stop_trace``.  The file is written when
    the block ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step-rate counter (the north-star metric: particle-steps
    per second).  ``lap`` first waits for a CUDA device's queued work, so a
    lap times the work, not its enqueueing."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.t0 = time.perf_counter()
        self.steps = 0
        self.laps: list[tuple[int, float]] = []

    def lap(self, n_steps: int) -> float:
        """Record a finished segment of ``n_steps``; returns its
        particle-steps per second."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        self.steps += n_steps
        self.laps.append((n_steps, dt))
        return self.n * n_steps / dt

    def report(self) -> dict:
        tot_t = sum(d for _, d in self.laps)
        tot_s = sum(s for s, _ in self.laps)
        rate = tot_s / tot_t if tot_t else 0.0
        return {
            "steps": tot_s,
            "seconds": round(tot_t, 3),
            "steps_per_sec": round(rate, 1),
            "particle_steps_per_sec": round(rate * self.n, 1),
        }


def device_profile(fn, top: int = 8) -> dict:
    """Profile one call of ``fn()`` on the current CUDA device.

    Returns ``wall_ms`` (host clock around the call, ending in a
    synchronize; the profiler's own host overhead is in it), ``busy_ms``
    (the union of the GPU kernel and copy intervals), ``busy_share`` =
    busy_ms / wall_ms, ``device_ops`` (the kernels and copies the device
    ran), ``d2h_ms`` and ``d2h_count`` (device-to-host copies: the host
    syncs), the
    ``top`` kernels by summed device time, grouped by the first 60
    characters of their names, and ``post_s``, the host seconds the
    profiler took to hand over its events after the call.  It records the
    device's activity alone: the host-side events (several per device op)
    took most of a long call's hand-over and enter none of these
    numbers."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        t_post = time.perf_counter()
    # device-side events, less any phase() ranges mirrored on the GPU row,
    # read from the profiler's raw results: building its per-event Python
    # objects (``prof.events()``) took 0.2-0.4 ms per device op
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted(
        (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == cuda and not e.is_user_annotation())
    busy_us, end, by_name = 0.0, float("-inf"), defaultdict(float)
    d2h_count = sum(name.startswith("Memcpy DtoH") for _, _, name in spans)
    for s, e, name in spans:
        by_name[name[:60]] += e - s
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    d2h_us = sum(v for k, v in by_name.items() if k.startswith("Memcpy DtoH"))
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms, "device_ops": len(spans),
            "d2h_ms": d2h_us / 1e3, "d2h_count": d2h_count,
            "top_ms": {k: v / 1e3 for k, v in kernels},
            "post_s": time.perf_counter() - t_post}
