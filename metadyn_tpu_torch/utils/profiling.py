"""Named phases and a device-time profile (counterpart of
``metadyn_tpu/utils/profiling.py``).

``phase(name)`` marks a region that ``torch.profiler`` shows by name.  The
sampler uses the reference's phase names (``nlist_rebuild``, ``md_steps``,
``cv_eval``, ``energy_refresh``, ``hill_deposit``), so traces of the two
packages read alike.  Outside a profiler run it has no effect on results.

``device_profile(fn)`` runs ``fn()`` once under ``torch.profiler`` and
reports how much of the wall time the GPU was busy, and on what.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


def phase(name: str):
    """Named region in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)


def device_profile(fn, top: int = 8) -> dict:
    """Profile one call of ``fn()`` on the current CUDA device.

    Returns ``wall_ms`` (host clock around the call, ending in a
    synchronize; the profiler's own host overhead is in it), ``busy_ms``
    (the union of the GPU kernel and copy intervals), ``busy_share`` =
    busy_ms / wall_ms, ``device_ops`` (the kernels and copies the device
    ran), ``d2h_ms`` (device-to-host copies: the host syncs), and the
    ``top`` kernels by summed device time, grouped by the first 60
    characters of their names."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events, less the phase() ranges mirrored on the GPU row
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy_us, end, by_name = 0.0, float("-inf"), defaultdict(float)
    for s, e, name in spans:
        by_name[name[:60]] += e - s
        if e > end:
            busy_us += e - max(s, end)
            end = e
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    d2h_us = sum(v for k, v in by_name.items() if k.startswith("Memcpy DtoH"))
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms, "device_ops": len(spans),
            "d2h_ms": d2h_us / 1e3,
            "top_ms": {k: v / 1e3 for k, v in kernels}}
