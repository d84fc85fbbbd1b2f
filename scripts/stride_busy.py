#!/usr/bin/env python3
"""Busy ms per stride of chip_smoke.py's phase 45 (the star melt) for one
source tree on one GPU.

    python3 scripts/stride_busy.py ROOT

ROOT is a checkout of this repository (the working tree, or an unpacked
``git archive`` of another commit); its ``metadyn_tpu_torch`` and
``chip_smoke.py`` are imported and its kernels built into its own
``_build/``.  It runs phase 45's path as ROOT's chip_smoke.py defines it:
the star melt (2,016 6-arm stars, 62,496 beads), Config 5's push-off (1000
soft steps at A 100, 500 at A 1000), then the slice (``star_sampler``: WCA
+ FENE at 6 bond slots, the S(k) CV, bias every step) for one warm stride
of 100 steps, one timed stride (host clock around it, ending in a
synchronize) and one profiled stride (``utils/profiling.device_profile``:
the union of the device's kernel and copy intervals, and the kernels with
the most device time).  To compare two commits, run the script once per
tree in turns on the same card (A, B, B, A).

Prints one line, ``BUSY {json}``.
"""
import json
import pathlib
import sys
import time


def main(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke as cs
    from metadyn_tpu_torch.core.pushoff import pushoff_pack
    from metadyn_tpu_torch.utils.profiling import device_profile

    if not torch.cuda.is_available():
        raise SystemExit("stride_busy: torch finds no CUDA device")
    assert pathlib.Path(cs.__file__).resolve().parent == root
    dev = torch.device("cuda", 0)
    melt = cs.star_melt()
    engine, st, spec = pushoff_pack(melt["pos"], melt["L"], melt["types"],
                                    melt["bp"], dev)
    st, aux = cs.config5_pushoff(engine, st)
    assert not bool(aux.overflow), "overflow in the star push-off"
    pos, _ = cs.relaxed_of(st, spec)
    melt = {**melt, "pos": pos}
    del engine, st, aux
    s, _ = cs.star_sampler(melt, dev)
    s.run(cs.CFG2_STRIDE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = s.run(cs.CFG2_STRIDE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    T = float(hist[-1]["temperature"])
    assert np.isfinite(T) and cs.STAR_T_BAND[0] < T < cs.STAR_T_BAND[1], T
    prof = device_profile(lambda: s.run(cs.CFG2_STRIDE))
    return {"tree": str(root), "card": torch.cuda.get_device_name(0),
            "stride_steps": cs.CFG2_STRIDE, "timed_stride_s": wall,
            "T": T, "busy_ms": prof["busy_ms"],
            "profiled_wall_ms": prof["wall_ms"], "top_ms": prof["top_ms"]}


if __name__ == "__main__":
    print("BUSY " + json.dumps(main(pathlib.Path(sys.argv[1]).resolve())))
