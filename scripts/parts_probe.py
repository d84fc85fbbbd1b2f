"""Kernel 4's parts subsets `{}` and `{lj}` in the recurrence and the
monomial mode, timed in turns (A B A B) on one card, and the size of every
instantiation of the parts library and of kernel 4 in SASS instructions.

    python3 scripts/parts_probe.py

Config 3's fcc + noise start (62,500 particles, cap 32; phase 8 of
chip_smoke.py), bias coefficients from dV/ds = (0.9, -1.3); device time
of the kernel alone from torch.profiler's kernel events, beside the
wrapper's device time by CUDA events around the same calls (its memsets,
copies and reduction included; chip_smoke.kernel_event_check).  The SASS
comes from the CUDA toolkit's cuobjdump ($CUDA_HOME/bin, default
/usr/local/cuda); functions of 4096 instructions or more print as 4096
(the count reads 4-digit offsets).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from metadyn_tpu_torch import Box, PackedEngine  # noqa: E402
from metadyn_tpu_torch.cv.packed_order import order_values_plain  # noqa: E402
from metadyn_tpu_torch.ops import _build  # noqa: E402
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("parts_probe: no CUDA device", file=sys.stderr)
        return 1
    cs.build_all((pfc.KERNEL, pfc.PARTS_KERNEL, pfc.PARTS_MONO_KERNEL))
    dev = torch.device("cuda", 0)
    pos, vel, L, a, spec = cs.config3_inputs(32, noise=0.05)
    n = pos.shape[0]
    st, _ = PackedEngine(spec, dev).pack_state(
        pos, Box.cubic(L, dev), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    cvs = cs.config3_cvs(spec, a)
    dV = torch.tensor([0.9, -1.3], device=dev)
    terms = order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, dV[i]) for i, (cv, t) in
            enumerate(zip(cvs, terms))]
    print(torch.cuda.get_device_name(0))
    for turn in range(4):
        for mono in (False, True):
            for parts in (frozenset(), frozenset({"lj"})):
                def call():
                    return pfc.fused_lj_order_force_cuda(
                        st, spec, cvs, auxs, parts=parts, mono=mono)

                ev = cs.kernel_event_check(call, "order_staged_kernel")
                print(f"probe turn {turn} {pfc.parts_key(parts, mono)}: "
                      f"kernel_device_ms={ev['kernel_ms']:.4f} "
                      f"wrapper_device_ms={ev['call_ms']:.4f}")
    cuobj = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "cuobjdump"
    for lib in (pfc.PARTS_KERNEL, pfc.PARTS_MONO_KERNEL, pfc.KERNEL):
        sass = subprocess.run([str(cuobj), "-sass",
                               str(_build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        name, count = None, {}
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                name = m.group(1)
                count[name] = 0
            elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", ln):
                count[name] += 1
        names = subprocess.run(["c++filt"], input="\n".join(count),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        for (k, v), dn in zip(count.items(), names):
            if "order_staged_kernel" in dn:
                print(f"sass {lib}: {v} instructions {dn.split('(')[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
