"""The GSD writer's two cores, the native C++ core (``csrc/gsd.cpp``) and
the Python one (``_PyFile``, ``METADYN_NO_NATIVE=1``), timed on the same
frames in turns (native, Python, Python, native) on the host.

    python3 scripts/gsd_write_bench.py [--dir DIR]

Two trajectories, each written whole through ``GSDWriter`` (the CLI's
writer) and closed:

- ``1m``: 16 frames of 1,048,576 particles (Config 5's size): the payload
  (positions and images, 24 MiB a frame) dominates;
- ``long``: 5,000 frames of 4,000 particles (the triclinic example's
  size, a frame every 200 of a million steps): the index, which both cores
  write again after every frame (the commit policy of ``csrc/gsd.cpp``),
  grows with the frames written.

Prints one line per turn and one JSON line of medians.  The files go to a
temporary directory under ``--dir`` (default: the system's temporary
directory) and are removed; the writes end in the page cache, no sync.
"""
import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from metadyn_tpu_torch.io import gsd_file  # noqa: E402

CASES = {"1m": (1_048_576, 16), "long": (4_000, 5_000)}


def write(path: str, n: int, frames: int, native: bool) -> float:
    """Seconds to write ``frames`` frames of ``n`` particles and close."""
    if native:
        os.environ.pop("METADYN_NO_NATIVE", None)
    else:
        os.environ["METADYN_NO_NATIVE"] = "1"
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 10.0, (n, 3)).astype(np.float32)
    img = rng.integers(-2, 3, (n, 3)).astype(np.int32)
    box = np.asarray([10.0, 10.0, 10.0], np.float32)
    t0 = time.perf_counter()
    w = gsd_file.GSDWriter(path)
    assert w.native == native
    for i in range(frames):
        w.append(pos, img, box, step=200 * (i + 1))
    w.close()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    gsd_file._lib()          # build the core before any timing
    out = {}
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        for case, (n, frames) in CASES.items():
            times = {True: [], False: []}
            sizes = {}
            for turn, native in enumerate((True, False, False, True)):
                path = os.path.join(tmp, f"{case}_{int(native)}.gsd")
                s = write(path, n, frames, native)
                times[native].append(s)
                sizes[native] = Path(path).read_bytes()
                print(f"gsd_write_bench {case} N={n} frames={frames} turn "
                      f"{turn} {'native' if native else 'python'}: {s:.4f} s")
                os.remove(path)
            assert sizes[True] == sizes[False], "the cores' files differ"
            nat = statistics.median(times[True])
            py = statistics.median(times[False])
            out[case] = {"n": n, "frames": frames, "native_s": nat,
                         "python_s": py, "python_over_native": py / nat,
                         "bytes": len(sizes[True])}
            del sizes
    print(json.dumps({"gsd_write_bench": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
