#!/usr/bin/env python3
"""The double-well FES oracle on the port, the protocol of the JAX
package's tests/test_sampler.py:28-88.

One particle in U(x) = 2(x² − 1)² + 5(y² + z²) (``ForceField(external=)``,
its force by autograd), CV = x (``AxisPosition``), BAOAB Langevin at kT 0.6
(γ 5, dt 0.005), well-tempered metadynamics (W 0.15, ΔT 6, stride 50) on a
161-point grid over [−1.6, 1.6]; ``MetadSampler`` drives the bound force
field through its callable-engine adapter.  After a transient the
well-tempered estimate −(kT + ΔT)/ΔT·V is averaged over segments and held
against U on |x| ≤ 1.2, up to a constant.

    python3 scripts/fes_oracle.py --protocol fast --device cpu
    JAX_PLATFORMS=cpu python3 scripts/fes_oracle.py --protocol full \
        --package jax --seed 1
    python3 scripts/fes_oracle.py --protocol full --device cuda \\
        --state chiprun_out/fes_full.npz --leg-seconds 3000

``fast`` is 200k steps, then 4 segments of 50k (bound 0.5 kT); ``full``
400k, then 16 of 100k (bound 0.1 kT, the north star's).  With ``--state``
the run goes in legs: each leg runs at least one segment and stops at
the first segment boundary past ``--leg-seconds``, saves the sampler's
carry (the generator's state in it, ``io/checkpoint.py``), the summed
estimate, the segments done and the seconds spent, and the next call with the same ``--state`` goes on from
there, bit for bit as one straight run.  The last leg prints the error in
kT, the seconds of all legs and the device (with nvidia-smi's name and
power limit on a card) as one JSON line, and exits 1 when the error is
over the bound.  ``--seed`` sets the sampler's seed (the Langevin noise),
and ``--package jax`` runs the JAX package's own sampler with the same
protocol, so both packages' errors can be set side by side over seeds.
tests/test_torch_fes_oracle.py runs both protocols through
:func:`run_protocol`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from metadyn_tpu_torch.bias.grid import GridSpec  # noqa: E402
from metadyn_tpu_torch.bias.metad import WELL_TEMPERED, HillSpec  # noqa: E402
from metadyn_tpu_torch.core.box import Box  # noqa: E402
from metadyn_tpu_torch.core.forcefield import ForceField  # noqa: E402
from metadyn_tpu_torch.core.state import make_state, make_system  # noqa: E402
from metadyn_tpu_torch.cv.simple import AxisPosition  # noqa: E402
from metadyn_tpu_torch.integrate.langevin import make_langevin_step  # noqa: E402
from metadyn_tpu_torch.io.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint,
)
from metadyn_tpu_torch.sampler import MetadSampler  # noqa: E402

A_WELL = 2.0  # barrier height at x = 0 against the minima at ±1
KT = 0.6
# name -> (transient steps, segments, steps per segment, bound in kT)
PROTOCOLS = {"fast": (200_000, 4, 50_000, 0.5),
             "full": (400_000, 16, 100_000, 0.1)}


def double_well_sampler(device, kT=KT, W=0.15, deltaT=6.0, stride=50,
                        seed=0) -> MetadSampler:
    def dw(pos, state, system):
        x = pos[0, 0]
        return (A_WELL * (x * x - 1.0) ** 2
                + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2))

    box = Box.cubic(50.0, device)  # x stays far from the boundary
    system = make_system(1, device)
    ff = ForceField(external=dw, device=device)
    state = make_state(np.asarray([[1.0, 0.0, 0.0]], np.float32), box,
                       device=device)
    return MetadSampler(
        system, state, ff.bind(system), cvs=[AxisPosition(0, 0, name="x")],
        grid_spec=GridSpec.create([-1.6], [1.6], [161], [0.1], device),
        hills=HillSpec.create(W=W, stride=stride, mode=WELL_TEMPERED,
                              deltaT=deltaT),
        integrator_factory=lambda f: make_langevin_step(
            f, system, dt=0.005, kT=kT, gamma=5.0),
        seed=seed)


def jax_double_well_sampler(seed=0, kT=KT, W=0.15, deltaT=6.0, stride=50):
    """The JAX package's sampler of tests/test_sampler.py, at ``seed``."""
    from metadyn_tpu.bias.grid import GridSpec as JGridSpec
    from metadyn_tpu.bias.metad import HillSpec as JHillSpec
    from metadyn_tpu.core.box import Box as JBox
    from metadyn_tpu.core.forcefield import ForceField as JForceField
    from metadyn_tpu.core.state import make_state as jmake_state
    from metadyn_tpu.core.state import make_system as jmake_system
    from metadyn_tpu.cv.simple import AxisPosition as JAxisPosition
    from metadyn_tpu.integrate.langevin import make_langevin_step as jstep
    from metadyn_tpu.sampler import MetadSampler as JMetadSampler

    def dw(pos, state, system):
        x = pos[0, 0]
        return (A_WELL * (x * x - 1.0) ** 2
                + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2))

    system = jmake_system(1)
    return JMetadSampler(
        system, jmake_state(np.asarray([[1.0, 0.0, 0.0]], np.float32),
                            JBox.cubic(50.0)),
        JForceField(external=dw).bind(system),
        cvs=[JAxisPosition(0, 0, name="x")],
        grid_spec=JGridSpec.create([-1.6], [1.6], [161], [0.1]),
        hills=JHillSpec.create(W=W, stride=stride, mode=WELL_TEMPERED,
                               deltaT=deltaT),
        integrator_factory=lambda f: jstep(f, system, dt=0.005, kT=kT,
                                           gamma=5.0),
        seed=seed)


def run_protocol(device, transient: int, n_seg: int, seg: int,
                 state_path: str | None = None,
                 leg_seconds: float | None = None, seed: int = 0,
                 package: str = "torch"):
    """Run the protocol (in legs with ``state_path``).  Returns (max|F −
    U| on |x| ≤ 1.2, seconds of all legs), or None when this leg stopped
    before the end.  The transient runs in pieces of ``seg`` steps, which
    changes nothing: the sampler's loop is the same step by step.
    ``package="jax"`` runs the JAX package's sampler (its default
    platform; no legs)."""
    if transient % seg:
        raise ValueError("the transient must be a multiple of the segment")
    if package == "jax" and state_path:
        raise ValueError("legs (state_path) are the port's only")
    s = (jax_double_well_sampler(seed) if package == "jax"
         else double_well_sampler(device, seed=seed))
    x = s.grid_coords(0)
    n_chunks = transient // seg + n_seg
    done, F_acc, spent = 0, np.zeros_like(x), 0.0
    if state_path and os.path.exists(state_path):
        s.carry, extra = load_checkpoint(state_path, s.carry)
        done, spent = int(extra["done"]), float(extra["seconds"])
        F_acc = np.asarray(extra["F_acc"], F_acc.dtype)
    t0 = time.perf_counter()
    while done < n_chunks:
        s.run(seg)
        done += 1
        if done > transient // seg:
            F_acc = F_acc + s.free_energy(kT=KT)
        if (done < n_chunks and leg_seconds is not None and state_path
                and time.perf_counter() - t0 > leg_seconds):
            save_checkpoint(state_path, s.carry, extra={
                "done": done, "F_acc": F_acc,
                "seconds": spent + time.perf_counter() - t0})
            return None
    F_true = A_WELL * (x ** 2 - 1.0) ** 2
    err = (F_acc / n_seg - F_true)[np.abs(x) <= 1.2]
    err -= err.mean()  # the FES is defined up to a constant
    return float(np.max(np.abs(err))), spent + time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--protocol", choices=sorted(PROTOCOLS), default="fast")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0,
                   help="the sampler's seed (the Langevin noise)")
    p.add_argument("--package", choices=("torch", "jax"), default="torch",
                   help="jax: the JAX package's sampler on its default "
                        "platform (JAX_PLATFORMS=cpu for the CPU)")
    p.add_argument("--state", help="npz carrying the run between legs")
    p.add_argument("--leg-seconds", type=float,
                   help="stop this leg at the first segment boundary past "
                        "this many seconds (needs --state)")
    args = p.parse_args()
    transient, n_seg, seg, bound_kT = PROTOCOLS[args.protocol]
    if args.package == "jax":
        import jax
        where = f"jax {jax.devices()[0].platform}"
    elif args.device.startswith("cuda"):
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        torch.set_num_threads(2)
        where = "cpu"
    out = run_protocol(args.device, transient, n_seg, seg, args.state,
                       args.leg_seconds, seed=args.seed,
                       package=args.package)
    if out is None:
        print(f"leg ended, state in {args.state}: run again to go on")
        return 0
    err, secs = out
    print(json.dumps({"protocol": args.protocol, "package": args.package,
                      "device": where, "seed": args.seed,
                      "err": err, "err_kT": err / KT, "bound_kT": bound_kT,
                      "seconds": secs, "steps": transient + n_seg * seg}))
    return 0 if err < bound_kT * KT else 1


if __name__ == "__main__":
    sys.exit(main())
