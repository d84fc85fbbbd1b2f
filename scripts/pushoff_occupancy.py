#!/usr/bin/env python3
"""Cell occupancy after a melt YAML's push-off, through one package's CLI.

    python3 scripts/pushoff_occupancy.py --package jax   --seeds 0 1 2 3
    python3 scripts/pushoff_occupancy.py --package torch --seeds 0 1 2 3 \
        [--device cuda]

For each seed the YAML (default ``examples/config5_flux.yaml``) is built by
that package's ``cli.build_sampler`` with ``system.init.seed`` set to the
seed (so both the random-walk start and the push-off's random stream,
``init.seed + 99``, follow it), no outputs, and ``engine.cap`` raised to
``--cap`` so that the pack succeeds and the occupancy can be read.  The
occupancy of every production cell is counted from the packed state's
``slot_of`` (slot = rank * n_cells + cell, the layout of both packages'
host pack).  One line per seed, then one JSON line: the
largest cell of each seed, and the mean and variance of the occupancy over
all cells of all seeds.  Run once per package; each run imports only its
own package (``jax`` reads the YAML with PyYAML, ``torch`` with the port's
reader).  The JAX package runs on its default platform
(``JAX_PLATFORMS=cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def build(package: str, cfg: dict, device: str):
    if package == "jax":
        from metadyn_tpu.cli import build_sampler
        sampler, _ = build_sampler(cfg)
        st = sampler.carry.state
        return np.asarray(st.slot_of), int(st.pid.shape[0])
    from metadyn_tpu_torch.cli import build_sampler
    sampler, _ = build_sampler(cfg, device=device)
    st = sampler.carry.state
    return st.slot_of.cpu().numpy(), int(st.pid.shape[0])


def load(package: str, path: Path) -> dict:
    if package == "jax":
        import yaml
        with open(path) as f:
            return yaml.safe_load(f)
    from metadyn_tpu_torch.io.config import load_config
    return load_config(str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--yaml", default=str(ROOT / "examples/config5_flux.yaml"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--cap", type=int, default=64)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (torch only)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    largest, occs = [], []
    for seed in args.seeds:
        cfg = load(args.package, Path(args.yaml))
        cfg["system"]["init"]["seed"] = seed
        cfg["engine"]["cap"] = args.cap
        cfg["output"] = {}
        t0 = time.perf_counter()
        slot_of, n_pad = build(args.package, cfg, args.device)
        n_cells = n_pad // args.cap
        occ = np.bincount(slot_of % n_cells, minlength=n_cells)
        largest.append(int(occ.max()))
        occs.append(occ)
        print(f"{args.package} seed {seed}: largest cell {occ.max()} of "
              f"{n_cells} cells, mean {occ.mean():.3f}, variance "
              f"{occ.var():.3f}, top {sorted(occ.tolist())[-5:]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    allocc = np.concatenate(occs)
    print(json.dumps({"package": args.package, "yaml": Path(args.yaml).name,
                      "seeds": args.seeds, "largest": largest,
                      "mean": float(allocc.mean()),
                      "variance": float(allocc.var()),
                      "cells": int(allocc.size)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
