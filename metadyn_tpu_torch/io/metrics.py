"""Scalar metrics writers (counterpart of ``metadyn_tpu/io/metrics.py``:
the same columns and the same text).

The samplers return per-stride metric dicts already on the host (one
transfer per block of strides); these writers append them to CSV or JSONL.
Arrays become one column per element, ``name_i``; bools become 0/1.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np


def _scalarize(m: dict) -> dict:
    out = {}
    for k, v in m.items():
        a = np.asarray(v)
        if a.dtype == bool:
            a = a.astype(np.int32)  # CSV/loadtxt-friendly
        if a.ndim == 0:
            out[k] = a.item()
        else:
            for i, x in enumerate(a.reshape(-1)):
                out[f"{k}_{i}"] = x.item()
    return out


class CSVLogger:
    """Append per-stride metric rows to a CSV file; the header is the first
    row's sorted keys, kept when appending to an existing file."""

    def __init__(self, path: str, overwrite: bool = False):
        self.path = path
        self._header: list[str] | None = None
        if overwrite and os.path.exists(path):
            os.unlink(path)
        if os.path.exists(path):
            with open(path) as f:
                first = f.readline().strip()
            if first:
                self._header = first.split(",")

    def append(self, rows: Iterable[dict]) -> None:
        rows = [_scalarize(r) for r in rows]
        if not rows:
            return
        with open(self.path, "a") as f:
            if self._header is None:
                self._header = sorted(rows[0].keys())
                f.write(",".join(self._header) + "\n")
            for r in rows:
                f.write(",".join(f"{r.get(k, '')}" for k in self._header)
                        + "\n")


class JSONLLogger:
    """Append per-stride metric rows to a JSON-lines file."""

    def __init__(self, path: str, overwrite: bool = False):
        self.path = path
        if overwrite and os.path.exists(path):
            os.unlink(path)

    def append(self, rows: Iterable[dict]) -> None:
        with open(self.path, "a") as f:
            for r in rows:
                f.write(json.dumps(_scalarize(r)) + "\n")


def read_csv(path: str) -> dict[str, np.ndarray]:
    """A CSVLogger file back as one float array per column."""
    with open(path) as f:
        header = f.readline().strip().split(",")
        data = np.loadtxt(f, delimiter=",", ndmin=2)
    if data.size == 0:
        data = np.zeros((0, len(header)))
    return {k: data[:, i] for i, k in enumerate(header)}
