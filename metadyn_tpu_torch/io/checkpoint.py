"""Atomic checkpoint of a sampler's carry, for bit-for-bit resume within the
port.

The port's own format, not the reference's pytree flattening (the random
streams differ, so a JAX checkpoint could not resume the same trajectory
here): one npz, written temp + rename, holding every tensor of the carry
(the state with its attrs and box, the bias, the aux flags, the lagged
path's ``ctx``), the ``torch.Generator`` state, the host counters, and an
``extra`` dict.  The carry is walked field by field (dataclasses, named
tuples, tuples, lists, dicts by key); the walk's paths and leaf kinds are stored
as the structure, and loading into a carry of another structure raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .grid_file import atomic_savez


def _leaves(obj: Any, path: str, out: list) -> None:
    """(path, kind, value) of every leaf under ``obj``, in walk order."""
    if isinstance(obj, torch.Tensor):
        out.append((path, "tensor", obj))
    elif isinstance(obj, torch.Generator):
        out.append((path, "generator", obj))
    elif obj is None or isinstance(obj, (bool, int, float, str,
                                         np.generic)):
        out.append((path, type(obj).__name__, obj))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.init:
                _leaves(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for name in obj._fields:
            _leaves(getattr(obj, name), f"{path}.{name}", out)
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            _leaves(x, f"{path}.{i}", out)
    elif isinstance(obj, dict):
        # key order, not insertion order: a repack may rebuild a dict
        for k in sorted(obj):
            _leaves(obj[k], f"{path}.{k}", out)
    else:
        raise TypeError(f"checkpoint: cannot store {type(obj).__name__} "
                        f"at {path}")


def _structure(leaves: list) -> str:
    return ";".join(f"{p}:{k}" for p, k, _ in leaves)


def save_checkpoint(path: str, carry: Any, extra: dict | None = None) -> None:
    """Atomically persist ``carry`` and the ``extra`` values."""
    leaves: list = []
    _leaves(carry, "carry", leaves)
    payload = {"structure": np.asarray(_structure(leaves))}
    for i, (_, kind, v) in enumerate(leaves):
        if kind == "tensor":
            v = v.detach().cpu().numpy()
        elif kind == "generator":
            v = v.get_state().numpy()
        elif kind == "NoneType":
            continue
        payload[f"leaf{i}"] = np.asarray(v)
    for k, v in (extra or {}).items():
        payload[f"extra__{k}"] = np.asarray(v)
    atomic_savez(path, payload)


def _rebuild(tmpl: Any, it) -> Any:
    """``tmpl`` with its leaves taken, in walk order, from ``it``."""
    if isinstance(tmpl, (torch.Tensor, torch.Generator)) or tmpl is None \
            or isinstance(tmpl, (bool, int, float, str, np.generic)):
        return next(it)
    if dataclasses.is_dataclass(tmpl):
        return dataclasses.replace(tmpl, **{
            f.name: _rebuild(getattr(tmpl, f.name), it)
            for f in dataclasses.fields(tmpl) if f.init})
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        return type(tmpl)(*(_rebuild(getattr(tmpl, n), it)
                            for n in tmpl._fields))
    if isinstance(tmpl, (tuple, list)):
        return type(tmpl)(_rebuild(x, it) for x in tmpl)
    return {k: _rebuild(tmpl[k], it) for k in sorted(tmpl)}


def load_checkpoint(path: str, template: Any) -> tuple:
    """Restore a carry with the structure of ``template`` (tensors go to the
    template's devices and dtypes).  Returns (carry, extras)."""
    leaves: list = []
    _leaves(template, "carry", leaves)
    with np.load(path, allow_pickle=False) as z:
        saved = str(z["structure"])
        if saved != _structure(leaves):
            raise ValueError(f"{path}: checkpoint structure does not match "
                             "this sampler's carry")
        values = []
        for i, (_, kind, t) in enumerate(leaves):
            if kind == "NoneType":
                values.append(None)
                continue
            a = z[f"leaf{i}"]
            if kind == "tensor":
                values.append(torch.as_tensor(a).to(device=t.device,
                                                     dtype=t.dtype))
            elif kind == "generator":
                g = torch.Generator(device=t.device)
                g.set_state(torch.as_tensor(a))
                values.append(g)
            else:
                values.append(type(t)(a.item() if a.ndim == 0 else a))
        extras = {k[len("extra__"):]: z[k] for k in z.files
                  if k.startswith("extra__")}
    return _rebuild(template, iter(values)), extras
