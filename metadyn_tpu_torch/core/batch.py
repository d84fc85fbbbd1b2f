"""Walker batches: the states of W walkers of one system, stacked on a
leading dimension (the port's counterpart of the reference's walker axis,
which it shards one walker per chip).

Any state dataclass stacks: the packed ``PackedState`` (``r`` (W, 3,
Npad), ``pid`` (W, Npad), ...) and the particle-order ``State`` (``pos``
(W, N, 3), ...).  Each tensor field gains the leading dimension, a dict
of tensors (``attrs``) stacks key by key and the box becomes a stacked
``Box`` (``core/box.stack_boxes``), one per walker as the reference's
stacked state keeps it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .box import Box, stack_boxes, walker_box


def batch_size(state) -> Optional[int]:
    """W of a walker batch, None for one walker's state (positions of
    three dimensions make a batch)."""
    r = state.r if hasattr(state, "r") else state.pos
    return r.shape[0] if r.dim() == 3 else None


def _stack(values: list):
    v = values[0]
    if isinstance(v, torch.Tensor):
        return torch.stack(values)
    if isinstance(v, Box):
        return stack_boxes(values)
    if isinstance(v, dict):
        return {k: _stack([x[k] for x in values]) for k in v}
    if dataclasses.is_dataclass(v):
        return stack_walkers(values)
    if any(x != v for x in values):
        raise ValueError(f"stack_walkers: walkers differ in {v!r}")
    return v


def _take(v, w: int):
    if isinstance(v, torch.Tensor):
        return v[w]
    if isinstance(v, Box):
        return walker_box(v, w)
    if isinstance(v, dict):
        return {k: _take(x, w) for k, x in v.items()}
    if dataclasses.is_dataclass(v):
        return walker(v, w)
    return v


def stack_walkers(states: Sequence):
    """W states of one kind (states or run-health carries) → one batch."""
    first = states[0]
    return dataclasses.replace(first, **{
        f.name: _stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(first) if f.init})


def walker(batch, w: int):
    """Walker ``w`` of a batch, as one walker's state (views, no copy)."""
    return dataclasses.replace(batch, **{
        f.name: _take(getattr(batch, f.name), w)
        for f in dataclasses.fields(batch) if f.init})


def walkers(batch) -> list:
    """Every walker of a batch, in order."""
    return [walker(batch, w) for w in range(batch_size(batch))]
