"""The step driver of the particle-order integrators (counterpart of
``metadyn_tpu/integrate/base.py``; HOOMD's ``IntegratorTwoStep``).

An integrator is a factory that closes over an apply-style force function
``force_apply(state) -> state`` and returns ``step(state, generator=None,
noise=None) -> state``: the stochastic steps draw their normals from
``generator`` (a ``torch.Generator`` on the state's device), or take them
as ``noise``, as the tests do to feed both packages the same numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.state import State

StepFn = Callable[..., State]


def run_steps(step: StepFn, state: State,
              generator: Optional[torch.Generator], n_steps: int) -> State:
    """``n_steps`` steps of ``step``, drawing from ``generator``."""
    for _ in range(n_steps):
        state = step(state, generator)
    return state
