"""Collective variables on the particle-order state (counterpart of
``metadyn_tpu/cv/base.py``; the reference plugin's ``CollectiveVariable``).

A CV is an object with ``value(state, system) -> ()`` tensor and a
``log_name`` (:class:`CollectiveVariable`, a typing ``Protocol``).  Bias forces F = −Σ_d (∂V/∂s_d) ∂s_d/∂r come from one
``torch.autograd.grad`` through the stacked values, the reference's
``jax.vjp``.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch

from ..core.state import State, System


@runtime_checkable
class CollectiveVariable(Protocol):
    """Anything with a scalar ``value(state, system)`` is a CV."""

    def value(self, state: State, system: System) -> torch.Tensor: ...

    @property
    def log_name(self) -> str: ...


def cv_values(cvs: Sequence[CollectiveVariable], state: State, system: System) -> torch.Tensor:
    """Stacked CV values s, (d,)."""
    return torch.stack([cv.value(state, system) for cv in cvs])


def cv_values_and_bias_force(cvs: Sequence, state: State, system: System,
                             dV_ds: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, F_bias) with F_bias = −Σ_d (∂V/∂s_d) ∂s_d/∂r."""
    pos = state.pos.detach().requires_grad_(True)
    with torch.enable_grad():
        s = cv_values(cvs, state.replace(pos=pos), system)
    (g,) = torch.autograd.grad(s, pos, grad_outputs=dV_ds)
    return s.detach(), -g
