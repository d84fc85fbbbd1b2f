"""Box aspect-ratio CV: box-shape metadynamics under NPT (counterpart of
``metadyn_tpu/cv/aspect_ratio.py``; the reference plugin's
``AspectRatio``).

s = L_a / L_b reads the box alone, so its bias acts on the box degrees of
freedom, not on the particles: the SCR barostat (``integrate/npt.py``,
``integrate/packed.py``) takes ∂V/∂L through ``box_bias_fn``, which
:func:`box_bias_fn_for` builds from the sampler's live bias grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bias.grid import value_and_grad


@dataclass(frozen=True)
class AspectRatio:
    """s = L[axis_a] / L[axis_b], on one state or a walker batch (each
    walker's own box)."""

    axis_a: int = 0
    axis_b: int = 1
    name: str = "aspect"

    walker_batch = True

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def value(self, state, system) -> torch.Tensor:
        L = state.box.L
        return L[..., self.axis_a] / L[..., self.axis_b]

    def accum_bias_force(self, state, system, dVds: torch.Tensor,
                         f_acc: torch.Tensor) -> torch.Tensor:
        """No force on the particles (∂s/∂r = 0): the bias acts on the box
        through ``box_bias_fn``."""
        return f_acc

    def dvalue_dL(self, state) -> torch.Tensor:
        """(…, 3) ∂s/∂L."""
        L = state.box.L
        La, Lb = L[..., self.axis_a], L[..., self.axis_b]
        g = torch.zeros_like(L)
        g[..., self.axis_a] = 1.0 / Lb
        g[..., self.axis_b] = -La / (Lb * Lb)
        return g


def box_bias_fn_for(cv: AspectRatio, bias):
    """``box_bias_fn(state) -> ∂V_bias/∂L`` for the NPT step, at the
    current box, against ``bias`` (the live ``BiasState`` of the stride:
    give the sampler a two-argument ``integrator_factory(force_fn,
    bias)`` and build the step with ``box_bias_fn=box_bias_fn_for(cv,
    bias)``)."""

    def fn(state) -> torch.Tensor:
        s = cv.value(state, None)[..., None]
        _, dVds = value_and_grad(bias.grid, s)
        return dVds[..., 0, None] * cv.dvalue_dL(state)

    return fn
