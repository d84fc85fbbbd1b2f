"""Particle-to-mesh assignment stencils (counterpart of the part of
``metadyn_tpu/cv/mesh.py`` that the packed mesh CV uses).  The
particle-order ``MeshOrderParameter`` waits for the particle-order engines.
"""
from __future__ import annotations

import torch


def axis_stencil(f: torch.Tensor, order: int):
    """Per-axis assignment stencil at mesh coordinate ``f`` (grid node g
    sits at f = g + 0.5): ``(base_node, [(offset, weight), ...])`` with
    ``base_node`` an int64 tensor.

    Order 2 is CIC (trilinear), order 3 TSC (the quadratic B-spline).  The
    weights are polynomials of the fractional offset, so they are
    differentiable in ``f``."""
    if order == 2:
        base = torch.floor(f - 0.5)
        t = f - 0.5 - base                      # weight toward the +1 node
        return base.to(torch.int64), [(0, 1.0 - t), (1, t)]
    if order == 3:
        base = torch.floor(f)                   # nearest node, |d| ≤ 1/2
        d = f - 0.5 - base
        return base.to(torch.int64), [
            (-1, 0.5 * (0.5 - d) ** 2),
            (0, 0.75 - d * d),
            (1, 0.5 * (0.5 + d) ** 2)]
    raise ValueError(f"assign order {order} unsupported (2=CIC, 3=TSC)")
