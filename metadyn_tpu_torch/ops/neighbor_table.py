"""The slot neighbour table of the order CVs (counterpart of
``metadyn_tpu/ops/neighbor_table.py``).

Built once per repack, the (K, Npad) table lists every slot's neighbours
within ``r_nb``, so the order CVs' per-step sweeps gather only real pairs
(``cv/packed_order.make_table_order_force``) where the cell sweeps visit
every (cap, cap) pair of a cell and its 27 neighbour cells and mask.  The
reference builds and reads it with XLA gathers and scatters, not with a
Pallas kernel, and so does this module with PyTorch's on every device: it
is a path the user selects (``PackedEngine(nbr_table=(r_nb, K))``), beside
the order kernels, not a fallback for them.

Freshness: with ``r_nb ≥`` the largest CV cut-off + ``spec.skin``, the
table stays complete between the half-skin repacks (pair distances drift
by at most the skin before the trigger fires), and slot indices hold
because slots move only at a repack.  Completeness also needs ``r_nb ≤``
the smallest cell width (the 27-cell stencil), which the engine checks.
"""
from __future__ import annotations

import torch

from ..ops.packed import OFFSETS, PackedSpec, PackedState, _tables


def build_slot_neighbor_table(state: PackedState, spec: PackedSpec,
                              r_nb: float, K: int) -> tuple:
    """The full neighbour table of the packed slot layout.

    Returns ``(tbl, overflow)``: ``tbl`` (K, Npad) i32 of global flat slot
    indices (each unordered pair listed from both sides), ``Npad`` the
    vacant entry; ``overflow`` a device bool, True iff a slot has more than
    K neighbours within ``r_nb`` (the table is then incomplete).

    The order is the reference's (offset-major, then the source slot's
    rank), so the table equals the reference's entry for entry and sums
    over it repeat bit for bit.  Orthorhombic boxes (the minimum image of
    the table's readers is per axis)."""
    cap, C, npad = spec.cap, spec.n_cells, spec.n_pad
    dev = state.r.device
    tab = _tables(spec, dev)
    r = state.r.reshape(3, cap, C)
    valid = (state.pid < spec.n_real).reshape(cap, C)
    L = state.box.L
    r2cut = torch.tensor(r_nb * r_nb, dtype=torch.float32, device=dev)
    lanes = torch.arange(cap, dtype=torch.int32, device=dev)
    cells = torch.arange(C, dtype=torch.int32, device=dev)
    islot = lanes[:, None] * C + cells[None, :]                  # (capi, C)
    not_self = (lanes[:, None] != lanes[None, :])[:, :, None]
    tbl = torch.full((K * npad + 1,), npad, dtype=torch.int32, device=dev)
    base = torch.zeros((cap, C), dtype=torch.int32, device=dev)
    for oi, o in enumerate(OFFSETS):
        nc = tab.dest[oi]                                       # (C,) c + o
        r2 = torch.zeros((cap, cap, C), dtype=torch.float32, device=dev)
        for d in range(3):
            xj = r[d][:, nc] + tab.ushift[oi, d][None, :] * L[d]
            c = r[d][None, :, :] - xj[:, None, :]              # (capj, capi, C)
            r2 = r2 + c * c
        m = valid[None, :, :] & valid[:, nc][:, None, :] & (r2 < r2cut)
        if o == (0, 0, 0):
            # self by slot identity, not by distance: two real particles
            # may coincide transiently
            m = m & not_self
        jslot = lanes[:, None] * C + nc[None, :].to(torch.int32)  # (capj, C)
        m_i = m.to(torch.int32)
        rank = base[None] + torch.cumsum(m_i, dim=0, dtype=torch.int32) - m_i
        ok = m & (rank < K)
        dest = torch.where(ok, rank * npad + islot[None], K * npad)
        tbl[dest.reshape(-1).long()] = jslot[:, None, :].expand(
            cap, cap, C).reshape(-1)
        base = base + m_i.sum(dim=0, dtype=torch.int32)
    overflow = torch.any(base > K)
    return tbl[:-1].reshape(K, npad), overflow
