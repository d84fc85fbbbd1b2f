"""Order-parameter CVs on the packed state: Steinhardt Q_l and coordination
(counterpart of ``metadyn_tpu/cv/packed_order.py``).

Both CVs are sums over neighbour pairs, so their values and bias forces
come from pair sweeps over the cell structure.  On a CUDA tensor the sweeps
are the hand-written kernels of ``ops/packed_order_cuda.py``; on a CPU
tensor they are the plain roll sweeps below, which the kernels are held
against on the card:

- :func:`_half_partner_stacks`, :func:`_offset_pair_sweep` and
  :func:`_offset_force_sweep` walk the Newton-halved offset set (the self
  cell and the 13 lexicographically positive neighbour cells), each offset
  a ``torch.roll`` of the (cap, cx, cy, cz) slot view.  Distances come as
  (j_block, cap, C) broadcasts; the pairs of real slots within the CVs'
  largest cut-off are gathered from them first (:func:`_gather`), and the
  CV math runs once on those alone.  Halving is valid because every per-pair
  term is even in d (Q_l with even l: parity (−1)^l; coordination: r²
  only): cross-cell pairs get value weight 2, and the j-side force
  reaction −φ′(d_ij) = +φ′(d_ji) is rolled back onto j.
- Vacancy enters through the validity weight (``pid < n_real``), so the
  plain sweeps take both the sentinel and the validity layout, as the
  kernels do (from the coordinate sentinel or from ``pid``); partner shifts
  are tilt-aware in both (``ops.packed.shift_rows_cart``).

- ``cell_mask`` (the spatial decomposition's per-i-cell weight, 1 in a
  shard's interior and 0 on its ghost planes) weights the value sums of
  each ordered pair by its i cell: with the halved sweep a cross pair gets
  mask(c_i) + mask(c_j) in place of 2, a self-cell pair mask(c).  That is
  the values kernel's rule (one partials row per cell, times the cell's
  mask), so each shard's partial sums match the kernel's.
- ``mono=True`` runs Q_l in the homogeneous-monomial basis of
  ``cv/ylm_mono.py``, the fused kernel's monomial mode: value sums Σ
  w·mono_l(u) decoded by :meth:`PackedSteinhardtQl.mono_value_decode`, and
  per pair the force b_α·mono_{l−1}(u) projected off u.

The CVs keep the reference's flat-scalar protocol (``n_value_terms``,
``pair_value_terms_flat``, ``terms_from_flat``, ``aux_size``,
``aux_flat``/``aux_from_flat``) and its monomial protocol
(``sphere_poly``, ``mono_value_decode``, ``mono_force_vecs``), with
one-dimensional tensors where the reference has tuples of scalars, and its
``terms`` structure: (re (l+1,), im (l+1,), n_b) for Q_l, a 1-tuple for
coordination.

Not ported (it raises NotImplementedError): :func:`make_table_order_force`,
which needs the slot neighbour table.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.state import System
from ..ops.packed import (
    OFFSETS, PackedSpec, PackedState, _tables, shift_rows_cart,
)
from ..ops.packed_order_cuda import (
    is_mono, order_force_cuda, order_values_cuda,
)
from .steinhardt import _dcoeffs, _norms, _plm_over_sinm_coeffs, ql_from_sums
from .ylm_mono import build_monomials, diff_matrices, ylm_mono_matrix

KIND_QL = 0
KIND_COORD = 1


def _j_block(spec: PackedSpec) -> int:
    """j rows per block: the whole cap up to 2^26 elements per (B, cap, C)
    temporary (the rule of ``ops.packed.packed_lj_force``)."""
    cap, C = spec.cap, spec.n_cells
    if cap * cap * C > 2**26:
        return max(8, (2**26 // (cap * C)) // 8 * 8)
    return cap


def _half_partner_stacks(state: PackedState, spec: PackedSpec) -> list:
    """Rolled and shifted partner stacks of the Newton-halved offset set (the
    self cell and the 13 offsets ``o > 0``): a list of (o, xj (3, cap, C),
    vj (cap, C)), built once per step and shared by the value and force
    sweeps."""
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    valid = (state.pid < spec.n_real).to(torch.float32)
    rows4 = torch.cat([state.r, valid[None]]).reshape(4, cap, cx, cy, cz)
    shifts = shift_rows_cart(_tables(spec, state.r.device).ushift, state.box)
    out = []
    for oi, o in enumerate(OFFSETS):
        if o < (0, 0, 0):
            continue
        part = torch.roll(rows4, shifts=(-o[0], -o[1], -o[2]),
                          dims=(2, 3, 4)).reshape(4, cap, C)
        out.append((o, part[:3] + shifts[oi][:, None, :], part[3]))
    return out


def _tree_add(a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    return a + b


def _cut2(cvs) -> float:
    """The largest cut-off² of ``cvs`` (inf if one has none): the reach of
    the pairs the plain sweeps gather."""
    return max(math.inf if cv.r_cut is None else cv.r_cut ** 2 for cv in cvs)


class _Gathered(NamedTuple):
    """The ordered pairs of real slots with 1e-12 < r² < rc2 over the
    Newton-halved offset set, gathered from the (B, cap, C) distance
    broadcasts of every offset and j block before any pair math (a CV's
    pairs are a few per cent of the stencil's)."""

    blocks: list         # (o, j rows, flat indices into (B, cap, C)) each
    d: torch.Tensor      # (3, P) displacements r_i − r_j, blocks in order
    r2: torch.Tensor     # (P,)
    w: torch.Tensor      # (P,) Newton weight: 1 in the self cell, else 2


def _gather(state: PackedState, spec: PackedSpec, stacks,
            rc2: float, cell_mask=None) -> _Gathered:
    """``cell_mask`` (C,): the pair weight becomes mask(c_i) + mask(c_j)
    across cells and mask(c) in the self cell (see the module docstring)."""
    cap, C = spec.cap, spec.n_cells
    vi = (state.pid < spec.n_real).reshape(1, cap, C)
    xi = state.r.reshape(3, 1, cap, C)
    jb = _j_block(spec)
    if cell_mask is not None:
        cell_mask = torch.as_tensor(cell_mask, dtype=torch.float32,
                                    device=state.r.device)
        dest = _tables(spec, state.r.device).dest
    blocks, ds, r2s, ws = [], [], [], []
    for o, xj, vj in stacks:
        if cell_mask is not None:
            wc = cell_mask
            if o != (0, 0, 0):
                wc = wc + cell_mask[dest[OFFSETS.index(o)]]
        for j0 in range(0, cap, jb):
            rows = slice(j0, j0 + jb)
            d = xi - xj[:, rows, None, :]                   # (3, B, cap, C)
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            near = (vi & (vj[rows, None, :] > 0) & (r2 > 1e-12)
                    & (r2 < rc2))
            flat = torch.nonzero(near.reshape(-1)).squeeze(1)
            blocks.append((o, rows, flat))
            ds.append(d.reshape(3, -1)[:, flat])
            r2s.append(r2.reshape(-1)[flat])
            if cell_mask is None:
                ws.append(torch.full_like(r2s[-1],
                                          1.0 if o == (0, 0, 0) else 2.0))
            else:
                ws.append(wc[flat % C])
    return _Gathered(blocks, torch.cat(ds, dim=1), torch.cat(r2s),
                     torch.cat(ws))


def _offset_pair_sweep(state: PackedState, spec: PackedSpec, per_pair,
                       rc2: float, stacks=None, cell_mask=None):
    """Σ over pairs of ``per_pair(dx, dy, dz, r2, w)`` (a tree of sums) over
    the Newton-halved offset set with cross-cell weight 2 — valid only for
    per-pair functions even under d → −d — for the pairs within
    ``rc2``, all offsets in one call.  ``stacks``: prebuilt
    :func:`_half_partner_stacks`; ``cell_mask``: see :func:`_gather`."""
    if stacks is None:
        stacks = _half_partner_stacks(state, spec)
    pairs = _gather(state, spec, stacks, rc2, cell_mask)
    return per_pair(*pairs.d, pairs.r2, pairs.w)


def _offset_force_sweep(state: PackedState, spec: PackedSpec, pair_grad,
                        rc2: float, stacks=None) -> torch.Tensor:
    """F_i = Σ_j pair_grad(d_ij) over the Newton-halved offset set for the
    pairs within ``rc2``, with the j-side reaction rolled back from each
    cross offset's frame.  ``pair_grad(dx, dy, dz, r2)`` is the
    d-gradient of an even per-pair scalar, evaluated once on all gathered
    pairs and scattered back into each block's (3, B, cap, C) frame for
    the sums.  Returns (3, Npad)."""
    cap, C = spec.cap, spec.n_cells
    cx, cy, cz = spec.cells_per_dim
    if stacks is None:
        stacks = _half_partner_stacks(state, spec)
    pairs = _gather(state, spec, stacks, rc2)
    grads = torch.stack(pair_grad(*pairs.d, pairs.r2))      # (3, P)
    force = torch.zeros((3, cap, C), dtype=torch.float32,
                        device=state.r.device)
    react = {}
    start = 0
    for o, rows, flat in pairs.blocks:
        n_j = min(rows.stop, cap) - rows.start
        wg = torch.zeros((3, n_j * cap * C), dtype=torch.float32,
                         device=force.device)
        wg[:, flat] = grads[:, start:start + flat.numel()]
        start += flat.numel()
        wg = wg.reshape(3, n_j, cap, C)
        force = force + wg.sum(dim=1)                       # i side
        if o != (0, 0, 0):
            if o not in react:
                react[o] = torch.zeros_like(force)
            react[o][:, rows] += wg.sum(dim=2)              # j side, rolled
    for o, fj in react.items():
        force = force - torch.roll(fj.reshape(3, cap, cx, cy, cz),
                                   shifts=o, dims=(2, 3, 4)).reshape(3, cap, C)
    return force.reshape(3, -1)


def order_values_plain(state: PackedState, spec: PackedSpec, cvs,
                       stacks=None, cell_mask=None,
                       mono: bool = False) -> tuple:
    """Per-CV value ``terms`` by the plain half sweep: the plain version of
    the values kernel (and of the fused kernel's value lanes).
    ``cell_mask`` weights each ordered pair by its i cell; ``mono`` sums
    Q_l in the monomial basis and decodes the sums."""
    def per_pair(dx, dy, dz, r2, w):
        out = []
        for cv in cvs:
            if is_mono(cv, mono):
                sums = cv.pair_mono_sums(dx, dy, dz, r2, w)
                out.append(cv.mono_value_decode(sums[:-1], sums[-1]))
            else:
                out.append(cv.pair_value_terms(dx, dy, dz, r2, w))
        return tuple(out)

    return _offset_pair_sweep(state, spec, per_pair, _cut2(cvs),
                              stacks=stacks, cell_mask=cell_mask)


def order_force_plain(state: PackedState, spec: PackedSpec, cvs, auxs,
                      stacks=None, mono: bool = False) -> torch.Tensor:
    """Σ_cv bias force (3, Npad) by the plain half sweep: the plain version
    of the force kernel (and of the fused kernel's bias force); ``mono``
    runs Q_l's force in the monomial basis."""
    coefs = [cv.mono_force_vecs(aux) if is_mono(cv, mono) else aux
             for cv, aux in zip(cvs, auxs)]

    def pair_grad(dx, dy, dz, r2):
        gx = gy = gz = 0.0
        for cv, c in zip(cvs, coefs):
            if is_mono(cv, mono):
                ax, ay, az = cv.pair_mono_grad_terms(dx, dy, dz, r2, c)
            else:
                ax, ay, az = cv.pair_grad_terms(dx, dy, dz, r2, c)
            gx, gy, gz = gx + ax, gy + ay, gz + az
        return gx, gy, gz

    return _offset_force_sweep(state, spec, pair_grad, _cut2(cvs),
                               stacks=stacks)


@functools.lru_cache(maxsize=16)
def _mono_mats(l: int, device: torch.device) -> tuple:
    """(C, Dx, Dy, Dz) of ``cv/ylm_mono.py`` as f32 tensors on ``device``,
    uploaded once per (l, device)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (f32(ylm_mono_matrix(l)), *(f32(D) for D in diff_matrices(l)))


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.zeros_like(x)
    for a in coeffs[::-1]:
        p = p * x + a
    return p


class PackedSteinhardtQl(nn.Module):
    """Global Q_l over all pair bonds within ``r_cut``, counted from both
    sides (packed twin of the reference's particle-order ``SteinhardtQl``).

    The p_lm and N_m tables are rounded to f32 once, the numbers the CUDA
    kernels upload, so that the plain math and the kernels share them."""

    def __init__(self, spec: PackedSpec, r_cut: float = 1.5, l: int = 6,
                 name: str = "q6"):
        super().__init__()
        if r_cut > spec.r_list + 1e-6:
            raise ValueError("Q_l r_cut must be within the cell stencil "
                             "(r_cut + skin)")
        if l % 2:
            raise ValueError("packed Q_l uses the Newton-halved sweep (parity "
                             "(−1)^l): even l only")
        self.spec = spec
        self.r_cut = float(r_cut)
        self.l = int(l)
        self.name = name
        f32 = lambda a: [float(x) for x in np.asarray(a, np.float32)]
        self._coeffs = [f32(c) for c in _plm_over_sinm_coeffs(self.l)]
        self._dcoeffs = [f32(c) for c in _dcoeffs(self.l)]
        self._norms = f32(_norms(self.l))

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    # --- the homogeneous-monomial protocol (cv/ylm_mono.py) ----------------
    # The fused kernel's monomial mode accumulates Σ w·mono_l(u) per pair and
    # contracts three coefficient vectors for the force; these methods give
    # the basis changes, in f32 as the reference's.
    sphere_poly = True

    def mono_value_decode(self, mono_sums, nb) -> tuple:
        """(Σ w·mono_l, Σ w) → the (re, im, nb) terms structure."""
        C = _mono_mats(self.l, mono_sums.device)[0]
        s = C @ mono_sums
        return s[:self.l + 1], s[self.l + 1:], nb

    def mono_force_vecs(self, aux) -> tuple:
        """grad_aux output → (bx, by, bz), the degree-(l−1) coefficient
        vectors: per pair ∂φ/∂u_α = b_α·mono_{l−1}(u), with φ the biased
        per-pair scalar of :meth:`pair_grad_terms`."""
        gre, gim = aux
        C, Dx, Dy, Dz = _mono_mats(self.l, gre.device)
        a = torch.cat([gre.reshape(-1), gim.reshape(-1)]).to(
            torch.float32) @ C
        return Dx @ a, Dy @ a, Dz @ a

    def _unit(self, dx, dy, dz, r2) -> tuple:
        inv_r = torch.rsqrt(torch.where(r2 > 1e-12, r2, 1.0))
        return dx * inv_r, dy * inv_r, dz * inv_r, inv_r

    def pair_mono_sums(self, dx, dy, dz, r2, w) -> torch.Tensor:
        """(n_mono(l) + 1,) sums over pairs inside r_cut: Σ w·mono_l(u) and
        Σ w, the monomial mode's value lanes."""
        w = w * (r2 < self.r_cut ** 2)
        ux, uy, uz, _ = self._unit(dx, dy, dz, r2)
        ml = build_monomials(self.l, ux, uy, uz)
        return torch.stack([torch.sum(w * m) for m in ml] + [torch.sum(w)])

    def pair_mono_grad_terms(self, dx, dy, dz, r2, bvecs) -> tuple:
        """The monomial mode's per-pair bias-force contribution: with g_α =
        b_α·mono_{l−1}(u), (g − u (u·g))/r, zero outside 1e-12 < r² <
        r_cut²."""
        ux, uy, uz, inv_r = self._unit(dx, dy, dz, r2)
        ml1 = torch.stack(build_monomials(self.l - 1, ux, uy, uz))
        flat = ml1.reshape(ml1.shape[0], -1)
        gux, guy, guz = ((b @ flat).reshape(ux.shape) for b in bvecs)
        dot = ux * gux + uy * guy + uz * guz
        mi = ((r2 < self.r_cut ** 2) & (r2 > 1e-12)) * inv_r
        return ((gux - ux * dot) * mi, (guy - uy * dot) * mi,
                (guz - uz * dot) * mi)

    # --- flat-scalar protocol ----------------------------------------------
    @property
    def n_value_terms(self) -> int:
        return 2 * (self.l + 1) + 1

    @property
    def aux_size(self) -> int:
        return 2 * (self.l + 1)

    def kernel_descriptor(self) -> tuple:
        """(kind, l, rc2, r02, sc, scale, table) for the CUDA kernels: the
        table is N_m, then the p_lm and then the p_lm′ coefficients."""
        table = (self._norms + [a for c in self._coeffs for a in c]
                 + [a for c in self._dcoeffs for a in c])
        return KIND_QL, self.l, self.r_cut ** 2, 0.0, 0.0, 1.0, table

    def _chains(self, dx, dy, dz, r2, w, aux):
        """The shared P_lm / u^m recurrence: value terms with the weight
        ``w`` as given (if not None) and the bias-force gradient, zero
        outside 1e-12 < r² < r_cut² (if ``aux`` is not None)."""
        inside = (r2 < self.r_cut ** 2) & (r2 > 1e-12)
        r2s = torch.where(r2 > 1e-12, r2, 1.0)
        inv_r = torch.rsqrt(r2s)
        cth = dz * inv_r
        ux, uy = dx * inv_r, dy * inv_r
        pr, pi = torch.ones_like(cth), torch.zeros_like(cth)   # u^m
        qr, qi = torch.zeros_like(cth), torch.zeros_like(cth)  # u^(m-1)
        D = E = F = BU = 0.0
        re, im = [], []
        for m in range(self.l + 1):
            pl = _horner(self._coeffs[m], cth)
            if w is not None:
                wn = w * (self._norms[m] * pl)
                re.append(torch.sum(wn * pr))
                im.append(torch.sum(wn * pi))
            if aux is not None:
                a_re, a_im = aux[0][m], aux[1][m]
                nm = self._norms[m]
                dpl = _horner(self._dcoeffs[m], cth)
                D = D + nm * dpl * (a_re * pr + a_im * pi)
                if m > 0:
                    br = m * (a_re * qr + a_im * qi)
                    bi = m * (a_re * qi - a_im * qr)
                    E = E + nm * pl * br
                    F = F + nm * pl * bi
                    BU = BU + nm * pl * (br * ux - bi * uy)
            qr, qi = pr, pi
            pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
        flat = (tuple(re) + tuple(im) + (torch.sum(w),)
                if w is not None else None)
        grad = None
        if aux is not None:
            mi = inside * inv_r
            grad = ((D * (-cth * ux) + E - ux * BU) * mi,
                    (D * (-cth * uy) - F - uy * BU) * mi,
                    (D * (1.0 - cth * cth) - cth * BU) * mi)
        return flat, grad

    def pair_value_terms_flat(self, dx, dy, dz, r2, w) -> tuple:
        """Per-pair partial sums, flat: (Re S_0..l, Im S_0..l, n_b).  The
        weight gets the r_cut mask only (the sweeps' ``w`` already drops
        r² ≤ 1e-12)."""
        return self._chains(dx, dy, dz, r2, w * (r2 < self.r_cut ** 2),
                            None)[0]

    def terms_from_flat(self, flat) -> tuple:
        if not isinstance(flat, torch.Tensor):
            flat = torch.stack(list(flat))
        k = self.l + 1
        return flat[:k], flat[k:2 * k], flat[2 * k]

    def pair_value_terms(self, dx, dy, dz, r2, w) -> tuple:
        return self.terms_from_flat(
            self.pair_value_terms_flat(dx, dy, dz, r2, w))

    def aux_flat(self, aux) -> torch.Tensor:
        return torch.cat([aux[0].reshape(-1), aux[1].reshape(-1)])

    def aux_from_flat(self, flat) -> tuple:
        k = self.l + 1
        return flat[:k], flat[k:2 * k]

    def finalize_value(self, terms) -> torch.Tensor:
        re, im, nb = terms
        return ql_from_sums(re, im, nb, self.l)

    def _sums(self, state: PackedState) -> tuple:
        return order_values_cuda(state, self.spec, [self])[0]

    def value(self, state: PackedState, system: System) -> torch.Tensor:
        return self.finalize_value(self._sums(state))

    def grad_aux(self, terms, dVds) -> tuple:
        """Outer gradient g_m = ∂Q/∂S_m in closed form, with the bias-force
        coefficient −2·dVds folded in (both pair orderings hit the i side:
        even parity).  Q = sqrt(A q2)/n_b with A = 4π/(2l+1) and q2 = re_0² +
        im_0² + 2 Σ_{m≥1}(re_m² + im_m²), so ∂Q/∂re_m = A c_m re_m /
        (n_b sqrt(A q2)) with c_0 = 1, c_m = 2."""
        re, im, nb = terms
        A = 4.0 * math.pi / (2 * self.l + 1)
        q2 = (re[0] ** 2 + im[0] ** 2) + 2.0 * torch.sum(re[1:] ** 2
                                                         + im[1:] ** 2)
        c = A / (torch.sqrt(A * q2) * torch.clamp(nb, min=1.0))
        mult = torch.full_like(re, 2.0)
        mult[0] = 1.0
        k = -2.0 * dVds * c * mult
        return k * re, k * im

    def pair_grad_terms(self, dx, dy, dz, r2, aux) -> tuple:
        """Closed-form per-pair bias-force contribution: the d-gradient of
        φ(d) = Σ_m N_m p_m(cosθ)·Re[(g^re_m − i g^im_m)·u^m] (u = (dx+i dy)/r),
        zero outside 1e-12 < r² < r_cut²; both orderings give particle i
        +∂φ/∂d (even parity), so no j-side scatter is needed."""
        return self._chains(dx, dy, dz, r2, None, aux)[1]

    def pair_value_and_grad(self, dx, dy, dz, r2, wv, aux) -> tuple:
        """Value terms and bias-force gradient from one shared recurrence
        (the fused kernel's math).  ``wv`` gets the mask 1e-12 < r² <
        r_cut².  Returns (flat terms, gx, gy, gz)."""
        inside = (r2 < self.r_cut ** 2) & (r2 > 1e-12)
        flat, (gx, gy, gz) = self._chains(dx, dy, dz, r2, wv * inside, aux)
        return flat, gx, gy, gz

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: torch.Tensor, f_acc: torch.Tensor
                         ) -> torch.Tensor:
        """f_acc + the bias force: one value sweep, the outer gradient, one
        force sweep."""
        aux = self.grad_aux(self._sums(state), dVds)
        return f_acc + order_force_cuda(state, self.spec, [self], [aux])


class PackedCoordination(nn.Module):
    """Smooth mean coordination number (PLUMED COORDINATION switching):

        s = (1/N) Σ_pairs [1 − (r/r0)^6] / [1 − (r/r0)^12] = (1/N) Σ 1/(1 + (r/r0)^6)

    ``r_cut=None`` truncates at the cell stencil's reach.  A finite
    ``r_cut`` applies the PLUMED stretch s̃ = (s − s(r_cut)) / (1 −
    s(r_cut)) below r_cut and 0 beyond."""

    n_value_terms = 1
    aux_size = 1

    def __init__(self, spec: PackedSpec, r0: float = 1.5, name: str = "coord",
                 r_cut: float | None = None):
        super().__init__()
        # the switching tail is negligible past ~1.5·r0: require coverage
        if r0 * 1.5 > spec.r_list + 1e-6:
            raise ValueError("coordination r0 too large for the cell stencil")
        self.spec = spec
        self.r0 = float(r0)
        self.name = name
        self.r_cut = None if r_cut is None else float(r_cut)

    @property
    def log_name(self) -> str:
        return f"cv_{self.name}"

    def _stretch(self) -> tuple:
        """(s_c, scale): the switching value at the cut-off and 1/(1 − s_c)."""
        sc = 1.0 / (1.0 + (self.r_cut / self.r0) ** 6)
        return sc, 1.0 / (1.0 - sc)

    def kernel_descriptor(self) -> tuple:
        """(kind, l, rc2, r02, sc, scale, table) for the CUDA kernels; no
        cut-off is rc2 = inf with the identity stretch."""
        if self.r_cut is None:
            rc2, sc, scale = math.inf, 0.0, 1.0
        else:
            (sc, scale), rc2 = self._stretch(), self.r_cut ** 2
        return KIND_COORD, 0, rc2, self.r0 ** 2, sc, scale, []

    def pair_value_terms_flat(self, dx, dy, dz, r2, w) -> tuple:
        return self.pair_value_terms(dx, dy, dz, r2, w)

    def terms_from_flat(self, flat) -> tuple:
        return (flat[0],)

    def aux_flat(self, aux) -> torch.Tensor:
        return aux.reshape(1)

    def aux_from_flat(self, flat):
        return flat[0]

    def pair_value_terms(self, dx, dy, dz, r2, w) -> tuple:
        # 1/(1 + (r/r0)^6): the regular form of the switching quotient
        y3 = (r2 / self.r0 ** 2) ** 3
        s = 1.0 / (1.0 + y3)
        if self.r_cut is not None:
            sc, scale = self._stretch()
            s = torch.where(r2 < self.r_cut ** 2, (s - sc) * scale, 0.0)
        return (torch.sum(w * s),)

    def finalize_value(self, terms) -> torch.Tensor:
        return terms[0] / self.spec.n_real

    def value(self, state: PackedState, system: System) -> torch.Tensor:
        return self.finalize_value(
            order_values_cuda(state, self.spec, [self])[0])

    def grad_aux(self, terms, dVds) -> torch.Tensor:
        """Bias-force coefficient −dVds·2/N (the two pair orderings, even
        parity), folded into the per-pair coefficient."""
        return -dVds * 2.0 / self.spec.n_real

    def pair_grad_terms(self, dx, dy, dz, r2, aux) -> tuple:
        """φ(d) = 1/(1 + t³) with t = r²/r0²: ∂φ/∂d = −3t²/(r0²(1 + t³)²)·2d,
        times the stretch factor below r_cut and 0 beyond."""
        r02 = self.r0 ** 2
        t = r2 / r02
        t3 = t * t * t
        dphi_dr2 = -3.0 * t * t / (r02 * (1.0 + t3) ** 2)
        if self.r_cut is not None:
            _, scale = self._stretch()
            dphi_dr2 = torch.where(r2 < self.r_cut ** 2, dphi_dr2 * scale, 0.0)
        c = aux * 2.0 * dphi_dr2
        return c * dx, c * dy, c * dz

    def accum_bias_force(self, state: PackedState, system: System,
                         dVds: torch.Tensor, f_acc: torch.Tensor
                         ) -> torch.Tensor:
        aux = self.grad_aux(None, dVds)
        return f_acc + order_force_cuda(state, self.spec, [self], [aux])


def make_fused_order_force(cvs, spec: PackedSpec):
    """One value traversal and one force traversal for all order CVs.

    Returns ``(values_fn, force_fn)``:
      values_fn(state) -> (s_stack, ctx)
      force_fn(state, ctx, dVds) -> (3, Npad) bias force g
    with ``ctx = (terms, stacks)`` as in the reference.  On a CUDA state
    both go to the kernels and ``stacks`` is None (the kernels index the
    neighbour cells directly); on a CPU state both run the plain sweeps,
    which share the partner stacks built once by ``values_fn``."""
    cvs = list(cvs)

    def values_fn(state):
        stacks = (_half_partner_stacks(state, spec)
                  if state.r.device.type == "cpu" else None)
        terms = order_values_cuda(state, spec, cvs, stacks=stacks)
        s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        return s, (terms, stacks)

    def force_fn(state, ctx, dVds):
        terms, stacks = ctx
        auxs = [cv.grad_aux(t, dVds[i])
                for i, (cv, t) in enumerate(zip(cvs, terms))]
        return order_force_cuda(state, spec, cvs, auxs, stacks=stacks)

    return values_fn, force_fn


def make_table_order_force(cvs, spec: PackedSpec):
    """The neighbour-table twin of :func:`make_fused_order_force`: not
    ported (the slot neighbour table ``nbr_table`` is not)."""
    raise NotImplementedError("the neighbour-table order-CV path is not "
                              "ported (nbr_table is not)")
