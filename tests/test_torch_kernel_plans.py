"""The plans of the two kernels redesigned for Hopper, mirrored in numpy
float32 on the CPU and held against the JAX package.

- Kernel 1 past four bond slots (``csrc/packed_lj_force.cu``, the template
  flag ``More``): a block stages its 27 neighbour cells' real rows in
  (column, z offset, rank) order, shifted across the box faces; each i row
  loads its partner pids once, sets bit q of its warp's bitmask for every
  staged row q whose pid is one of them, and the sweep classifies a
  candidate by one bit (bonded at any distance) and by r² against r_cut
  (with the ε > 0 gate).  :func:`bitmask_mirror` runs that plan on a
  6-arm and a 10-arm star melt (the slots past eight come from the
  wrapper's stacked array) against ``metadyn_tpu.ops.packed.
  packed_lj_force`` (forces 1e-5·max|f| + 1e-5, PE rtol 1e-5); the
  wrapper's ``bond_cols`` hands the kernel the first eight columns by
  pointer and stacks the rest.
- Kernel 4's wide layout in the recurrence (``csrc/order_cv.cuh``
  ``wide_sweep``, ``ql_round``), which kernels 2 and 3 share: the hits of
  a warp's rows queued 32 at a time through the LJ and coordination math,
  the pairs inside the largest Q_l cut-off moved to a queue of their own
  that runs 32 at a time across rows; per Q_l a compile-time degree for
  the even l up to 12 (its value terms through the warp's tile, rows
  summed in column order) and the header's l otherwise (each term summed
  by a shuffle tree); each round's bias force summed per row.
  :func:`wide_mirror` runs it on an fcc crystal with noise for [Q8, Q10,
  Q12] (the lanes of the reference's ``_lane_layout``) and [Q14, Q16,
  coordination] (the shuffle path and the coordination round), against
  the reference's XLA sweeps (values rtol 2e-5 of the largest lane,
  2e-4 past l = 12 where the f32 p_lm tables round apart; bias force
  2e-3·|g| + 2e-4·max|g|, the kernels' gates).

Inputs from numpy seeds; torch pinned to 2 threads.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.ops.packed_fused_pallas import _lane_layout

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops import packed_cuda as pc
from metadyn_tpu_torch.ops import packed_order_cuda as poc

from tests.test_torch_bond_kernels import star_melt

WARPS = 8   # csrc: 256 threads a block
LANES = 32
# csrc/order_cv.cuh ql_round: the l whose terms go through the warp's tile
TILED_L = (2, 4, 6, 8, 10, 12)
F32 = np.float32


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def staged_rows(spec, L, r, keep, cell):
    """The staged rows of ``cell`` (cell_stage.cuh stage_neighbours): slot
    and shifted position of every kept row of the 27 neighbour cells, in
    offset order o = 3 c + dz (column c = (ox, oy), z offset dz) and rank
    order within; and the staged indices of the own cell's rows.  L: the
    box's edges (3,) f32 (an orthorhombic box)."""
    cx, cy, cz = spec.cells_per_dim
    C, cap = spec.n_cells, spec.cap
    ix, iy, iz = cell // (cy * cz), cell // cz % cy, cell % cz
    slots, pos, own = [], [], []
    for c in range(9):
        for dz in range(3):
            o3 = (c // 3 - 1, c % 3 - 1, dz - 1)
            j, u = [], []
            for i_, o_, n_ in zip((ix, iy, iz), o3, (cx, cy, cz)):
                j.append((i_ + o_) % n_)
                u.append((i_ + o_) // n_)   # -1, 0 or 1
            jcell = (j[0] * cy + j[1]) * cz + j[2]
            shift = (L * np.asarray(u, F32)).astype(F32)
            for k in range(cap):
                s = k * C + jcell
                if keep[s]:
                    if 3 * c + dz == 13:
                        own.append(len(slots))
                    slots.append(s)
                    pos.append(r[:, s] + shift)
    return np.asarray(slots, int), np.asarray(pos, F32).reshape(-1, 3), own


def box_edges(st):
    return np.asarray(st.box.L.cpu().numpy(), F32).reshape(3)


def bond_mask(partners, pid1):
    """A warp's bitmask over the staged rows (as bools): staged row q is
    bonded when its pid + 1 is one of the row's partner pids + 1 (0 =
    none), built 32 rows a word against the partners (lane k holds slot
    k, broadcast by shuffles)."""
    live = partners[partners > 0]
    bits = np.zeros(pid1.shape[0], bool)
    for w0 in range(0, pid1.shape[0], LANES):
        word = pid1[w0:w0 + LANES]
        bits[w0:w0 + LANES] = np.isin(word, live)
    return bits, live.size > 0


def bitmask_mirror(st, spec):
    """Kernel 1's bonded per-slot layout (se/hs, FENE + WCA, More) in numpy
    f32: forces (3, Npad) and the potential energy (float64 sum)."""
    r = st.r.numpy()
    pid = st.pid.numpy()
    se, hs = st.attrs["se"].numpy(), st.attrs["hs"].numpy()
    bp = np.stack([st.attrs[f"bp{k}"].numpy()
                   for k in range(spec.bond_slots)])
    rc2 = F32(spec.r_cut) ** 2
    k_b, r0 = F32(spec.fene_k), F32(spec.fene_r0)
    f = np.zeros_like(r)
    pe = 0.0
    for cell in range(spec.n_cells):
        slots, pos, own = staged_rows(spec, box_edges(st), r,
                                      pid < spec.n_real, cell)
        if not own:
            continue
        pid1 = (pid[slots] + 1).astype(F32)
        for q_i in own:
            s = slots[q_i]
            bonded_bit, has_partner = bond_mask(bp[:, s], pid1)
            d = (pos[q_i] - pos).astype(F32)
            r2 = (d * d).sum(1, dtype=F32)
            eps = se[s] * se[slots]
            bonded = has_partner & bonded_bit & (r2 > F32(1e-12))
            inside = (r2 < rc2) & (r2 > F32(1e-12)) & (eps > 0)
            hit = inside | bonded
            d, r2, eps, bonded = d[hit], r2[hit], eps[hit], bonded[hit]
            sig2 = (hs[s] + hs[slots][hit]) ** 2
            s2 = sig2 / r2
            s6 = s2 * s2 * s2
            s12 = s6 * s6
            # FENE + WCA on the bonded pairs, LJ (shifted) on the others
            x = np.minimum(r2 / (r0 * r0), F32(0.99))
            wca = r2 < F32(1.2599210498948732) * sig2
            c_b = (-k_b / (F32(1) - x)
                   + np.where(wca, F32(4) * eps * (F32(12) * s12 - F32(6)
                                                   * s6) / r2, F32(0)))
            e_b = (F32(-0.5) * k_b * r0 * r0 * np.log1p(-x)
                   + np.where(wca, F32(4) * eps * (s12 - s6) + eps, F32(0)))
            c_l = F32(4) * eps * (F32(12) * s12 - F32(6) * s6) / r2
            e_l = F32(4) * eps * (s12 - s6)
            if spec.shift_energy:
                sc6 = (sig2 / rc2) ** 3
                e_l = e_l - F32(4) * eps * (sc6 * sc6 - sc6)
            coef = np.where(bonded, c_b, c_l).astype(F32)
            f[:, s] = (coef[:, None] * d).sum(0, dtype=F32)
            pe += 0.5 * float(np.where(bonded, e_b, e_l).astype(
                np.float64).sum())
    return f, pe


@pytest.mark.parametrize("arms", [6, 10])
def test_bitmask_plan_matches_reference(arms):
    pos, bonds, L = star_melt(4 if arms == 10 else 8, arms=arms)
    n = pos.shape[0]
    jspec = jp.PackedSpec.create(L, n, r_cut=2.0 ** (1 / 6), skin=0.4,
                                 cap=24, fene_k=30.0, fene_r0=1.5,
                                 bond_slots=arms)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            extra_attrs=jp.bond_partner_attrs(bonds, n,
                                                              slots=arms))
    assert not ovf
    st, spec = (interop.packed_state_from(jst, "cpu"),
                interop.packed_spec_from(jspec))
    ref = jax.jit(jp.packed_lj_force, static_argnums=1)(jst, jspec)
    f, pe = bitmask_mirror(st, spec)
    jf = np.asarray(ref.f)
    fmax = np.abs(jf).max()
    assert np.isfinite(f).all() and fmax > 1.0
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5 * fmax + 1e-5)
    np.testing.assert_allclose(pe, float(ref.potential_energy), rtol=1e-5)
    # every centre's arms are in the slots, and the wrapper hands the
    # kernel the first eight columns by pointer and stacks the rest
    centres = st.slot_of[::1 + 5 * arms].long()
    bp = torch.stack([st.attrs[f"bp{k}"] for k in range(arms)])
    assert bool((bp[:, centres] > 0).all())
    pc.check_spec(spec)
    cols, more, keep = pc.bond_cols(st, spec, "test")
    head = min(arms, pc.COL_BOND_SLOTS)
    assert list(cols) == [st.attrs[f"bp{k}"].data_ptr()
                          for k in range(head)]
    if arms > pc.COL_BOND_SLOTS:
        assert keep.shape == (arms - pc.COL_BOND_SLOTS, spec.n_pad)
        assert more == keep.data_ptr() and torch.equal(keep, bp[head:])
    else:
        assert more is None and keep is None


def ql_terms(tab, l, d, gre, gim):
    """One Q_l's value terms (2 (l + 1), pairs) and bias force (3, pairs)
    of pairs d (3, pairs) in f32 from its descriptor table (order_cv.cuh
    ql_lanes: N_m, the p_lm coefficients, their derivatives' and the aux
    lanes g_re, g_im)."""
    norms = tab[:l + 1]
    co, dco = l + 1, l + 1 + (l + 1) * (l + 2) // 2
    r2 = (d * d).sum(0, dtype=F32)
    inv_r = (F32(1) / np.sqrt(r2)).astype(F32)
    cth, ux, uy = d[2] * inv_r, d[0] * inv_r, d[1] * inv_r
    pr, pi = np.ones_like(cth), np.zeros_like(cth)
    qr, qi = np.zeros_like(cth), np.zeros_like(cth)
    D = E = F = BU = np.zeros_like(cth)
    vals = np.zeros((2 * (l + 1), d.shape[1]), F32)
    for m in range(l + 1):
        nc = l - m + 1
        pl = np.zeros_like(cth)
        for c in tab[co:co + nc][::-1]:
            pl = pl * cth + c
        co += nc
        nd = max(nc - 1, 1)
        dpl = np.zeros_like(cth)
        for c in tab[dco:dco + nd][::-1]:
            dpl = dpl * cth + c
        dco += nd
        wn = norms[m] * pl
        vals[m], vals[l + 1 + m] = wn * pr, wn * pi
        D = D + norms[m] * dpl * (gre[m] * pr + gim[m] * pi)
        if m > 0:
            br = F32(m) * (gre[m] * qr + gim[m] * qi)
            bi = F32(m) * (gre[m] * qi - gim[m] * qr)
            E = E + norms[m] * pl * br
            F = F + norms[m] * pl * bi
            BU = BU + norms[m] * pl * (br * ux - bi * uy)
        qr, qi = pr, pi
        pr, pi = pr * ux - pi * uy, pr * uy + pi * ux
    g = np.stack([(D * (-cth * ux) + E - ux * BU) * inv_r,
                  (D * (-cth * uy) - F - uy * BU) * inv_r,
                  (D * (F32(1) - cth * cth) - cth * BU) * inv_r])
    return vals, g.astype(F32)


def warp_tree(v):
    """A shuffle-down tree's sum of 32 lanes (lane 0's), in f32."""
    v = np.concatenate([v, np.zeros(LANES - v.size, F32)]).astype(F32)
    for off in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[off:], np.zeros(off, F32)])
    return v[0]


def wide_mirror(st, spec, desc, n_cvs, aux, n_terms):
    """Kernels 2 and 3's wide recurrence in numpy f32 (sentinel layout, no
    prefilter: the hit radius alone bounds the pairs): the value lanes
    (float64 sum of the cells' rows) and the bias force (3, Npad).  Each
    warp's rows run wide_sweep twice, as the two kernels do: values-only
    with one hit queue across the rows, force-only flushing it per row;
    the Q_l queue runs across rows in both."""
    r = st.r.numpy()
    heads = desc[:9 * n_cvs].reshape(n_cvs, 9)
    ql = [c for c in range(n_cvs) if int(heads[c, 0]) == poc.KIND_QL]
    rc2_hit = F32(heads[:, 5].max())
    rc2_q = F32(max(heads[c, 5] for c in ql))
    vals = np.zeros(n_terms, np.float64)
    g = np.zeros_like(r)
    for cell in range(spec.n_cells):
        slots, pos, own = staged_rows(spec, box_edges(st), r, r[0] < 1e6,
                                      cell)
        row_sums = np.zeros((WARPS, n_terms), F32)
        for warp in range(WARPS):
            rows = own[warp::WARPS]
            for grad in (False, True):
                red = row_sums[warp]
                gsum = {i: np.zeros(3, F32) for i in rows}
                queue, queue_q = [], []

                def geom(entries):
                    d = np.stack([pos[i] - pos[q] for i, q in entries], 1)
                    return d.astype(F32), (d * d).sum(0, dtype=F32)

                def qround(entries):
                    d, r2 = geom(entries)
                    gq = np.zeros((3, len(entries)), F32)
                    for c in ql:
                        h = heads[c]
                        on = r2 < h[5]
                        if not on.any():
                            continue
                        l, vo, tab = int(h[1]), int(h[2]), desc[int(h[4]):]
                        ga = aux[int(h[3]):]
                        v, gg = ql_terms(tab, l, d[:, on], ga[:l + 1],
                                         ga[l + 1:2 * (l + 1)])
                        if grad:
                            gq[:, on] += gg
                            continue
                        for t in range(2 * (l + 1)):
                            if l in TILED_L:
                                acc = F32(0)  # the tile row, column order
                                for x in v[t]:
                                    acc = F32(acc + x)
                            else:         # a shuffle tree over the lanes
                                lanes = np.zeros(len(entries), F32)
                                lanes[on] = v[t]
                                acc = warp_tree(lanes)
                            red[vo + t] += acc
                        red[vo + 2 * (l + 1)] += F32(on.sum())
                    if grad:   # each row's lanes by a shuffle tree
                        for i in dict.fromkeys(e[0] for e in entries):
                            mine = np.asarray([e[0] == i for e in entries])
                            gsum[i] += [warp_tree(np.where(mine, gq[a], 0))
                                        for a in range(3)]

                def near(entries):
                    d, r2 = geom(entries)
                    for c in range(n_cvs):
                        h = heads[c]
                        if int(h[0]) == poc.KIND_QL:
                            continue
                        on = r2 < h[5]
                        t = r2 / h[6]
                        den = F32(1) + t * t * t
                        if grad:
                            co = (aux[int(h[3])] * F32(2) * (F32(-3) * t * t
                                  / (h[6] * (den * den)) * h[8]))
                            gc = np.where(on, co, 0)[None] * d
                            for i in dict.fromkeys(e[0] for e in entries):
                                mine = np.asarray([e[0] == i
                                                   for e in entries])
                                gsum[i] += (gc[:, mine].sum(1, dtype=F32))
                        elif on.any():
                            red[int(h[2])] += warp_tree(np.where(
                                on, (F32(1) / den - h[7]) * h[8], 0))
                    queue_q.extend(e for e, x in zip(entries, r2 < rc2_q)
                                   if x)
                    if len(queue_q) >= LANES:
                        qround(queue_q[:LANES])
                        del queue_q[:LANES]

                for i in rows:
                    d = pos[i] - pos
                    r2 = (d * d).sum(1, dtype=F32)
                    hits = np.flatnonzero((r2 > F32(1e-12)) & (r2 < rc2_hit))
                    for q in hits:
                        queue.append((i, q))
                        if len(queue) == LANES:
                            near(queue)
                            queue = []
                    if grad and queue:
                        near(queue)
                        queue = []
                if queue:
                    near(queue)
                if queue_q:
                    qround(queue_q)
                for i in rows if grad else ():
                    g[:, slots[i]] = gsum[i]
        vals += row_sums.sum(0, dtype=F32).astype(np.float64)
    return vals, g


def fcc_state(n_cells=4, a=1.6, noise=0.05, seed=3):
    """(reference state, spec, port state, spec): fcc with noise, the
    sentinel layout."""
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    grid = np.stack(np.meshgrid(*[np.arange(n_cells)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3)
    pos = ((grid + base).reshape(-1, 3) * a).astype(np.float32)
    pos += np.random.default_rng(seed).normal(0.0, noise, pos.shape).astype(
        np.float32)
    n, L = pos.shape[0], n_cells * a
    jspec = jp.PackedSpec.create(L, n, r_cut=1.6, skin=0.3, cap=24,
                                 uniform_sigma=1.0, uniform_eps=1.0)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


def wide_layout(plan) -> bool:
    """Whether a plan runs the wide layout (order_cv.cuh launch_staged_set,
    the recurrence): past the narrow instantiations' 64 value or aux lanes
    or 1024 descriptor floats."""
    return (plan.n_vals > 64 or plan.n_aux > 64 or plan.desc.numel() > 1024)


WIDE_LISTS = {
    # Config 3's phase-43 list: every Q_l at a compile-time degree
    "q8_q10_q12": ([8, 10, 12], False, 2e-5),
    # past the tile: each term by a shuffle tree; and a coordination
    "q14_q16_coord": ([14, 16], True, 2e-4),
}


@pytest.mark.parametrize("name", sorted(WIDE_LISTS))
def test_wide_plan_matches_reference(name):
    ls, coord, rtol = WIDE_LISTS[name]
    jst, jspec, st, spec = fcc_state()
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=1.4, l=l, name=f"q{l}")
            for l in ls]
    if coord:
        jcvs.append(jpo.PackedCoordination(spec=jspec, r0=1.1, r_cut=1.5,
                                           name="co"))
    cvs = [interop.steinhardt_from(c) if hasattr(c, "l") else
           interop.coordination_from(c) for c in jcvs]
    lanes = poc.lane_layout(cvs)
    assert lanes == _lane_layout(cvs, False)
    plan = poc._plan(tuple(cvs), torch.device("cpu"))
    assert wide_layout(plan) and plan.lanes == poc.LANES_ANY
    if not coord:
        assert lanes[2:] == (66, 69)
    values_fn, force_fn = jpo.make_fused_order_force(jcvs, jspec)
    dV = jnp.asarray([0.9, -1.3, 0.6][:len(jcvs)], jnp.float32)

    def sweeps(state):
        _, ctx = values_fn(state)
        return ctx[0], force_fn(state, ctx, dV)

    # eagerly: compiling the sweeps at these degrees takes about a minute
    with jax.disable_jit():
        terms_ref, g_ref = sweeps(jst)
    g_ref = np.asarray(g_ref)
    auxs = [jc.grad_aux(t, dV[i]) for i, (jc, t) in
            enumerate(zip(jcvs, terms_ref))]
    aux = poc.pack_force_aux(cvs, [
        tuple(torch.as_tensor(np.array(x)) for x in a)
        if isinstance(a, tuple) else torch.as_tensor(np.array(a))
        for a in auxs]).numpy()
    desc = poc.cv_descriptor(cvs)
    vals, g = wide_mirror(st, spec, desc, len(cvs), aux, lanes[3])
    for cv, vo, terms in zip(cvs, lanes[1], terms_ref):
        ref = np.concatenate([np.asarray(t).reshape(-1) for t in terms])
        got = vals[vo:vo + ref.size]
        scale = np.abs(ref).max()
        assert scale > 1.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)
    gmax = np.abs(g_ref).max()
    assert math.isfinite(gmax) and gmax > 1e-3
    assert np.all(np.abs(g - g_ref) <= 2e-3 * np.abs(g_ref) + 2e-4 * gmax)
