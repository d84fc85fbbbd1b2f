"""The port's x-slab decomposition (``metadyn_tpu_torch/parallel/spatial.py``)
against the JAX package's single-grid functions, on the CPU, where the
shards are virtual shards of the CPU and every island runs the kernels'
plain versions.

The reference holds its own sharded engine equal to these same functions
(``tests/test_spatial.py``, ``tests/test_spatial_pallas.py``): the
sharded force against ``packed_lj_force``, the sharded repack against
``repack_incremental`` bit for bit, the order and lagged islands against
its kernels.  Here: the sharded force with 1, 2 and 4 shards (4 shards of
a 4-plane grid is cx_l = 1: three planes per extended grid), seam pairs,
bonds, a tilted box; the masked energy and virial of the plain force; the
sharded repack; the order parts (kernel 2 with ``cell_mask``, kernel 3)
and the lagged parts (kernel 4 with ``mono=True, cell_mask=``) against
the reference's Pallas kernels in interpret mode on the same extended
grids, summed over the shards as the reference's ``psum`` sums them.

Inputs: fcc 8³ (2,048 particles, a = 1.62) with Gaussian noise 0.05,
from a seed, r_cut 2.5 and skin 0.5 (4³ cells, cap 48); for the order
islands, whose reference kernels run in interpret mode, fcc 6³ (864) with
r_cut 1.5 and skin 0.9 (4³ cells, cap 32).

Tolerances: forces rtol 1e-5, atol 1e-4 (pair forces summed in other
orders), energy and virial rtol 1e-5 (the reference's own sharded-force
tolerances); the repack bit for bit; CV values rtol 5e-5, bias forces
rtol 1e-3, atol 2e-5 of the largest component (the reference's
``test_sharded_order_parts_match_gspmd_sweep``); the fused LJ force rtol
1e-4, atol 1e-5 of its largest (``test_sharded_lagged_fused_matches_
global``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import metadyn_tpu.ops.packed_fused_pallas as pfp
import metadyn_tpu.ops.packed_order_pallas as pop
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.cv import packed_order as jpo
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops import packed as tp
from metadyn_tpu_torch.parallel import spatial as sp

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)
DV = np.array([0.7, -0.3], np.float32)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_state(st):
    """A port PackedState as the reference's."""
    a = interop.packed_state_arrays(st)
    box = JBox(L=jnp.asarray(a["box"]["L"]),
               tilt=(None if a["box"]["tilt"] is None
                     else jnp.asarray(a["box"]["tilt"])))
    return jp.PackedState(
        **{k: jnp.asarray(a[k]) for k in ("r", "v", "f", "image", "ref_r",
                                          "pid", "typ", "slot_of",
                                          "potential_energy", "virial")},
        attrs={k: jnp.asarray(v) for k, v in a["attrs"].items()}, box=box)


def fcc_case(sentinel=True, tilt=None, seed=0, vel=False):
    """(jstate, jspec, state, spec): 2,048 noisy fcc particles."""
    pos = fcc_lattice(8, A_LAT)
    n, L = pos.shape[0], 8 * A_LAT
    rng = np.random.default_rng(seed)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    v = rng.normal(0.0, 0.5, pos.shape).astype(np.float32) if vel else None
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=48,
                                 shift_energy=False, tilt=tilt, **kw)
    box = (JBox.cubic(L) if tilt is None
           else JBox(L=jnp.full(3, L, jnp.float32),
                     tilt=jnp.asarray(tilt, jnp.float32)))
    jst, ovf = jp.pack_host(pos, box, jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            vel=v)
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


def order_case(seed: int):
    """(jstate, jspec, state, spec) for the order islands: 864 noisy fcc
    particles (fcc 6³), r_cut 1.5 and skin 0.9 (4³ cells, cap 32): a small
    grid that still covers the CVs' cut-offs, since the reference's kernels
    run in interpret mode."""
    pos = fcc_lattice(6, A_LAT)
    n, L = pos.shape[0], 6 * A_LAT
    rng = np.random.default_rng(seed)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    jspec = jp.PackedSpec.create(L, n, r_cut=1.5, skin=0.9, cap=32,
                                 shift_energy=False, uniform_sigma=1.0,
                                 uniform_eps=1.0)
    assert jspec.cells_per_dim == (4, 4, 4)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    return (jst, jspec, interop.packed_state_from(jst, "cpu"),
            interop.packed_spec_from(jspec))


def assert_force_parity(out, ref):
    f = np.asarray(ref.f)
    np.testing.assert_allclose(out.f.numpy(), f, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(out.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(out.virial.numpy(), np.asarray(ref.virial),
                               rtol=1e-5)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_sharded_force_matches_reference(n_dev):
    """1, 2 and 4 shards of the 4 x-planes (cx_l 4, 2, 1) against the JAX
    single-grid force, energy and virial; forces only keeps them."""
    jst, jspec, st, spec = fcc_case()
    assert spec.cells_per_dim == (4, 4, 4)
    ref = jp.packed_lj_force(jst, jspec)
    out = sp.make_sharded_lj_force(spec, ["cpu"] * n_dev,
                                   with_energy=True)(st)
    assert_force_parity(out, ref)
    fo = sp.make_sharded_lj_force(spec, ["cpu"] * n_dev)(st)
    np.testing.assert_array_equal(fo.f.numpy(), out.f.numpy())
    assert fo.potential_energy is st.potential_energy


def test_sharded_force_seam_pairs():
    """The reference's adversarial case: a pair 1.0 apart across every
    x-cell boundary and the periodic seam, 4 shards (cx_l = 2)."""
    L = 8 * 3.0
    xs = []
    for b in range(8):
        xb = -L / 2 + b * 3.0
        xs += [[xb - 0.5, 0.0, 0.0], [xb + 0.5, 0.0, 0.0]]
    pos = np.asarray(xs, np.float32)
    pos[:, 1] = np.repeat(np.linspace(-L / 2 + 1, L / 2 - 1, 8), 2)
    n = pos.shape[0]
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=8,
                                 shift_energy=False)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    ref = jp.packed_lj_force(jst, jspec)
    f_mag = np.linalg.norm(np.asarray(ref.f), axis=0)
    assert f_mag[np.asarray(jst.pid) < n].min() > 1.0
    out = sp.make_sharded_lj_force(interop.packed_spec_from(jspec),
                                   ["cpu"] * 4, with_energy=True)(
        interop.packed_state_from(jst, "cpu"))
    assert_force_parity(out, ref)


def test_sharded_force_with_bonds_and_tables():
    """FENE bonds across shard boundaries and a per-type ε table, per-slot
    layout (pid and the partner attrs ride the halo), 2 shards."""
    from tests.test_torch_bond_kernels import lattice_melt
    pos, vel, bonds, types, L = lattice_melt(chain_len=12, m=12)
    n = pos.shape[0]
    eps_scale, _, eps_d, _ = jp.pair_scale_tables([[1.0, 0.6], [0.6, 1.0]])
    jspec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=48,
                                 fene_k=30.0, fene_r0=1.5,
                                 eps_scale=eps_scale)
    assert jspec.cells_per_dim[0] % 2 == 0
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, types,
                            eps_d[types], np.ones(n, np.float32),
                            extra_attrs=jp.bond_partner_attrs(bonds, n))
    assert not ovf
    ref = jp.packed_lj_force(jst, jspec)
    out = sp.make_sharded_lj_force(interop.packed_spec_from(jspec),
                                   ["cpu"] * 2, with_energy=True)(
        interop.packed_state_from(jst, "cpu"))
    assert_force_parity(out, ref)


def test_sharded_force_tilted_box():
    """A tilted cell: the slab axis is fractional x and the seam shift
    stays ±Lx (a1 = (Lx, 0, 0)), 2 shards."""
    jst, jspec, st, spec = fcc_case(tilt=(0.2, -0.1, 0.1))
    assert spec.cells_per_dim[0] % 2 == 0
    ref = jp.packed_lj_force(jst, jspec)
    out = sp.make_sharded_lj_force(spec, ["cpu"] * 2, with_energy=True)(st)
    assert_force_parity(out, ref)


def test_plain_force_masked_energy_matches_reference():
    """``cell_mask`` on a random half of the cells: the energy and virial
    of the pairs whose i cell is in, the forces unmasked."""
    jst, jspec, st, spec = fcc_case(sentinel=False)
    mask = (np.random.default_rng(2).random(spec.n_cells) < 0.5).astype(
        np.float32)
    ref = jp.packed_lj_force(jst, jspec, cell_mask=jnp.asarray(mask))
    out = tp.packed_lj_force(st, spec, cell_mask=torch.as_tensor(mask))
    assert_force_parity(out, ref)
    assert abs(float(ref.potential_energy)) > 0


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_repack_matches_reference_bit_for_bit(n_dev):
    """Displaced by up to ±1.0 of a 3.24-wide cell: particles cross cell,
    shard and seam boundaries; the slot assignment, every column and the
    held bias force attrs equal the reference's single-grid repack."""
    jst, jspec, st, spec = fcc_case(seed=3, vel=True)
    rng = np.random.default_rng(7)
    held = {k: jnp.asarray(rng.normal(0.0, 1.0, spec.n_pad), jnp.float32)
            for k in ("held_gx", "held_gy", "held_gz")}
    disp = jnp.asarray(rng.uniform(-1.0, 1.0, (3, spec.n_pad)), jnp.float32)
    jst = jst.replace(r=jnp.where((jst.pid < spec.n_real)[None],
                                  jst.r + disp, jst.r),
                      attrs={**jst.attrs, **held})
    ref, bad_ref = jp.repack_incremental(jst, jspec)
    assert not bool(bad_ref)
    out, bad = sp.make_sharded_repack(spec, ["cpu"] * n_dev)(
        interop.packed_state_from(jst, "cpu"))
    assert not bool(bad)
    for k in ("r", "v", "f", "image", "pid", "typ", "slot_of"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)),
                                      err_msg=k)
    assert sorted(out.attrs) == sorted(ref.attrs)
    for k in ref.attrs:
        np.testing.assert_array_equal(out.attrs[k].numpy(),
                                      np.asarray(ref.attrs[k]), err_msg=k)


def _cvs(jspec):
    jcvs = [jpo.PackedSteinhardtQl(spec=jspec, r_cut=NN * 1.2, l=6,
                                   name="q6"),
            jpo.PackedCoordination(spec=jspec, r0=NN * 1.35,
                                   r_cut=NN * 1.35 * 1.5, name="co")]
    return jcvs, [interop.steinhardt_from(jcvs[0]),
                  interop.coordination_from(jcvs[1])]


def _interpret(*modules):
    """Patch pallas_call to interpret mode in ``modules``; returns the
    undo."""
    orig = pl.pallas_call
    for m in modules:
        m.pl.pallas_call = lambda *a, **k: orig(*a, **{**k,
                                                      "interpret": True})

    def undo():
        for m in modules:
            m.pl.pallas_call = orig
    return undo


def _ext_jax(slabs, st):
    """The shards' extended grids (r, pid, se, hs) as reference states, and
    the extended spec as the reference's."""
    return ([jax_state(e) for e in slabs.halo_states(
                st, pid=True, attrs=("se", "hs"))],
            jp.PackedSpec(**interop.packed_spec_fields(slabs.spec_ext)))


def _jsum(a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_jsum(x, y) for x, y in zip(a, b))
    return a + b


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_order_parts_match_reference_kernels(n_dev):
    """Kernel 2 with the interior ``cell_mask`` and kernel 3 on the shards'
    extended grids.  2 shards: the reference's kernels in Pallas interpret
    mode on the same extended grids, its per-shard terms summed (its psum),
    against the port's islands; 4 shards (cx_l = 1): the port's islands
    against the reference's single-grid XLA sweep, as both are."""
    jst, jspec, st, spec = order_case(seed=7)
    jcvs, cvs = _cvs(jspec)
    values_fn, force_fn = sp.make_sharded_order_parts(cvs, spec,
                                                      ["cpu"] * n_dev)
    s, ctx = values_fn(st)
    g = force_fn(st, ctx, torch.as_tensor(DV)).numpy()
    if n_dev == 2:
        slabs = sp.Slabs(spec, ["cpu"] * n_dev)
        exts, jsx = _ext_jax(slabs, st)
        masks = [jnp.asarray(m.numpy()) for m in slabs.interior]
        undo = _interpret(pop)
        try:
            values = jax.jit(lambda e, m: pop.order_values_pallas(
                e, jsx, jcvs, cell_mask=m)[0])
            terms = None
            for est, m in zip(exts, masks):
                t = values(est, m)
                terms = t if terms is None else _jsum(terms, t)
            auxs = [cv.grad_aux(t, jnp.float32(DV[i]))
                    for i, (cv, t) in enumerate(zip(jcvs, terms))]
            force = jax.jit(lambda e: pop.order_force_pallas(e, jsx, jcvs,
                                                             auxs))
            gs = [torch.as_tensor(np.array(force(e))) for e in exts]
        finally:
            undo()
        s_ref = [float(cv.finalize_value(t)) for cv, t in zip(jcvs, terms)]
        g_ref = slabs.gather(gs).numpy()
    else:
        jv, jf = jpo.make_fused_order_force(jcvs, jspec, use_pallas=False)
        s_ref, jctx = jv(jst)
        g_ref = np.asarray(jf(jst, jctx, jnp.asarray(DV)))
    scale = np.abs(g_ref).max()
    assert scale > 1e-4
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=5e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=2e-5 * scale)


def test_sharded_lagged_parts_match_reference_kernel():
    """Kernel 4 in the monomial mode with the interior ``cell_mask`` on 2
    shards' extended grids, reference side in interpret mode, its per-shard
    terms summed; the port's lagged island against it, given the same
    lagged terms (the port's plain value sweep, held against the
    reference's in tests/test_torch_order.py) and bias; and the shards'
    LJ force against the reference's single-grid XLA force."""
    from metadyn_tpu.bias.grid import GridSpec as JGridSpec
    from metadyn_tpu.bias.metad import BiasState as JBias
    from metadyn_tpu.bias.metad import bias_value_and_grad
    from metadyn_tpu_torch.cv.packed_order import order_values_plain

    jst, jspec, st, spec = order_case(seed=9)
    jcvs, cvs = _cvs(jspec)
    jgrid = JGridSpec.create([0.0, 4.0], [0.7, 28.0], [32, 32], [0.02, 0.5])
    jbias = JBias.zeros(jgrid)
    jbias = jbias.replace(grid=jbias.grid.replace(dV=jbias.grid.dV + 0.3))
    bias = interop.bias_state_from(jbias, "cpu")
    slabs = sp.Slabs(spec, ["cpu"] * 2)
    exts, jsx = _ext_jax(slabs, st)

    terms = order_values_plain(st, spec, cvs)
    jterms = tuple(tuple(jnp.asarray(x.numpy()) for x in t) for t in terms)
    sv = jnp.stack([cv.finalize_value(t) for cv, t in zip(jcvs, jterms)])
    _, dVds = bias_value_and_grad(jbias, sv)
    jauxs = [cv.grad_aux(t, dVds[i])
             for i, (cv, t) in enumerate(zip(jcvs, jterms))]
    undo = _interpret(pfp)
    try:
        fused = jax.jit(lambda e, m: pfp.fused_lj_order_force(
            e, jsx, jcvs, jauxs, mono=True, cell_mask=m))
        fs, gs, tsum = [], [], None
        for est, m in zip(exts, slabs.interior):
            f, g, t = fused(est, jnp.asarray(m.numpy()))
            fs.append(torch.as_tensor(np.array(f)))
            gs.append(torch.as_tensor(np.array(g)))
            tsum = t if tsum is None else _jsum(tsum, t)
    finally:
        undo()
    f_ref, g_ref = slabs.gather(fs).numpy(), slabs.gather(gs).numpy()
    s_ref = [float(cv.finalize_value(t)) for cv, t in zip(jcvs, tsum)]

    _, fused_force = sp.make_sharded_lagged_parts(cvs, spec, ["cpu"] * 2)
    f, g, t_new = fused_force(st, bias, terms)
    sf = np.abs(f_ref).max()
    np.testing.assert_allclose(f.numpy(), f_ref, rtol=1e-4, atol=1e-5 * sf)
    sg = np.abs(g_ref).max()
    assert sg > 1e-4
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-3, atol=2e-5 * sg)
    s = [float(cv.finalize_value(x)) for cv, x in zip(cvs, t_new)]
    np.testing.assert_allclose(s, s_ref, rtol=5e-5, atol=1e-6)
    # fresh terms at unmoved positions: the values the lag started from
    np.testing.assert_allclose(
        s_ref, [float(x) for x in sv], rtol=5e-5, atol=1e-6)
    np.testing.assert_allclose(
        f_ref, np.asarray(jp.packed_lj_force(jst, jspec).f), rtol=1e-4,
        atol=1e-5 * sf)
