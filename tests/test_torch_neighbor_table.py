"""The port's slot neighbour table (``metadyn_tpu_torch/ops/
neighbor_table.py``) and the table order path (``cv/packed_order.
make_table_order_force``), on the CPU.

Inputs: the reference's ``tests/test_packed.py`` case, fcc 6³ (864
particles, a = 1.62) with Gaussian noise 0.08 from a seed, r_cut 2.5,
skin 0.4 (3³ cells, cap 40); the CVs Q6 (r_cut 1.2 nn)
and coordination (r0 1.35 nn, r_cut 1.5·r0), the table radius the
coordination's r_cut + skin, K 96.

Against the JAX package's ``build_slot_neighbor_table`` on the same state:
the table entry for entry and the overflow flag (K 96 holds; at K 8 the
port's flag and first 8 entries against the reference's K-96 table).
Against the port's fused order path (the cell sweeps): values rtol 2e-5,
bias forces rtol 2e-3 with atol 2e-4 of the largest component (the sum
orders differ; the reference's ``tests/test_packed.py`` table tolerances).
The engine keeps the table through a repack and a short biased run.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.ops.neighbor_table import (
    build_slot_neighbor_table as jax_build,
)

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.bias.grid import GridSpec
from metadyn_tpu_torch.bias.metad import HillSpec, WELL_TEMPERED
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.core.packed_engine import PackedEngine
from metadyn_tpu_torch.core.state import make_system
from metadyn_tpu_torch.cv.packed_order import (
    PackedCoordination, PackedSteinhardtQl, make_fused_order_force,
    make_table_order_force,
)
from metadyn_tpu_torch.integrate.packed import make_packed_langevin_step
from metadyn_tpu_torch.ops.neighbor_table import build_slot_neighbor_table
from metadyn_tpu_torch.ops.packed import PackedSpec
from metadyn_tpu_torch.sampler import MetadSampler
from metadyn_tpu_torch.utils.lattice import fcc_lattice

NN = 1.62 / np.sqrt(2)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    # module scope, so that it is set before the module-scoped fixture
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    pos = fcc_lattice(6, 1.62)
    n, L = pos.shape[0], 6 * 1.62
    rng = np.random.default_rng(12)
    pos = (pos + rng.normal(0, 0.08, pos.shape)).astype(np.float32)
    vel = rng.normal(0, np.sqrt(0.7), pos.shape).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.4, cap=40)
    st, ovf = PackedEngine(spec, "cpu").pack_state(
        pos, Box.cubic(L, "cpu"), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf
    q6 = PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6")
    co = PackedCoordination(spec, r0=NN * 1.35, name="co",
                            r_cut=NN * 1.35 * 1.5)
    return st, spec, [q6, co], co.r_cut + spec.skin


def test_table_matches_reference_entry_for_entry(case):
    st, spec, _, r_nb = case
    a = interop.packed_state_arrays(st)
    jst = jp.PackedState(
        **{k: jnp.asarray(a[k]) for k in ("r", "v", "f", "image", "ref_r",
                                          "pid", "typ", "slot_of",
                                          "potential_energy", "virial")},
        attrs={}, box=JBox(L=jnp.asarray(a["box"]["L"])))
    jspec = jp.PackedSpec(**interop.packed_spec_fields(spec))
    jt, jo = jax.jit(functools.partial(jax_build, spec=jspec, r_nb=r_nb,
                                       K=96))(jst)
    tbl, ovf = build_slot_neighbor_table(st, spec, r_nb, 96)
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jt))
    assert not bool(ovf) and not bool(jo)
    # at K 8 the reference's complete K-96 table says which slots overflow
    # (one JAX compile, not two): the port's flag and its first 8 entries
    tbl8, ovf8 = build_slot_neighbor_table(st, spec, r_nb, 8)
    full = np.asarray(jt)
    assert bool(ovf8) == bool(((full < spec.n_pad).sum(0) > 8).any())
    assert bool(ovf8)
    np.testing.assert_array_equal(tbl8.numpy(), full[:8])


def test_table_order_path_matches_cell_sweeps(case):
    st, spec, cvs, r_nb = case
    tbl, ovf = build_slot_neighbor_table(st, spec, r_nb, 96)
    assert not bool(ovf)
    tv, tf = make_table_order_force(cvs, spec)
    fv, ff = make_fused_order_force(cvs, spec)
    s_t, terms = tv(st, tbl)
    s_f, ctx = fv(st)
    np.testing.assert_allclose(s_t.numpy(), s_f.numpy(), rtol=2e-5)
    dVds = torch.tensor([1.3, -0.4])
    g_t = tf(st, tbl, terms, dVds)
    g_f = ff(st, ctx, dVds)
    np.testing.assert_allclose(g_t.numpy(), g_f.numpy(), rtol=2e-3,
                               atol=2e-4 * float(g_f.abs().max()))


def test_table_engine_run_with_repack(case):
    """Biased MD on the table engine: every repack rebuilds the table (a
    repack at every block here); the table of the last repack still holds
    every pair of the CVs at the run's end (the freshness contract), so the
    CVs through it are the cell sweeps', and nothing overflows."""
    st, spec, cvs, r_nb = case
    engine = PackedEngine(spec, "cpu", rebuild_every=5,
                          nbr_table=(r_nb, 96), always_repack=True)
    s0 = [float(cv.value(st, None)) for cv in cvs]
    grid = GridSpec.create([0.0, 0.0], [0.7, s0[1] * 2.0], [24, 24],
                           [0.02, s0[1] / 15], "cpu")
    sampler = MetadSampler(
        make_system(spec.n_real, "cpu"), st, engine, cvs, grid,
        HillSpec.create(W=0.4, stride=10, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=0.7, gamma=1.0),
        seed=0, chunks_per_block=2)
    hist = sampler.run(20)
    assert not bool(hist[-1]["nlist_overflow"])
    assert int(sampler.bias.n_hills) == 2
    tv, _ = make_table_order_force(cvs, spec)
    fv, _ = make_fused_order_force(cvs, spec)
    np.testing.assert_allclose(
        tv(sampler.state, sampler.carry.aux.nbr)[0].numpy(),
        fv(sampler.state)[0].numpy(), rtol=2e-5)


def test_table_engine_checks():
    """The reference's checks: K a multiple of 8, r_nb within the cell
    width, an orthorhombic box."""
    spec = PackedSpec.create(9.72, 864, r_cut=2.5, skin=0.4, cap=40)
    with pytest.raises(ValueError, match="multiple of 8"):
        PackedEngine(spec, "cpu", nbr_table=(2.0, 12))
    engine = PackedEngine(spec, "cpu", nbr_table=(3.3, 16))
    st, _ = engine.pack_state(fcc_lattice(6, 1.62), Box.cubic(9.72, "cpu"),
                              np.zeros(864, np.int32),
                              np.ones(864, np.float32),
                              np.ones(864, np.float32))
    with pytest.raises(ValueError, match="stencil"):
        engine.init(st)
