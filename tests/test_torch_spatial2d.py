"""The port's 2-D decomposition (``metadyn_tpu_torch/parallel/spatial2d.py``)
against the JAX package's 2-D force island and the port's own single grid,
on the CPU, where the four shards of the 2×2 mesh are virtual shards of the
CPU and every island runs the kernels' plain versions.

Inputs: the reference's ``tests/test_spatial2d.py`` case, a 6³ simple-cubic
lattice (216 particles) in L 12 with uniform noise from a seed, r_cut 2.5,
skin 0.5 (4³ cells, cap 24), so each shard's extended grid is 4 × 4 × 4.

Against the JAX package (one jitted ``make_sharded_lj_force_2d`` on a 2×2
mesh of the conftest's virtual CPU devices): forces rtol 1e-5, atol 1e-6 of
the largest, energy rtol 1e-5, virial rtol 1e-4 (the reference's own
tolerances).  Against the port's ``PackedEngine``: the forces and the
repack bit for bit, energy and virial rtol 1e-5 (summed over the shards in
another order), the order parts' values rtol 2e-5 and bias forces atol
2e-5 of the largest, 5 γ-0 steps rtol 1e-5, and the walkers × 2-D space
batch bit for bit against its walkers alone.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.parallel.spatial2d import (
    make_sharded_lj_force_2d as jax_force_2d,
)

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.batch import stack_walkers, walker
from metadyn_tpu_torch.core.box import Box
from metadyn_tpu_torch.core.packed_engine import PackedEngine
from metadyn_tpu_torch.cv.packed_order import (
    PackedCoordination, PackedSteinhardtQl, make_fused_order_force,
)
from metadyn_tpu_torch.integrate.packed import make_packed_langevin_step
from metadyn_tpu_torch.ops.packed import PackedSpec, repack_incremental
from metadyn_tpu_torch.parallel.spatial2d import SpatialPackedEngine2D

L_BOX = 12.0
SHARDS = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    # module scope, so that it is set before the module-scoped fixture
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(seed=0, jitter=0.15):
    n_side = 6
    sp = L_BOX / n_side
    sites = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3) * sp - L_BOX / 2 + 0.5
    rng = np.random.default_rng(seed)
    pos = (sites + rng.uniform(-jitter, jitter, sites.shape)) \
        .astype(np.float32)
    vel = rng.normal(0, 1.0, pos.shape).astype(np.float32)
    return pos, vel - vel.mean(axis=0)


SPEC = PackedSpec.create(L_BOX, 216, r_cut=2.5, skin=0.5, cap=24,
                         shift_energy=False)


def _pack(pos, vel, engine=None):
    engine = engine or PackedEngine(SPEC, "cpu")
    n = pos.shape[0]
    st, ovf = engine.pack_state(pos, Box.cubic(L_BOX, "cpu"),
                                np.zeros(n, np.int32), np.ones(n, np.float32),
                                np.ones(n, np.float32), vel=vel)
    assert not ovf
    return st


@pytest.fixture(scope="module")
def engines():
    return (PackedEngine(SPEC, "cpu"),
            SpatialPackedEngine2D(SPEC, SHARDS, (2, 2)))


def _jax_state(st):
    a = interop.packed_state_arrays(st)
    return jp.PackedState(
        **{k: jnp.asarray(a[k]) for k in ("r", "v", "f", "image", "ref_r",
                                          "pid", "typ", "slot_of",
                                          "potential_energy", "virial")},
        attrs={k: jnp.asarray(v) for k, v in a["attrs"].items()},
        box=JBox(L=jnp.asarray(a["box"]["L"])))


def test_2d_force_matches_reference_island(engines):
    """The 2×2 force, energy and virial against the JAX package's
    ``make_sharded_lj_force_2d`` (its masked XLA island)."""
    _, eng_2d = engines
    st = _pack(*_case())
    jspec = interop.packed_spec_fields(SPEC)
    jspec = jp.PackedSpec(**jspec)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("spacex", "spacey"))
    ref = jax.jit(jax_force_2d(jspec, mesh))(_jax_state(st))
    got = eng_2d._pair_force(st, True)
    f_r = np.asarray(ref.f)
    np.testing.assert_allclose(got.f.numpy(), f_r, rtol=1e-5,
                               atol=1e-6 * np.abs(f_r).max())
    np.testing.assert_allclose(float(got.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(got.virial.numpy(), np.asarray(ref.virial),
                               rtol=1e-4)


def test_2d_force_matches_single_grid_bit_for_bit(engines):
    eng, eng_2d = engines
    st = _pack(*_case(seed=1))
    a = eng._pair_force(st, False)
    b = eng_2d._pair_force(st, False)
    assert torch.equal(a.f, b.f)
    a = eng._pair_force(st, True)
    b = eng_2d._pair_force(st, True)
    assert torch.equal(a.f, b.f)
    np.testing.assert_allclose(float(b.potential_energy),
                               float(a.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(b.virial.numpy(), a.virial.numpy(),
                               rtol=1e-5)


def test_2d_repack_bit_identical_to_single_grid(engines):
    """Random sub-cell pushes cross x, y and z cell faces and the corners
    (diagonal hand-offs): the 2-D migration's slots are
    ``repack_incremental``'s, bit for bit."""
    _, eng_2d = engines
    st = _pack(*_case(jitter=0.3))
    rng = np.random.default_rng(3)
    st = st.replace(r=st.r + torch.as_tensor(
        rng.uniform(-1.4, 1.4, tuple(st.r.shape)), dtype=torch.float32))
    ref, bad_ref = repack_incremental(st, SPEC)
    got, bad = eng_2d._sharded_repack(st)
    assert not bool(bad_ref) and not bool(bad)
    for k in ("pid", "slot_of", "r", "image", "v", "f", "typ", "ref_r"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def test_2d_order_parts_match_single_grid(engines):
    """Kernel 2 under the interior mask of each block and kernel 3 with
    its ghost rows dropped (the plain versions here) against the fused
    order path on the global state."""
    _, eng_2d = engines
    st = _pack(*_case(seed=2))
    cvs = [PackedSteinhardtQl(SPEC, r_cut=2.2, name="q6"),
           PackedCoordination(SPEC, r0=1.9, r_cut=2.4, name="co")]
    dVds = torch.tensor([0.8, -0.3])
    ref_v, ref_f = make_fused_order_force(cvs, SPEC)
    got_v, got_f = eng_2d.make_order_parts(cvs)
    s_r, ctx_r = ref_v(st)
    s_g, ctx_g = got_v(st)
    np.testing.assert_allclose(s_g.numpy(), s_r.numpy(), rtol=2e-5)
    g_r = ref_f(st, ctx_r, dVds)
    g_g = got_f(st, ctx_g, dVds)
    np.testing.assert_allclose(g_g.numpy(), g_r.numpy(), rtol=0,
                               atol=2e-5 * float(g_r.abs().max()))


def test_2d_steps_match_single_grid(engines):
    """Five γ-0 Langevin steps (rebuild every step, so migrations run) on
    the 2×2 blocks and on the single grid."""
    out = []
    for engine in engines:
        st = _pack(*_case(seed=4), engine=engine)
        st, aux = engine.init(st)
        step = make_packed_langevin_step(
            lambda s, aux=aux: engine.force_into(s, aux), dt=0.005, kT=1.0,
            gamma=0.0)
        gen = torch.Generator().manual_seed(0)
        for _ in range(5):
            st, aux = engine.rebuild(st, aux)
            st = step(st, gen)
        out.append(st)
    for k in ("r", "v"):
        np.testing.assert_allclose(out[1].__dict__[k].numpy(),
                                   out[0].__dict__[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_2d_walker_batch_matches_walkers_alone():
    """Walkers × 2-D space (``nested=True``): kernel 1 once per block for
    two walkers in boxes of their own, against each walker alone."""
    eng = SpatialPackedEngine2D(SPEC, SHARDS, (2, 2), nested=True)
    a = _pack(*_case(seed=5))
    b = _pack(*_case(seed=6))
    batch = stack_walkers([a, b])
    out = eng._pair_force(batch, True)
    for w, st in enumerate((a, b)):
        one = eng._pair_force(st, True)
        assert torch.equal(walker(out, w).f, one.f)
        np.testing.assert_allclose(
            float(walker(out, w).potential_energy),
            float(one.potential_energy), rtol=1e-6)


def test_2d_refuses_a_tilted_box(engines):
    """Orthorhombic only, as the reference asserts."""
    _, eng_2d = engines
    st = _pack(*_case())
    tilted = st.replace(box=Box.triclinic(L_BOX, L_BOX, L_BOX, "cpu",
                                          0.1, 0.0, 0.0))
    with pytest.raises(ValueError, match="orthorhombic"):
        eng_2d._pair_force(tilted, False)
