"""The port's cell list, neighbour list and neighbour engine against the JAX
package's, on the CPU, on the inputs of tests/test_neighbor.py.

Held: every row's neighbour set equal to the reference's; the overflow
flag identical (fits, the dense corner with generous capacities, tiny
capacities, an overflowing cluster whose far rows stay intact); the
exclusions; the half-skin trigger; ``neighbor_pair_force`` against the
reference's all-pairs force (max|Δf| ≤ 1e-4·max|f| + 1e-4, energy and
virial rtol 1e-5); and, within the port, a 50-step Langevin run on
``NeighborEngine`` against ``AllPairsEngine`` from one generator seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.ops import cell_list as jcl
from metadyn_tpu.ops.pairs import all_pairs_force as jall_pairs
from metadyn_tpu.ops.pairs import lj_kernel as jlj_kernel
from metadyn_tpu.ops.pairs import lj_tables as jlj_tables
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.engine import (
    AllPairsEngine, NeighborEngine, run_md_blocks,
)
from metadyn_tpu_torch.core.state import (
    make_state, make_system, thermal_velocities,
)
from metadyn_tpu_torch.integrate.langevin import make_langevin_step
from metadyn_tpu_torch.ops.cell_list import (
    CellSpec, build_neighbor_list, exclusions_from_bonds, needs_rebuild,
)
from metadyn_tpu_torch.ops.neighbor_force import neighbor_pair_force
from metadyn_tpu_torch.ops.pairs import lj_kernel, lj_tables

from tests.test_torch_cli import torch_threads


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


# the reference's functions jitted: one compile each beats eager JAX's
# compile per op
jbuild = jax.jit(jcl.build_neighbor_list, static_argnums=(2,))
jall_pairs_jit = jax.jit(jall_pairs, static_argnums=(3, 5))


def random_config(n, L, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-L / 2, L / 2, (n, 3)).astype(np.float32)


def both_lists(pos, L, spec_kw, exclusions=None):
    """(reference list, port list) of the same positions and sizing."""
    jbox = JBox.cubic(L)
    jspec = jcl.CellSpec.create(L, pos.shape[0], **spec_kw)
    spec = CellSpec.create(L, pos.shape[0], **spec_kw)
    assert interop.cell_spec_from(jspec) == spec
    ref = jbuild(
        jnp.asarray(pos), jbox, jspec,
        None if exclusions is None else jnp.asarray(exclusions))
    got = build_neighbor_list(
        torch.as_tensor(pos), interop.box_from(jbox, "cpu"), spec,
        None if exclusions is None else torch.as_tensor(
            np.array(exclusions)))
    return ref, got


def row_sets(idx, n):
    idx = np.asarray(idx)
    return [set(r[r < n].tolist()) for r in idx]


def same_lists(ref, got, n, rows=None):
    a, b = row_sets(ref.idx, n), row_sets(got.idx.numpy(), n)
    for i in (range(n) if rows is None else rows):
        assert a[i] == b[i], i
    assert bool(ref.overflow) == bool(got.overflow)


@pytest.mark.parametrize("n,L,seed", [(200, 7.0, 0), (500, 9.0, 1),
                                      (911, 11.0, 2)])
def test_neighbor_list_and_force_match_reference(n, L, seed):
    pos = random_config(n, L, seed)
    ref, got = both_lists(pos, L, dict(r_cut=2.5, skin=0.4))
    same_lists(ref, got, n)
    assert not bool(got.overflow)
    types = np.zeros(n, np.int32)
    ap = jall_pairs_jit(jnp.asarray(pos), jnp.asarray(types),
                        JBox.cubic(L), jlj_kernel, jlj_tables(1, r_cut=2.5),
                        128)
    res = neighbor_pair_force(torch.as_tensor(pos), torch.as_tensor(types),
                              interop.box_from(JBox.cubic(L), "cpu"), got,
                              lj_kernel, lj_tables(1, r_cut=2.5,
                                                   device="cpu"))
    f_ref = np.asarray(ap.force)
    tol = 1e-4 * np.abs(f_ref).max() + 1e-4
    assert np.abs(res.force.numpy() - f_ref).max() <= tol
    np.testing.assert_allclose(float(res.energy), float(ap.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(res.virial.numpy(), np.asarray(ap.virial),
                               rtol=1e-5)


def test_dense_corner_and_tiny_capacities_flag_as_reference():
    """All particles in one corner with generous capacities (no overflow),
    then tiny capacities (overflow): the same sets and flags."""
    rng = np.random.default_rng(3)
    n, L = 256, 12.0
    pos = (rng.uniform(0, 2.0, (n, 3)) + L / 2 - 2.0).astype(np.float32)
    ref, got = both_lists(pos, L, dict(r_cut=2.0, skin=0.3,
                                       cell_capacity=256, max_neighbors=256))
    same_lists(ref, got, n)
    assert not bool(got.overflow)
    pos = random_config(300, 6.0, 4)
    ref, got = both_lists(pos, 6.0, dict(r_cut=2.5, skin=0.3,
                                         cell_capacity=2, max_neighbors=8))
    assert bool(ref.overflow) and bool(got.overflow)


def test_overflow_is_confined_to_its_cell():
    """A cluster overflows cap 4: rows far from it keep the same sets as
    the reference's (the drop slot evicts no other cell's particle)."""
    L = 12.0
    rng = np.random.default_rng(11)
    a = (rng.uniform(0.0, 0.8, (12, 3)) - L / 2 + 0.5).astype(np.float32)
    g = np.arange(3) * 2.0
    b = (np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
         + L / 2 - 5.5).astype(np.float32)
    b += rng.uniform(-0.2, 0.2, b.shape).astype(np.float32)
    pos = np.concatenate([a, b])
    n = pos.shape[0]
    kw = dict(r_cut=2.0, skin=0.4, max_neighbors=40)
    ref_lo, got_lo = both_lists(pos, L, dict(kw, cell_capacity=4))
    _, got_hi = both_lists(pos, L, dict(kw, cell_capacity=16))
    assert bool(got_lo.overflow) and not bool(got_hi.overflow)
    same_lists(ref_lo, got_lo, n)
    far = range(12, n)
    lo, hi = row_sets(got_lo.idx.numpy(), n), row_sets(got_hi.idx.numpy(), n)
    assert all(lo[i] == hi[i] for i in far
               if not (hi[i] & set(range(12))))


def test_exclusions_match_reference():
    n, L = 64, 10.0
    pos = random_config(n, L, 6)
    bonds = np.asarray([[0, 1], [1, 2], [10, 20]], np.int32)
    jex = np.asarray(jcl.exclusions_from_bonds(bonds, n))
    ex = exclusions_from_bonds(bonds, n, device="cpu")
    np.testing.assert_array_equal(ex.numpy(), jex)
    ref, got = both_lists(pos, L, dict(r_cut=3.0, skin=0.5, max_neighbors=n),
                          exclusions=jex)
    same_lists(ref, got, n)
    sets = row_sets(got.idx.numpy(), n)
    for a, b in bonds:
        assert b not in sets[a] and a not in sets[b]


def test_rebuild_trigger_matches_reference():
    pos = random_config(100, 8.0, 5)
    ref, got = both_lists(pos, 8.0, dict(r_cut=2.0, skin=0.4))
    box = interop.box_from(JBox.cubic(8.0), "cpu")
    moved = pos.copy()
    moved[7, 0] += 0.21                               # > skin/2
    for p in (pos, moved, pos + np.float32([0.19, 0.0, 0.0])):
        want = bool(jcl.needs_rebuild(ref, jnp.asarray(p), JBox.cubic(8.0)))
        assert bool(needs_rebuild(got, torch.as_tensor(p), box)) == want
    assert bool(needs_rebuild(got, torch.as_tensor(moved), box))


def test_neighbor_engine_matches_all_pairs_engine():
    """50 Langevin steps, rebuild every 5, on both port engines from one
    state and one generator seed: positions and velocities agree, and the
    neighbour engine's sticky flags stay down."""
    pos = fcc_lattice(4, 1.6)
    L = 4 * 1.6
    n = pos.shape[0]
    system = make_system(n, "cpu")
    params = lj_tables(1, r_cut=2.0, device="cpu")
    box = interop.box_from(JBox.cubic(L), "cpu")
    g = torch.Generator().manual_seed(7)
    state0 = make_state(pos, box, vel=thermal_velocities(
        g, system.mass, 0.8).numpy(), device="cpu")
    engines = (
        AllPairsEngine(system, pair_params=params, pair_kernel=lj_kernel,
                       row_block=256, device="cpu"),
        NeighborEngine(system, CellSpec.create(L, n, r_cut=2.0, skin=0.6),
                       params, lj_kernel, rebuild_every=5, device="cpu"))
    out = []
    for eng in engines:
        st, aux = eng.init(state0)
        st, aux = run_md_blocks(
            eng, lambda f: make_langevin_step(f, system, 0.004, 0.8, 1.0),
            st, aux, torch.Generator().manual_seed(42), 50)
        out.append((st, aux))
    (a, _), (b, aux_nb) = out
    assert not bool(aux_nb.overflow) and not bool(aux_nb.stale)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-3)
    np.testing.assert_allclose(float(a.potential_energy),
                               float(b.potential_energy), rtol=1e-5)
