"""SCR-NPT on the port against the JAX package: the packed step
(``integrate/packed.make_packed_npt_scr_step``) and the particle-order step
(``integrate/npt.make_npt_scr_step``), with the reference's own draws
injected: its key split as its step splits it, ``normal(k_noise)`` for the
particles and ``normal(k_baro)`` for the barostat.

The packed cases start from fcc 6³ at a 1.6 (864 particles, L 9.6, r_cut
2, skin 0.3, cap 24: 4³ cells) plus noise from a numpy seed, with the
plain pair force (energy and virial on every call) in both packages, both
starting from the port's forces: one step isotropic, anisotropic and
anisotropic with the box-bias of an aspect-ratio CV on a grid holding
hills (one reference compile for the two anisotropic cases, the grid's
V and dV its arguments, zeros for no bias; positions, velocities and the
box rtol 1e-5, atol 1e-6), and 20 isotropic steps (the box rtol 1e-4,
positions atol 1e-3).  The particle-order case: fcc 4³ (256 particles) on
the all-pairs engine, 10 isotropic steps.

Then what the moving box must not break: vacant slots of the sentinel
layout stay at VACANT_X after a rescale; a force call after a rescale
computes in the new box (the same force as in a fresh box of those
lengths); the moved box has no host floats (reading them raises); the
engine's repack check refuses a box shrunk below the cell grid's r_list.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.bias import grid as jgrid
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.engine import AllPairsEngine as JAllPairs
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.aspect_ratio import AspectRatio as JAspect
from metadyn_tpu.cv.aspect_ratio import box_bias_fn_for as jbox_bias_fn_for
from metadyn_tpu.integrate import npt as jnpt
from metadyn_tpu.integrate import packed as jintp
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.ops.pairs import lj_kernel as jlj_kernel
from metadyn_tpu.ops.pairs import lj_tables as jlj_tables
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.bias.grid import BiasGrid, GridSpec
from metadyn_tpu_torch.bias.metad import BiasState
from metadyn_tpu_torch.core.box import Box, MovedBoxError
from metadyn_tpu_torch.core.engine import AllPairsEngine
from metadyn_tpu_torch.core.packed_engine import PackedEngine
from metadyn_tpu_torch.core.state import make_state, make_system
from metadyn_tpu_torch.cv.aspect_ratio import AspectRatio, box_bias_fn_for
from metadyn_tpu_torch.integrate.npt import make_npt_scr_step
from metadyn_tpu_torch.integrate.packed import make_packed_npt_scr_step
from metadyn_tpu_torch.ops.packed import (
    VACANT_X, packed_lj_force, unpack_positions,
)
from metadyn_tpu_torch.ops.pairs import lj_kernel, lj_tables

from tests.test_torch_cli import torch_threads

A_LAT, N_CELLS = 1.6, 6
L = N_CELLS * A_LAT
KW = dict(dt=0.002, kT=1.2, pressure=1.0, gamma=2.0, tau_p=1.0)


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


@functools.lru_cache(maxsize=2)
def packed_start(sentinel: bool = False):
    """(reference state, port state, both specs) of the fcc start (made
    once per layout: every use steps it functionally)."""
    pos = fcc_lattice(N_CELLS, A_LAT)
    n = pos.shape[0]
    rng = np.random.default_rng(4)
    pos = (pos + rng.normal(0.0, 0.03, pos.shape)).astype(np.float32)
    vel = rng.normal(0.0, np.sqrt(1.2), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    jspec = jp.PackedSpec.create(L, n, r_cut=2.0, skin=0.3, cap=24, **kw)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), jspec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            vel=vel)
    assert not bool(ovf)
    spec = interop.packed_spec_from(jspec)
    st = packed_lj_force(interop.packed_state_from(jst, "cpu"), spec)
    # the reference's forces where a test steps the reference too
    return jst, st, jspec, spec


@functools.lru_cache(maxsize=2)
def jax_step(anisotropic: bool):
    """The reference's start with the port's forces, energy and virial (the
    same inputs to both first steps), and its jitted packed SCR step
    ``step(state, key, V, dV)``, compiled once per mode: anisotropic with
    the box bias of the aspect-ratio grid (V, dV) (zeros: no bias, as
    without a box_bias_fn), so both anisotropic cases share one compile."""
    jst, st, jspec, _ = packed_start()
    jst = jst.replace(f=jnp.asarray(st.f.numpy()),
                      virial=jnp.asarray(st.virial.numpy()),
                      potential_energy=jnp.asarray(
                          st.potential_energy.numpy()))
    jg, _ = aspect_bias()

    def force(s):
        return jp.packed_lj_force(s, jspec)

    def step(s, k, V, dV):
        jfn = None
        if anisotropic:
            class _JBias:
                grid = jg.replace(V=V, dV=dV)
            jfn = jbox_bias_fn_for(JAspect(), _JBias)
        return jintp.make_packed_npt_scr_step(
            force, jspec, anisotropic=anisotropic, box_bias_fn=jfn,
            **KW)(s, k)

    return jst, jax.jit(step)


def aspect_bias():
    """A grid over the aspect ratio holding three hills, in both
    packages."""
    jspec = jgrid.GridSpec.create([0.8], [1.2], [41], [0.02])
    g = jgrid.BiasGrid.zeros(jspec)
    for c, h in ((0.99, 0.3), (1.0, 0.5), (1.02, 0.2)):
        g = jgrid.deposit_hill(g, jnp.asarray([c]), jnp.float32(h))
    spec = GridSpec.create([0.8], [1.2], [41], [0.02], "cpu")
    grid = BiasGrid(spec=spec, V=torch.as_tensor(np.array(g.V)),
                    dV=torch.as_tensor(np.array(g.dV)))
    return g, BiasState(grid=grid, n_hills=torch.tensor(3))


def draws(key, shape, anisotropic: bool):
    """The reference step's draws from ``key``: the particles' normals and
    the barostat's g, as torch tensors."""
    k_noise, k_baro = jax.random.split(key)
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    g = np.array(jax.random.normal(k_baro, (3,) if anisotropic else (),
                                   jnp.float32))
    return torch.as_tensor(noise), torch.as_tensor(g)


def packed_steps(case: str, n_steps: int):
    _, st, jspec, spec = packed_start()
    aniso = case != "isotropic"
    jst, jstep = jax_step(aniso)
    jg, bias = aspect_bias()
    V, dV = ((jg.V, jg.dV) if case == "box_bias"
             else (jnp.zeros_like(jg.V), jnp.zeros_like(jg.dV)))
    fn = box_bias_fn_for(AspectRatio(), bias) if case == "box_bias" else None
    step = make_packed_npt_scr_step(
        lambda s: packed_lj_force(s, spec, with_energy=True), spec,
        anisotropic=aniso, box_bias_fn=fn, **KW)
    key = jax.random.PRNGKey(7)
    for i in range(n_steps):
        k = jax.random.fold_in(key, i)
        noise, g = draws(k, st.r.shape, aniso)
        jst = jstep(jst, k, V, dV)
        st = step(st, noise=noise, baro_noise=g)
    return jst, st, jspec, spec


@pytest.mark.parametrize("case", ["isotropic", "anisotropic", "box_bias"])
def test_packed_npt_step_matches_reference(case):
    jst, st, jspec, spec = packed_steps(case, 1)
    ref = interop.packed_state_arrays(interop.packed_state_from(jst, "cpu"))
    np.testing.assert_allclose(st.box.L.numpy(), ref["box"]["L"], rtol=1e-5,
                               atol=1e-6)
    assert float((st.box.L - L).abs().max()) > 0.0
    np.testing.assert_allclose(st.r.numpy(), ref["r"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.v.numpy(), ref["v"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.ref_r.numpy(), ref["ref_r"], rtol=1e-5,
                               atol=1e-6)


def test_packed_npt_20_steps_match_reference():
    jst, st, jspec, spec = packed_steps("isotropic", 20)
    np.testing.assert_allclose(st.box.L.numpy(), np.asarray(jst.box.L),
                               rtol=1e-4)
    np.testing.assert_allclose(unpack_positions(st, spec).numpy(),
                               np.asarray(jp.unpack_positions(jst, jspec)),
                               atol=1e-3)


def test_particle_npt_matches_reference():
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(4, 1.6) + rng.normal(0.0, 0.03, (256, 3))
           ).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (256, 3)).astype(np.float32)
    vel -= vel.mean(0)
    Lp = 4 * 1.6
    n = pos.shape[0]
    jsys, tsys = jmake_system(n), make_system(n, "cpu")
    jeng = JAllPairs(jsys, pair_params=jlj_tables(1, r_cut=2.5),
                     pair_kernel=jlj_kernel, row_block=256)
    teng = AllPairsEngine(tsys, pair_params=lj_tables(1, r_cut=2.5,
                                                      device="cpu"),
                          pair_kernel=lj_kernel, row_block=256, device="cpu")
    jst, jaux = jeng.init(jmake_state(pos, JBox.cubic(Lp), vel=vel))
    tst, taux = teng.init(make_state(pos, Box.cubic(Lp, "cpu"), vel=vel,
                                     device="cpu"))
    jstep = jax.jit(jnpt.make_npt_scr_step(
        lambda s: jeng.force_into(s, jaux), jsys, **KW))
    tstep = make_npt_scr_step(lambda s: teng.force_into(s, taux), tsys, **KW)
    key = jax.random.PRNGKey(3)
    for i in range(10):
        k = jax.random.fold_in(key, i)
        noise, g = draws(k, (n, 3), False)
        jst = jstep(jst, k)
        tst = tstep(tst, noise=noise, baro_noise=g)
    np.testing.assert_allclose(tst.box.L.numpy(), np.asarray(jst.box.L),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=1e-5)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel),
                               atol=1e-5)
    np.testing.assert_array_equal(tst.image.numpy(), np.asarray(jst.image))


def _moved():
    """(state after one isotropic packed step, spec) in the sentinel
    layout."""
    _, st, _, spec = packed_start(sentinel=True)
    step = make_packed_npt_scr_step(
        lambda s: packed_lj_force(s, spec, with_energy=True), spec, **KW)
    gen = torch.Generator().manual_seed(0)
    return step(st, generator=gen), spec


def test_vacant_slots_stay_at_the_sentinel():
    st, spec = _moved()
    vacant = st.pid >= spec.n_real
    assert bool(vacant.any())
    assert bool((st.r[:, vacant] == VACANT_X).all())
    assert bool((st.ref_r[:, vacant] == VACANT_X).all())


def test_force_after_a_rescale_uses_the_new_box():
    st, spec = _moved()
    fresh = Box.from_lengths(*st.box.L.tolist(), "cpu")
    a = packed_lj_force(st, spec)
    b = packed_lj_force(st.replace(box=fresh), spec)
    assert torch.equal(a.f, b.f)
    assert torch.equal(a.virial, b.virial)
    c = packed_lj_force(st.replace(box=Box.cubic(L, "cpu")), spec)
    assert not torch.equal(a.f, c.f)


def test_moved_box_has_no_host_floats():
    st, _ = _moved()
    assert not st.box.fixed
    for read in (lambda b: b.L_host, lambda b: b.h_host(),
                 lambda b: b.perpendicular_widths_host()):
        with pytest.raises(MovedBoxError):
            read(st.box)
    torch.testing.assert_close(st.box.h[:3], st.box.L, rtol=0, atol=0)


def test_engine_refuses_a_box_below_the_cell_grid():
    _, st, _, spec = packed_start()
    engine = PackedEngine(spec, "cpu", with_energy=True)
    # 4 cells of 9.6 · 0.9 / 4 = 2.16 against r_list 2.3
    st = st.replace(box=Box.cubic(L, "cpu").rescaled(torch.tensor(0.9)))
    with pytest.raises(RuntimeError, match="cell_width_violation"):
        engine.rebuild(st, engine.init(st)[1])
