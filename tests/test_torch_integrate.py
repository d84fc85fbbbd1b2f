"""The port's packed integrators against the JAX package: one BAOAB step
with the reference's own noise fed in, a γ = 0 step and a velocity-Verlet
step, at atol 1e-5 (f32; the pair forces differ by sum order only)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.integrate import packed as ji
from metadyn_tpu.ops import packed as jp
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.integrate import packed as ti
from metadyn_tpu_torch.ops import packed as tp


# one compiled reference pair force for every test of the file (the steps
# themselves run eagerly: a dozen elementwise ops)
_jforce = jax.jit(jp.packed_lj_force, static_argnums=1)


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case():
    rng = np.random.default_rng(3)
    pos = (fcc_lattice(6, 1.71)
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    n, L = pos.shape[0], 6 * 1.71
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    spec = jp.PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                                shift_energy=False, uniform_sigma=1.0,
                                uniform_eps=1.0)
    jst, ovf = jp.pack_host(pos, JBox.cubic(L), spec, np.zeros(n, np.int32),
                            np.ones(n, np.float32), np.ones(n, np.float32),
                            vel=vel)
    assert not ovf
    jst = _jforce(jst, spec)
    return jst, spec, interop.packed_state_from(jst, "cpu"), \
        interop.packed_spec_from(spec)


def _check(out, jout, spec):
    for k in ("r", "v"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(jout, k)), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the new forces are pair forces of |f| up to ~10 summed in another
    # order: f32 sum-order differences reach ~5e-5 there
    np.testing.assert_allclose(out.f.numpy(), np.asarray(jout.f), rtol=1e-4,
                               atol=1e-4)
    vac = out.pid.numpy() >= spec.n_real
    assert vac.any()
    assert np.all(out.r.numpy()[:, vac] == np.float32(tp.VACANT_X))


@pytest.mark.parametrize("gamma", [1.0, 0.0])
def test_langevin_step_matches_reference(gamma):
    jst, jspec, st, spec = _case()
    key = jax.random.PRNGKey(11)
    jstep = ji.make_packed_langevin_step(
        lambda s: _jforce(s, jspec), dt=0.005, kT=1.0, gamma=gamma)
    jout = jstep(jst, key)
    # the reference draws N(0, 1) from the key inside its step; feed the
    # same numbers to the port's step
    noise = np.array(jax.random.normal(key, jst.v.shape, jnp.float32))
    step = ti.make_packed_langevin_step(
        lambda s: tp.packed_lj_force(s, spec), dt=0.005, kT=1.0, gamma=gamma)
    out = step(st, noise=torch.as_tensor(noise))
    _check(out, jout, spec)
    if gamma == 0.0:
        # no friction: the generator's numbers change nothing
        g = torch.Generator().manual_seed(0)
        again = step(st, g)
        np.testing.assert_array_equal(again.r.numpy(), out.r.numpy())


def test_langevin_step_passes_extras_through():
    """A ``force_fn`` that returns ``(state, extras)`` makes the step return
    ``(state, extras)``, as the reference's does; the state matches the
    reference's step with the same noise."""
    jst, jspec, st, spec = _case()
    key = jax.random.PRNGKey(5)
    jstep = ji.make_packed_langevin_step(
        lambda s: (_jforce(s, jspec), s.r[0, 0]), dt=0.005, kT=1.0)
    jout, jextra = jstep(jst, key)
    noise = np.array(jax.random.normal(key, jst.v.shape, jnp.float32))
    step = ti.make_packed_langevin_step(
        lambda s: (tp.packed_lj_force(s, spec), s.r[0, 0]), dt=0.005, kT=1.0)
    out = step(st, noise=torch.as_tensor(noise))
    assert isinstance(out, tuple) and len(out) == 2
    out, extra = out
    _check(out, jout, spec)
    # the extras are what force_fn returned: the drifted position it saw
    np.testing.assert_allclose(float(extra), float(jextra), rtol=0,
                               atol=1e-5)
    assert float(extra) == float(out.r[0, 0])


def test_nve_step_matches_reference():
    jst, jspec, st, spec = _case()
    jstep = ji.make_packed_nve_step(lambda s: _jforce(s, jspec), dt=0.005)
    jout = jstep(jst, jax.random.PRNGKey(0))
    step = ti.make_packed_nve_step(lambda s: tp.packed_lj_force(s, spec),
                                   dt=0.005)
    _check(step(st), jout, spec)
