"""The port's particle-order integrators against the JAX package's, on the
CPU: BAOAB Langevin, velocity-Verlet NVE, Nosé–Hoover and BDP velocity
rescaling, 20 steps each on 256 LJ particles (fcc plus noise, all-pairs
forces, a thermal start).  Each JAX step's normals are drawn in the test
from that step's key, exactly as the JAX step draws them (Langevin: one
(N, 3) normal; BDP: two scalars from the split key), and injected into the
port's step, so both packages integrate the same trajectory.  Positions
and velocities atol 1e-5 after 20 steps, ξ rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.engine import AllPairsEngine as JAllPairs
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.integrate import langevin as jlangevin
from metadyn_tpu.integrate import nvt as jnvt
from metadyn_tpu.ops.pairs import lj_kernel as jlj_kernel
from metadyn_tpu.ops.pairs import lj_tables as jlj_tables
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.engine import AllPairsEngine
from metadyn_tpu_torch.core.state import make_state, make_system
from metadyn_tpu_torch.integrate import langevin, nvt
from metadyn_tpu_torch.ops.pairs import lj_kernel, lj_tables

N_STEPS = 20

from tests.test_torch_cli import torch_threads


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def start():
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(4, 1.6) + rng.normal(0.0, 0.03, (256, 3))
           ).astype(np.float32)
    vel = rng.normal(0.0, 1.0, (256, 3)).astype(np.float32)
    return pos, vel - vel.mean(0), 4 * 1.6


def jax_normals(kind, key, shape):
    """The normals the JAX step draws from ``key``."""
    if kind == "langevin":
        return np.array(jax.random.normal(key, shape, jnp.float32))
    if kind == "nvt_bdp":
        k1, k2 = jax.random.split(key)
        return np.asarray([jax.random.normal(k1, ()),
                           jax.random.normal(k2, ())], np.float32)
    return None


FACTORIES = {
    "langevin": (lambda f, s: jlangevin.make_langevin_step(
                     f, s, dt=0.005, kT=1.0, gamma=1.0),
                 lambda f, s: langevin.make_langevin_step(
                     f, s, dt=0.005, kT=1.0, gamma=1.0)),
    "nve": (lambda f, s: jlangevin.make_nve_step(f, s, dt=0.005),
            lambda f, s: langevin.make_nve_step(f, s, dt=0.005)),
    "nvt_nh": (lambda f, s: jnvt.make_nvt_nh_step(f, s, dt=0.005, kT=1.2,
                                                  tau=0.5),
               lambda f, s: nvt.make_nvt_nh_step(f, s, dt=0.005, kT=1.2,
                                                 tau=0.5)),
    "nvt_bdp": (lambda f, s: jnvt.make_nvt_bdp_step(f, s, dt=0.005, kT=1.2,
                                                    tau=0.5),
                lambda f, s: nvt.make_nvt_bdp_step(f, s, dt=0.005, kT=1.2,
                                                   tau=0.5)),
}


@pytest.mark.parametrize("kind", sorted(FACTORIES))
def test_integrator_matches_reference_with_injected_noise(kind):
    pos, vel, L = start()
    n = pos.shape[0]
    jsys, tsys = jmake_system(n), make_system(n, "cpu")
    jeng = JAllPairs(jsys, pair_params=jlj_tables(1, r_cut=2.5),
                     pair_kernel=jlj_kernel, row_block=256)
    teng = AllPairsEngine(tsys, pair_params=lj_tables(1, r_cut=2.5,
                                                      device="cpu"),
                          pair_kernel=lj_kernel, row_block=256, device="cpu")
    jst, jaux = jeng.init(jmake_state(pos, JBox.cubic(L), vel=vel))
    tst, taux = teng.init(make_state(pos, interop.box_from(JBox.cubic(L),
                                                           "cpu"),
                                     vel=vel, device="cpu"))
    jfac, tfac = FACTORIES[kind]
    jstep = jax.jit(jfac(lambda s: jeng.force_into(s, jaux), jsys))
    tstep = tfac(lambda s: teng.force_into(s, taux), tsys)
    key = jax.random.PRNGKey(3)
    for i in range(N_STEPS):
        k = jax.random.fold_in(key, i)
        noise = jax_normals(kind, k, (n, 3))
        jst = jstep(jst, k)
        tst = tstep(tst, noise=None if noise is None
                    else torch.as_tensor(noise))
    ref = interop.state_arrays(interop.state_from(jst, "cpu"))
    np.testing.assert_allclose(tst.pos.numpy(), ref["pos"], atol=1e-5)
    np.testing.assert_allclose(tst.vel.numpy(), ref["vel"], atol=1e-5)
    np.testing.assert_array_equal(tst.image.numpy(), ref["image"])
    np.testing.assert_allclose(float(tst.xi), float(ref["xi"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(tst.potential_energy),
                               float(ref["potential_energy"]), rtol=1e-5)
