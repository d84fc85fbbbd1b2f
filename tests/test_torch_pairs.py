"""The port's particle-order pair and bond forces against the JAX package's,
on the CPU: ``ops/pairs.py`` (the four table builders and the LJ, XPLOR
and soft kernels, ``all_pairs_force``), ``ops/bonds.py`` (harmonic, FENE +
WCA) and ``core/forcefield.ForceField`` with an external potential, whose
force is ``torch.autograd.grad`` against ``jax.grad``.

Inputs come from numpy with a seed: fcc lattices with noise at 256, 500
and 864 particles, orthorhombic and in the tilted box (0.2, −0.12, 0.1).
Tolerances: forces max|Δf| ≤ 1e-4·max|f| + 1e-4, energy and virial rtol
1e-5 (f32 sums in another order); the kernels' per-pair values rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.forcefield import ForceField as JForceField
from metadyn_tpu.core.state import make_state as jmake_state
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.ops import bonds as jbonds
from metadyn_tpu.ops import pairs as jpairs
from metadyn_tpu.utils.lattice import fcc_lattice

from metadyn_tpu_torch import interop
from metadyn_tpu_torch.core.box import minimum_image, unwrap
from metadyn_tpu_torch.core.forcefield import ForceField
from metadyn_tpu_torch.core.state import make_state, make_system
from metadyn_tpu_torch.ops import bonds, pairs

TILT = (0.2, -0.12, 0.1)

from tests.test_torch_cli import torch_threads


@pytest.fixture(autouse=True)
def _torch_threads():
    with torch_threads():
        yield


def boxes(L: float, tilted: bool):
    if tilted:
        return (JBox.triclinic(L, L, L, *TILT),
                interop.box_from(JBox.triclinic(L, L, L, *TILT), "cpu"))
    return JBox.cubic(L), interop.box_from(JBox.cubic(L), "cpu")


def lattice(n_cells: int, a: float = 1.6, noise: float = 0.05, seed: int = 0):
    rng = np.random.default_rng(seed)
    pos = fcc_lattice(n_cells, a) + rng.normal(0.0, noise,
                                               (4 * n_cells ** 3, 3))
    return pos.astype(np.float32), n_cells * a


def close_forces(f_port, f_ref):
    f_port, f_ref = np.asarray(f_port), np.asarray(f_ref)
    tol = 1e-4 * np.abs(f_ref).max() + 1e-4
    assert np.abs(f_port - f_ref).max() <= tol, np.abs(f_port - f_ref).max()


TABLES = {
    "lj": (dict(epsilon=[[1.0, 0.6], [0.6, 1.2]], sigma=[[1.0, 1.1],
                                                         [1.1, 0.9]],
                r_cut=2.5), "lj"),
    "lj_noshift": (dict(r_cut=2.0, shift=False), "lj"),
    "xplor": (dict(epsilon=1.0, sigma=1.0, r_cut=2.5, r_on=2.0), "xplor"),
    "wca": (dict(epsilon=[[1.0, 0.5], [0.5, 1.5]], sigma=1.0), "wca"),
    "soft": (dict(A=[[25.0, 40.0], [40.0, 25.0]], r_cut=1.0), "soft"),
}


def build_tables(case: str, device="cpu"):
    kw, kind = TABLES[case]
    jfn = {"lj": jpairs.lj_tables, "xplor": jpairs.xplor_tables,
           "wca": jpairs.wca_tables, "soft": jpairs.soft_tables}[kind]
    tfn = {"lj": pairs.lj_tables, "xplor": pairs.xplor_tables,
           "wca": pairs.wca_tables, "soft": pairs.soft_tables}[kind]
    jk = jpairs.soft_kernel if kind == "soft" else jpairs.lj_kernel
    tk = pairs.soft_kernel if kind == "soft" else pairs.lj_kernel
    return jfn(2, **kw), tfn(2, device=device, **kw), jk, tk


@pytest.mark.parametrize("case", sorted(TABLES))
def test_tables_and_kernel_match_reference(case):
    jp, tp, jk, tk = build_tables(case)
    for f in ("epsilon", "sigma", "r_cut", "shift_const", "r_on"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    rng = np.random.default_rng(1)
    r2 = rng.uniform(0.0, 8.0, 4000).astype(np.float32)
    r2[:5] = 0.0                       # self pairs: masked, finite
    ti = rng.integers(0, 2, 4000).astype(np.int32)
    tj = rng.integers(0, 2, 4000).astype(np.int32)
    e_ref, c_ref = jk(jnp.asarray(r2), jnp.asarray(ti), jnp.asarray(tj), jp)
    e, c = tk(torch.as_tensor(r2), torch.as_tensor(ti), torch.as_tensor(tj),
              interop.pair_params_from(jp, "cpu"))
    assert torch.isfinite(e).all() and torch.isfinite(c).all()
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_cells,tilted,case", [
    (4, False, "lj"), (5, True, "lj"), (6, False, "xplor"),
    (5, False, "wca"), (4, True, "soft")])
def test_all_pairs_force_matches_reference(n_cells, tilted, case):
    pos, L = lattice(n_cells, a=1.55 if case != "soft" else 1.0)
    n = pos.shape[0]
    jbox, tbox = boxes(L, tilted)
    types = np.random.default_rng(2).integers(0, 2, n).astype(np.int32)
    jp, tp, jk, tk = build_tables(case)
    ref = jax.jit(jpairs.all_pairs_force, static_argnums=(3, 5))(
        jnp.asarray(pos), jnp.asarray(types), jbox, jk, jp, 128)
    tpos = torch.as_tensor(pos)
    got = {rb: pairs.all_pairs_force(tpos, torch.as_tensor(types), tbox, tk,
                                     tp, row_block=rb)
           for rb in (97, 1024)}
    for res in got.values():
        close_forces(res.force, ref.force)
        np.testing.assert_allclose(float(res.energy), float(ref.energy),
                                   rtol=1e-5)
        np.testing.assert_allclose(res.virial.numpy(), np.asarray(ref.virial),
                                   rtol=1e-5)
    # the row block changes nothing but the summation order
    close_forces(got[97].force, got[1024].force)


@pytest.mark.parametrize("tilted", [False, True])
def test_minimum_image_and_unwrap_match_reference(tilted):
    from metadyn_tpu.core import box as jbox_mod
    jbox, tbox = boxes(7.0, tilted)
    rng = np.random.default_rng(3)
    dr = rng.uniform(-12.0, 12.0, (500, 3)).astype(np.float32)
    image = rng.integers(-3, 4, (500, 3)).astype(np.int32)
    np.testing.assert_allclose(
        minimum_image(torch.as_tensor(dr), tbox).numpy(),
        np.asarray(jbox_mod.minimum_image(jnp.asarray(dr), jbox)),
        atol=1e-5)
    np.testing.assert_allclose(
        unwrap(torch.as_tensor(dr), torch.as_tensor(image), tbox).numpy(),
        np.asarray(jbox_mod.unwrap(jnp.asarray(dr), jnp.asarray(image),
                                   jbox)),
        rtol=1e-6, atol=1e-5)


def chain_bonds(n: int, chain: int = 16) -> np.ndarray:
    return np.asarray([[c * chain + i, c * chain + i + 1]
                       for c in range(n // chain) for i in range(chain - 1)],
                      np.int32)


@pytest.mark.parametrize("kind", ["harmonic", "fene"])
def test_bond_forces_match_reference(kind):
    rng = np.random.default_rng(4)
    n, L = 256, 8.0
    # random-walk chains of 16 with bond lengths 0.8-1.2, wrapped
    steps = rng.normal(size=(n, 3))
    steps *= rng.uniform(0.8, 1.2, (n, 1)) / np.linalg.norm(steps, axis=1,
                                                            keepdims=True)
    pos = np.cumsum(steps.reshape(16, 16, 3), axis=1).reshape(n, 3)
    pos = (pos + rng.uniform(-L / 2, L / 2, (16, 1, 3)).repeat(16, 1)
           .reshape(n, 3)).astype(np.float32)
    b = chain_bonds(n)
    btypes = (np.arange(b.shape[0]) % 2).astype(np.int32)
    jbox, tbox = boxes(L, False)
    if kind == "harmonic":
        jpar = jbonds.HarmonicBondParams(k=jnp.asarray([300.0, 200.0]),
                                         r0=jnp.asarray([1.0, 0.9]))
        tpar = bonds.HarmonicBondParams(k=torch.tensor([300.0, 200.0]),
                                        r0=torch.tensor([1.0, 0.9]))
        jfn, tfn = jbonds.harmonic_bond_force, bonds.harmonic_bond_force
    else:
        jpar = jbonds.FENEBondParams(
            k=jnp.asarray([30.0, 25.0]), r0=jnp.asarray([1.5, 1.6]),
            epsilon=jnp.asarray([1.0, 1.2]), sigma=jnp.asarray([1.0, 0.9]))
        tpar = bonds.FENEBondParams(
            k=torch.tensor([30.0, 25.0]), r0=torch.tensor([1.5, 1.6]),
            epsilon=torch.tensor([1.0, 1.2]), sigma=torch.tensor([1.0, 0.9]))
        jfn, tfn = jbonds.fene_bond_force, bonds.fene_bond_force
    ref = jfn(jnp.asarray(pos), jnp.asarray(b), jnp.asarray(btypes), jbox,
              jpar)
    got = tfn(torch.as_tensor(pos), torch.as_tensor(b),
              torch.as_tensor(btypes), tbox, tpar)
    close_forces(got.force, ref.force)
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(got.virial.numpy(), np.asarray(ref.virial),
                               rtol=1e-5, atol=1e-4)


def test_forcefield_external_force_matches_jax_grad():
    """Pair + FENE + an external field: the external force is autograd's
    −∇E against ``jax.grad``'s, and the totals agree."""
    pos, L = lattice(4, a=1.6, noise=0.05, seed=5)
    n = pos.shape[0]
    b = chain_bonds(n)

    def ext_j(p, state, system):
        return jnp.sum(0.3 * jnp.sin(p[:, 0]) ** 2 + 0.1 * p[:, 2] ** 2)

    def ext_t(p, state, system):
        return torch.sum(0.3 * torch.sin(p[:, 0]) ** 2 + 0.1 * p[:, 2] ** 2)

    jp, tp, jk, tk = build_tables("lj")
    fene = dict(k=[30.0], r0=[1.5], epsilon=[1.0], sigma=[1.0])
    jff = JForceField(pair_params=jp, pair_kernel=jk, row_block=100,
                      fene=jbonds.FENEBondParams(
                          **{k: jnp.asarray(v) for k, v in fene.items()}),
                      external=ext_j)
    tff = ForceField(pair_params=tp, pair_kernel=tk, row_block=100,
                     fene=bonds.FENEBondParams(
                         **{k: torch.tensor(v) for k, v in fene.items()}),
                     external=ext_t, device="cpu")
    types = (np.arange(n) % 2).astype(np.int32)
    jsys = jmake_system(n, types=types, bonds=b)
    tsys = make_system(n, "cpu", types=types, bonds=b)
    ref = jff.bind(jsys)(jmake_state(pos, JBox.cubic(L)))
    got = tff.bind(tsys)(make_state(pos, interop.box_from(JBox.cubic(L),
                                                          "cpu"),
                                    device="cpu"))
    close_forces(got.force, ref.force)
    np.testing.assert_allclose(float(got.potential_energy),
                               float(ref.potential_energy), rtol=1e-5)
    np.testing.assert_allclose(got.virial.numpy(), np.asarray(ref.virial),
                               rtol=1e-5)
    # the external part alone against jax.grad
    g_ref = jax.grad(lambda p: ext_j(p, None, None))(jnp.asarray(pos))
    ext_only = ForceField(external=ext_t, device="cpu").bind(tsys)(
        make_state(pos, interop.box_from(JBox.cubic(L), "cpu"),
                   device="cpu"))
    close_forces(ext_only.force, -np.asarray(g_ref))


def test_cuda_default_raises_without_cuda():
    """The new entry points default to CUDA and raise without it: no CPU
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks its absence")
    from metadyn_tpu_torch.core.engine import AllPairsEngine
    box = interop.box_from(JBox.cubic(5.0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_state(np.zeros((4, 3), np.float32), box)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ForceField().bind(make_system(4, "cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AllPairsEngine(make_system(4, "cpu"))
