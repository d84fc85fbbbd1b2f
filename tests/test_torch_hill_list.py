"""The port's hill-list bias (``metadyn_tpu_torch/bias/hill_list.py``) and
the sampler's hill-list mode, on the CPU.

Against the JAX package's ``metadyn_tpu/bias/hill_list.py`` on the same
hills (centres from a seed): ``value_and_grad``, ``deposit`` (buffer,
count, overflow flag), the spill grid and ``evaluate_on_grid``, rtol 1e-5
(f32 sums in another order).  The sampler in list mode against grid mode
on the same hill sequence (the reference's ``tests/test_sampler.py:202``
pattern: V at the grid points against the analytic sum, atol 5e-3, the
well-tempered heights rtol 2e-3), a short run of the packed engine in
list mode (the buffer, the hill log and the spill), and the CLI's list
mode with its walls.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.bias import hill_list as jhl
from metadyn_tpu.bias.grid import GridSpec as JGridSpec

from metadyn_tpu_torch import interop
from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedEngine, PackedLamellar,
    PackedSpec, WELL_TEMPERED, fcc_lattice, make_packed_langevin_step,
    make_system,
)
from metadyn_tpu_torch.bias import hill_list as hl
from metadyn_tpu_torch.bias.metad import BiasState, deposit
from metadyn_tpu_torch.io.hill_log import read_hills


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SIGMA = [0.1, 0.2]


def _spill_specs():
    args = ([-1.5, -2.0], [1.5, 2.0], [31, 41], SIGMA)
    return GridSpec.create(*args, "cpu"), JGridSpec.create(*args)


@pytest.mark.parametrize("spill", [False, True], ids=["drop", "spill"])
def test_hill_list_matches_reference(spill):
    """Eight hills into a buffer of five: V and ∂V/∂s at probe points after
    every deposit, the count and the flag, and the reconstruction."""
    spec, jspec = _spill_specs()
    b = hl.HillListBias.create(SIGMA, capacity=5,
                               spill_spec=spec if spill else None)
    jb = jhl.HillListBias.create(SIGMA, capacity=5,
                                 spill_spec=jspec if spill else None)
    rng = np.random.default_rng(5)
    probes = rng.uniform(-1.0, 1.0, (6, 2)).astype(np.float32)
    j_deposit = jax.jit(jhl.deposit)
    j_vg = jax.jit(jax.vmap(jhl.value_and_grad, in_axes=(None, 0)))
    for _ in range(8):
        c = rng.uniform(-1.0, 1.0, 2).astype(np.float32)
        h = np.float32(rng.uniform(0.1, 0.5))
        b = hl.deposit(b, torch.as_tensor(c), torch.tensor(h))
        jb = j_deposit(jb, jnp.asarray(c), jnp.float32(h))
        jV, jg = j_vg(jb, jnp.asarray(probes))
        for i, p in enumerate(probes):
            V, g = hl.value_and_grad(b, torch.as_tensor(p))
            np.testing.assert_allclose(float(V), float(jV[i]), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[i]),
                                       rtol=1e-5, atol=1e-6)
    assert int(b.n_hills) == int(jb.n_hills) == 8
    assert bool(b.overflowed) == bool(jb.overflowed) == (not spill)
    np.testing.assert_array_equal(b.centers.numpy(), np.asarray(jb.centers))
    np.testing.assert_array_equal(b.heights.numpy(), np.asarray(jb.heights))
    if spill:
        # the spill grid holds the three hills past capacity
        np.testing.assert_allclose(b.spill.V.numpy(),
                                   np.asarray(jb.spill.V), rtol=1e-5,
                                   atol=1e-7)
        assert float(b.spill.V.abs().max()) > 0.0
    np.testing.assert_allclose(hl.evaluate_on_grid(b, spec).numpy(),
                               np.asarray(jhl.evaluate_on_grid(jb, jspec)),
                               rtol=1e-5, atol=1e-6)
    # the reference's buffer carried across (interop) gives its values
    back = interop.hill_list_from(jb, "cpu")
    assert int(back.n_hills) == 8 and bool(back.overflowed) == (not spill)
    np.testing.assert_allclose(
        hl.value_and_grad(back, torch.as_tensor(probes))[0].numpy(),
        np.asarray(jV), rtol=1e-5, atol=1e-7)
    # a batch of points is the points one by one
    V, g = hl.value_and_grad(b, torch.as_tensor(probes))
    V1, g1 = hl.value_and_grad(b, torch.as_tensor(probes[2]))
    np.testing.assert_allclose(V[2].item(), V1.item(), rtol=1e-6)
    np.testing.assert_allclose(g[2].numpy(), g1.numpy(), rtol=1e-6)


def test_hill_list_deposits_match_grid_mode():
    """The same well-tempered deposit sequence into a grid and into the
    list: the heights agree to the grid's interpolation, and V on the grid
    points to f32 rounding of those heights."""
    spec = GridSpec.create([-1.6], [1.6], [161], [0.1], "cpu")
    hills = HillSpec.create(W=0.15, stride=50, mode=WELL_TEMPERED,
                            deltaT=6.0)
    bg = BiasState.zeros(spec)
    bl = hl.HillListBias.create([0.1], capacity=64)
    rng = np.random.default_rng(3)
    for i, c in enumerate(rng.uniform(-1.2, 1.2, 50).astype(np.float32)):
        s = torch.tensor([c])
        bg, rg = deposit(hills, bg, s, i)
        bl, rl = deposit(hills, bl, s, i)
        np.testing.assert_allclose(float(rg.height), float(rl.height),
                                   rtol=2e-3)
    np.testing.assert_allclose(bg.grid.V.numpy(),
                               hl.evaluate_on_grid(bl, spec).numpy(),
                               atol=5e-3)
    assert int(bl.n_hills) == 50 and not bool(bl.overflowed)


def _list_sampler(tmp_path, capacity, spill):
    """The packed liquid at 500 particles, two lamellar CVs in list mode,
    stride 10."""
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(5, 1.71)
           + rng.normal(0.0, 0.05, (500, 3))).astype(np.float32)
    n, L = pos.shape[0], 5 * 1.71
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.3, cap=48,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    engine = PackedEngine(spec, "cpu", rebuild_every=5)
    cvs = [PackedLamellar.create([[0, 0, 3]], n, "cpu", name="a"),
           PackedLamellar.create([[0, 3, 0]], n, "cpu", name="b")]
    state, ovf = engine.pack_state(
        pos, Box.cubic(L, "cpu"), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel,
        extra_attrs={cv.attr_name: np.ones(n, np.float32) for cv in cvs})
    assert not ovf
    return MetadSampler(
        make_system(n, "cpu"), state, engine, cvs, None,
        HillSpec.create(W=0.1, stride=10, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=1.0),
        seed=0, hill_sigma=[0.004, 0.004], hill_capacity=capacity,
        spill_grid=(GridSpec.create([-0.06, -0.06], [0.06, 0.06], [33, 33],
                                    [0.004, 0.004], "cpu")
                    if spill else None),
        hill_file=str(tmp_path / "hills.txt"), overwrite=True,
        chunks_per_block=2)


@pytest.mark.parametrize("spill", [False, True], ids=["drop", "spill"])
def test_list_mode_sampler_runs(tmp_path, spill):
    """Three strides into a buffer of two: the third hill spills onto the
    grid, or is dropped and ``cv_out_of_grid`` (the overflow flag in list
    mode) says so; V after the run is the analytic sum of the hill log's
    rows (float64) and ``free_energy`` reconstructs through
    ``evaluate_on_grid``."""
    s = _list_sampler(tmp_path, 2, spill)
    hist = s.run(30)
    assert int(s.bias.n_hills) == 3
    assert bool(hist[-1]["cv_out_of_grid"]) == (not spill)
    assert not bool(hist[1]["cv_out_of_grid"])
    h = read_hills(str(tmp_path / "hills.txt"))
    assert h["step"].tolist() == [10, 20, 30]
    np.testing.assert_allclose(h["sigma"], 0.004)
    cv = torch.as_tensor(hist[-1]["cv"])
    V, _ = hl.value_and_grad(s.bias, cv)
    d = (h["center"][:, None, :] - hist[-1]["cv"].astype(np.float64)) / 0.004
    kept = h["height"][:2] @ np.exp(-0.5 * (d[:2, 0] ** 2).sum(-1))
    if not spill:
        np.testing.assert_allclose(float(V), kept, rtol=1e-5, atol=1e-9)
    else:
        assert float(V) >= kept * (1 - 1e-5)
    ev = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [9, 9],
                         [0.004, 0.004], "cpu")
    F = s.free_energy(1.0, eval_spec=ev)
    assert F.shape == (9, 9) and np.isfinite(F).all() and F.min() == 0.0


def test_cli_walls_in_list_mode(tmp_path):
    """The CLI in hill-list mode (the reference's tests/test_cli.py:322):
    ``wall_k`` builds the walls from each CV's ``wall: {min, max}``, a CV
    without a grid takes its ``sigma`` and ``metadynamics.hill_capacity``,
    the run writes its hill log and no grid dump; without ``wall`` the
    walls are refused."""
    from metadyn_tpu_torch import cli
    from tests.test_torch_cli import shrunk, write_cfg
    lam = {"name": "lam", "kind": "lamellar", "lattice_vector": [0, 0, 1],
           "mode": [1.0], "sigma": 0.02, "wall": {"min": -0.4, "max": 0.4}}
    cfg = shrunk("config1_lj_lamellar", tmp_path, cvs=[lam],
                 metadynamics={"W": 0.2, "stride": 25, "mode": "standard",
                               "wall_k": 500.0, "hill_capacity": 16},
                 run={"n_steps": 25, "report_every": 25})
    sampler, _ = cli.build_sampler(cfg, device="cpu")
    np.testing.assert_allclose(sampler.walls.lo.numpy(), [-0.4])
    np.testing.assert_allclose(sampler.walls.hi.numpy(), [0.4])
    np.testing.assert_allclose(sampler.walls.k.numpy(), [500.0])
    assert sampler.bias.capacity == 16
    np.testing.assert_allclose(sampler.bias.sigma.numpy(), [0.02])
    assert cli.main(["run", write_cfg(cfg, tmp_path / "c.json"),
                     "--device", "cpu"]) == 0
    assert len(read_hills(cfg["output"]["hill_file"])["step"]) == 1
    assert not os.path.exists(cfg["output"]["grid_file"])
    del lam["wall"]
    with pytest.raises(ValueError, match="wall: {min, max}"):
        cli.build_sampler(cfg, device="cpu")
