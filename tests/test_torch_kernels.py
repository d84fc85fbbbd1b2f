"""The port's kernel boundary: no jax in the port, no silent fallback, the
features that are not ported raise, and — on a card — the hand-written
pair-force kernel against its plain PyTorch version.

This file imports no jax, so the ``cuda`` tests also run where the JAX
package's dependencies are not installed; ``--noconftest`` skips
tests/conftest.py, which imports them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedEngine, PackedLamellar,
    PackedSpec, WallSpec, WELL_TEMPERED, fcc_lattice,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch.ops.packed import (
    VACANT_X, packed_lj_force, unpack_positions,
)
from metadyn_tpu_torch.ops.packed_cuda import check_spec, packed_lj_force_cuda
from metadyn_tpu_torch.sampler import lag_supported

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "metadyn_tpu_torch", "metadyn_tpu_torch.core.box",
    "metadyn_tpu_torch.core.state", "metadyn_tpu_torch.core.packed_engine",
    "metadyn_tpu_torch.ops.packed", "metadyn_tpu_torch.ops.packed_cuda",
    "metadyn_tpu_torch.ops._build", "metadyn_tpu_torch.integrate.packed",
    "metadyn_tpu_torch.cv.packed", "metadyn_tpu_torch.bias.grid",
    "metadyn_tpu_torch.bias.metad", "metadyn_tpu_torch.utils.profiling",
    "metadyn_tpu_torch.sampler", "metadyn_tpu_torch.interop",
    "metadyn_tpu_torch.cv.packed_order", "metadyn_tpu_torch.cv.steinhardt",
    "metadyn_tpu_torch.utils.lattice",
    "metadyn_tpu_torch.ops.packed_order_cuda",
    "metadyn_tpu_torch.ops.packed_fused_cuda",
]


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA device)")
    return torch.device("cuda", 0)


def _sampler(device, gamma=1.0, engine_cls=PackedEngine, bias_every=5):
    """The bench's configuration at 864 particles, stride 20."""
    rng = np.random.default_rng(0)
    pos = (fcc_lattice(6, 1.71)
           + rng.normal(0.0, 0.05, (864, 3))).astype(np.float32)
    n, L = pos.shape[0], 6 * 1.71
    vel = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.55, cap=40,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    engine = engine_cls(spec, device, rebuild_every=10)
    cvs = [PackedLamellar.create([[0, 0, 3]], n, device, name="a"),
           PackedLamellar.create([[0, 3, 0]], n, device, name="b")]
    amps = np.ones(n, np.float32)
    state, ovf = engine.pack_state(
        pos, Box.cubic(L, device), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel,
        extra_attrs={cv.attr_name: amps for cv in cvs})
    assert not ovf
    gspec = GridSpec.create([-0.06, -0.06], [0.06, 0.06], [64, 64],
                            [0.004, 0.004], device)
    return MetadSampler(
        make_system(n, device), state, engine, cvs, gspec,
        HillSpec.create(W=0.1, stride=20, mode=WELL_TEMPERED, deltaT=5.0),
        lambda f: make_packed_langevin_step(f, dt=0.005, kT=1.0, gamma=gamma),
        seed=0, bias_every=bias_every, chunks_per_block=2,
        walls=WallSpec.at_grid_edges(gspec, k=2000.0)), spec


class _PlainForceEngine(PackedEngine):
    """The engine with the plain pair force in place of the kernel."""

    def _pair_force(self, state, with_energy):
        return packed_lj_force(state, self.spec, with_energy=with_energy)


def test_port_imports_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'metadyn_tpu'))\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_engine_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = PackedSpec.create(10.26, 864, r_cut=2.5, skin=0.55, cap=40,
                             uniform_sigma=1.0, uniform_eps=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PackedEngine(spec, "cuda", rebuild_every=10)


def test_cpu_wrapper_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain force and launches
    nothing; the forces-only mode keeps the old energy and virial."""
    sampler, spec = _sampler("cpu")
    st = sampler.state
    before = packed_lj_force_cuda.launches
    for we in (True, False):
        a = packed_lj_force_cuda(st, spec, with_energy=we)
        b = packed_lj_force(st, spec, with_energy=we)
        assert torch.equal(a.f, b.f)
        assert torch.equal(a.potential_energy, b.potential_energy)
    assert packed_lj_force_cuda.launches == before
    assert torch.equal(a.virial, st.virial)


@pytest.mark.parametrize("change", [
    dict(uniform_sigma=None),
    dict(fene_k=30.0, fene_r0=1.5),
    dict(pair_kind="soft"),
])
def test_kernel_refuses_specs_it_does_not_take(change):
    """The kernel takes the sentinel and per-slot layouts, tables and bonds
    (tests/test_torch_bond_kernels.py); it refuses a uniform ε with a
    per-slot σ, bonds in the sentinel layout and the soft pair."""
    kw = dict(r_cut=2.5, skin=0.55, cap=40, uniform_sigma=1.0,
              uniform_eps=1.0)
    spec = PackedSpec.create(10.26, 864, **{**kw, **change})
    with pytest.raises(NotImplementedError):
        check_spec(spec)


@pytest.mark.parametrize("change", [
    dict(fene_k=30.0, fene_r0=1.5),
    dict(pair_kind="soft"),
    dict(eps_scale=[[1.0, 0.5], [0.5, 1.0]]),
])
def test_plain_force_refuses_unported_physics(change):
    """Soft pairs, bonds, tables and the per-cell mask of the slab
    decomposition are ported (the mask in each of those layouts), and the
    walkers x space product (nested islands); the slot neighbour table is
    not, in any of them."""
    sampler, spec = _sampler("cpu")
    kw = dict(r_cut=2.5, skin=0.55, cap=40)
    other = PackedSpec.create(10.26, 864, **{**kw, **change})
    st = sampler.state
    if other.has_bonds:
        st = st.replace(attrs={**st.attrs, "bp0": torch.zeros_like(st.r[0]),
                               "bp1": torch.zeros_like(st.r[0])})
    out = packed_lj_force(st, other, cell_mask=torch.ones(other.n_cells))
    assert torch.isfinite(out.potential_energy)
    with pytest.raises(NotImplementedError, match="nbr_table"):
        PackedEngine(other, "cpu", nbr_table=(2.0, 16))


@pytest.mark.parametrize("kwargs", [
    dict(grid_spec=None, hill_sigma=[0.01, 0.01]),
    dict(mts_lag=True, bias_every=5),
    dict(hill_file="hills.txt", spill_grid="grid"),
])
def test_sampler_refuses_unported_modes(kwargs):
    """Unported modes raise NotImplementedError: hill-list mode, and its
    spill grid even beside a hill log (the hill log itself is ported).
    ``mts_lag`` is ported, but refused here for the reference's reason: the
    lagged path takes order CVs only, and these CVs are lamellar."""
    sampler, _ = _sampler("cpu")
    args = dict(grid_spec=sampler.grid_spec)
    args.update(kwargs)
    if args.get("spill_grid") == "grid":
        args["spill_grid"] = sampler.grid_spec
    if kwargs.get("mts_lag"):
        assert not lag_supported(sampler.engine, sampler.cvs)
        refused = pytest.raises(ValueError, match="order CVs only")
    else:
        refused = pytest.raises(NotImplementedError)
    with refused:
        MetadSampler(sampler.system, sampler.state, sampler.engine,
                     sampler.cvs, hills=sampler.hills,
                     integrator_factory=lambda f: make_packed_langevin_step(
                         f, dt=0.005, kT=1.0), **args)


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy,shift_energy",
                         [(False, False), (True, False), (True, True)])
def test_kernel_matches_plain(cuda_device, with_energy, shift_energy):
    sampler, spec = _sampler(cuda_device)
    spec = dataclasses.replace(spec, shift_energy=shift_energy)
    st = sampler.state
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 1
    fmax = float(b.f.abs().max())
    assert float((a.f - b.f).abs().max()) <= 1e-4 * fmax + 1e-3
    vac = (st.pid >= spec.n_real)
    assert torch.all(st.r[:, vac] == VACANT_X)
    assert torch.all(a.f[:, vac] == 0.0)
    if with_energy:
        torch.testing.assert_close(a.potential_energy, b.potential_energy,
                                   rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a.virial, b.virial, rtol=1e-5, atol=0.0)
    else:
        assert torch.equal(a.potential_energy, st.potential_energy)


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    sampler, spec = _sampler(cuda_device)
    st = sampler.state
    with pytest.raises(ValueError):
        packed_lj_force_cuda(st.replace(r=st.r.T.contiguous().T), spec)
    with pytest.raises(ValueError):
        packed_lj_force_cuda(st.replace(r=st.r.double()), spec)


@pytest.mark.cuda
def test_slice_kernel_path_matches_plain_path(cuda_device):
    """γ = 0, 3 strides: the kernel engine and the plain-force engine give
    the same trajectory."""
    out = []
    for cls in (PackedEngine, _PlainForceEngine):
        sampler, spec = _sampler(cuda_device, gamma=0.0, engine_cls=cls)
        hist = sampler.run(60)
        out.append((unpack_positions(sampler.state, spec).cpu().numpy(),
                    hist))
    L = 6 * 1.71
    d = out[0][0] - out[1][0]
    d -= L * np.round(d / L)
    assert np.abs(d).max() <= 1e-3
    for m, p in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(m["potential_energy"],
                                   p["potential_energy"], rtol=1e-4)
        np.testing.assert_allclose(m["cv"], p["cv"], rtol=1e-4, atol=1e-6)
