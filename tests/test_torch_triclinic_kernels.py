"""The hand-written Hopper kernels on a tilted (triclinic) box and the
order-CV kernels in the validity layout, against their plain PyTorch
versions, on a card.

- Kernel 1 (``csrc/packed_lj_force.cu``) on the tilted box, in the per-slot
  layout (b) the triclinic slice runs and in the sentinel layout (a),
  forces only and with energy and virial.
- Kernel 5 (``csrc/packed_lj_force_v1.cu``) on the tilted box, against the
  plain force and kernel 1.
- Kernels 2 and 3 (``csrc/packed_order.cu``) in the validity layout on the
  tilted box, with vacant slots moved next to real particles (a coordinate
  test would count them: the per-slot pack leaves vacant slots at 0, not at
  the sentinel), and in the sentinel layout on the tilted box.
- Kernel 4 (``csrc/packed_fused_lj_order.cu``) in the sentinel layout on
  the tilted box.
- The triclinic slice (examples/triclinic_packed.yaml cut to 864
  particles) on the kernels against the plain path, 2 strides of 20 steps
  at γ = 0, with exact launch counts.

Inputs: ``fcc_lattice(6, 1.68)`` in the YAML's tilted box (0.2, -0.12, 0.1),
r_cut 2.5, skin 0.4, cap 40 (3³ cells, Npad 1080), Gaussian noise 0.05 from
a numpy seed.  Tolerances as chip_smoke.py: pair forces max|Δf| ≤
1e-4·max|f| + 1e-3, PE and virial rtol 1e-5; CV values rtol 2e-5, bias
forces rtol 2e-3 and atol 2e-4·max; the fused kernel's LJ force atol
1e-3·max, its values rtol 2e-4; the slice's positions atol 1e-3.

This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_triclinic_kernels.py
"""
import contextlib

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedCoordination, PackedEngine,
    PackedSpec, PackedSteinhardtQl, WELL_TEMPERED, fcc_lattice,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch.core.box import fractional, from_fractional
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc
from metadyn_tpu_torch.ops import packed_order_cuda as poc
from metadyn_tpu_torch.ops.packed import (
    pack_host, packed_lj_force, unpack_positions,
)
from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
from metadyn_tpu_torch.ops.packed_v1_cuda import packed_lj_force_v1_cuda

TILT = (0.2, -0.12, 0.1)
A_LAT = 1.68
L = 6 * A_LAT
DV = (0.9, -1.3)


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


def tilted_spec(sentinel: bool = False) -> PackedSpec:
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    return PackedSpec.create(L, 864, r_cut=2.5, skin=0.4, cap=40,
                             shift_energy=False, tilt=TILT, **kw)


def tilted_state(device, spec, noise: float = 0.05):
    pos = fcc_lattice(6, A_LAT)
    n = pos.shape[0]
    pos = (pos + np.random.default_rng(7).normal(0.0, noise, pos.shape)
           ).astype(np.float32)
    st, ovf = pack_host(pos, Box.triclinic(L, L, L, device, *TILT), spec,
                        np.zeros(n, np.int32), np.ones(n, np.float32),
                        np.ones(n, np.float32), device)
    assert not ovf
    return st


def vacant_near_real(st, spec):
    """``st`` with the last vacant slot of 8 cells moved to 0.9 from a real
    particle of its cell.  Returns (state, moved slots)."""
    r = st.r.clone()
    pid = st.pid.cpu().numpy()
    cap, C = spec.cap, spec.n_cells
    moved = []
    for cell in range(0, C, 3)[:8]:
        slots = np.arange(cap) * C + cell
        real = slots[pid[slots] < spec.n_real]
        vac = slots[pid[slots] >= spec.n_real]
        r[:, int(vac[-1])] = r[:, int(real[0])] + torch.tensor(
            [0.9, 0.0, 0.0], device=r.device)
        moved.append(int(vac[-1]))
    return st.replace(r=r), moved


def cv_sets(spec) -> dict:
    return {"q6_coord": [PackedSteinhardtQl(spec, r_cut=1.49, l=6),
                         PackedCoordination(spec, r0=1.6, r_cut=2.4)],
            "coord_no_cut": [PackedCoordination(spec, r0=1.6)]}


def close(a, b, rtol, atol_frac, what):
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_frac * np.abs(b).max(), err_msg=what)


def assert_force_close(a, b, with_energy=True):
    fmax = float(b.f.abs().max())
    df = float((a.f - b.f).abs().max())
    assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (df, fmax)
    if with_energy:
        torch.testing.assert_close(a.potential_energy, b.potential_energy,
                                   rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a.virial, b.virial, rtol=1e-5, atol=0.0)


def lanes(terms) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("sentinel", [False, True], ids=["se_hs", "sentinel"])
def test_pair_kernel_tilted_matches_plain(cuda_device, sentinel, with_energy):
    spec = tilted_spec(sentinel)
    st = tilted_state(cuda_device, spec)
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 1
    assert float(b.f.abs().max()) > 10.0        # the seam's close contacts
    assert_force_close(a, b, with_energy)
    assert torch.all(a.f[:, st.pid >= spec.n_real] == 0.0)


@pytest.mark.cuda
def test_v1_kernel_tilted_matches_plain_and_kernel1(cuda_device):
    spec = tilted_spec()
    st = tilted_state(cuda_device, spec)
    before = packed_lj_force_v1_cuda.launches
    v1 = packed_lj_force_v1_cuda(st, spec)
    plain = packed_lj_force(st, spec, with_energy=True)
    k1 = packed_lj_force_cuda(st, spec, with_energy=True)
    torch.cuda.synchronize()
    assert packed_lj_force_v1_cuda.launches == before + 1
    assert_force_close(v1, plain)
    assert_force_close(v1, k1)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q6_coord", "coord_no_cut"])
@pytest.mark.parametrize("sentinel", [False, True],
                         ids=["validity", "sentinel"])
def test_order_kernels_tilted_match_plain(cuda_device, sentinel, which):
    spec = tilted_spec(sentinel)
    st = tilted_state(cuda_device, spec)
    moved = []
    if not sentinel:
        st, moved = vacant_near_real(st, spec)
    cvs = cv_sets(spec)[which]
    before = (poc.order_values_cuda.launches, poc.order_force_cuda.launches)
    terms = poc.order_values_cuda(st, spec, cvs)
    ref = tpo.order_values_plain(st, spec, cvs)
    close(lanes(terms), lanes(ref), 2e-5, 1e-6, "value terms")
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=cuda_device))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    g = poc.order_force_cuda(st, spec, cvs, auxs)
    g_ref = tpo.order_force_plain(st, spec, cvs, auxs)
    assert float(g_ref.abs().max()) > 1e-3
    close(g, g_ref, 2e-3, 2e-4, "bias force")
    assert torch.all(g[:, st.pid >= spec.n_real] == 0.0)
    assert torch.all(g[:, moved] == 0.0)
    after = (poc.order_values_cuda.launches, poc.order_force_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1)


@pytest.mark.cuda
def test_fused_kernel_tilted_matches_plain(cuda_device):
    spec = tilted_spec(sentinel=True)
    st = tilted_state(cuda_device, spec)
    cvs = cv_sets(spec)["q6_coord"]
    ref = tpo.order_values_plain(st, spec, cvs)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=cuda_device))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    before = pfc.fused_lj_order_force_cuda.launches
    f, g, terms = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    fp, gp, tp_ = pfc.fused_lj_order_force_plain(st, spec, cvs, auxs)
    torch.cuda.synchronize()
    assert pfc.fused_lj_order_force_cuda.launches == before + 1
    close(f, fp, 0.0, 1e-3, "fused LJ force")
    close(g, gp, 2e-3, 2e-4, "fused bias force")
    s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
    sp = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tp_)])
    close(s, sp, 2e-4, 0.0, "fused values")
    vac = st.pid >= spec.n_real
    assert torch.all(f[:, vac] == 0.0) and torch.all(g[:, vac] == 0.0)


@contextlib.contextmanager
def _plain_order_path():
    """The order wrappers' plain versions, patched in where the port looks
    them up."""
    saved = (tpo.order_values_cuda, tpo.order_force_cuda)
    tpo.order_values_cuda = tpo.order_values_plain
    tpo.order_force_cuda = tpo.order_force_plain
    try:
        yield
    finally:
        tpo.order_values_cuda, tpo.order_force_cuda = saved


class _PlainForceEngine(PackedEngine):
    def _pair_force(self, state, with_energy):
        return packed_lj_force(state, self.spec, with_energy=with_energy)


def _slice(device, engine_cls):
    """The triclinic slice at 864 particles: stride 20, bias_every 1, γ 0."""
    spec = tilted_spec()
    pos = fcc_lattice(6, A_LAT)
    n = pos.shape[0]
    rng = np.random.default_rng(11)
    vel = rng.normal(0.0, np.sqrt(0.7), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)
    engine = engine_cls(spec, device, rebuild_every=5)
    st, ovf = engine.pack_state(
        pos, Box.triclinic(L, L, L, device, *TILT), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf
    grid = GridSpec.create([0.0], [0.75], [64], [0.02], device)
    return MetadSampler(
        make_system(n, device), st, engine,
        [PackedSteinhardtQl(spec, r_cut=1.49, l=6)], grid,
        HillSpec.create(W=0.3, stride=20, mode=WELL_TEMPERED, deltaT=4.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=0.7, gamma=0.0),
        seed=11, chunks_per_block=2, bias_every=1)


@pytest.mark.cuda
def test_triclinic_slice_kernel_path_matches_plain(cuda_device):
    """2 strides of 20 at γ = 0, kernels against plain versions, with exact
    launch counts per stride: 20 steps + 1 energy refresh on the pair
    kernel, 20 + 1 (the stride-end CV) value sweeps, 20 force sweeps."""
    finals = []
    for plain in (False, True):
        with _plain_order_path() if plain else contextlib.nullcontext():
            s = _slice(cuda_device, _PlainForceEngine if plain
                       else PackedEngine)
            counts0 = (packed_lj_force_cuda.launches,
                       poc.order_values_cuda.launches,
                       poc.order_force_cuda.launches)
            hist = s.run(40)
            counts = tuple(a - b for a, b in zip(
                (packed_lj_force_cuda.launches,
                 poc.order_values_cuda.launches,
                 poc.order_force_cuda.launches), counts0))
        assert counts == ((0, 0, 0) if plain else (42, 42, 40))
        for m in hist:
            assert np.isfinite(m["cv"]).all() and float(m["hill_height"]) > 0
            assert not m["nlist_overflow"] and not m["cell_width_violation"]
        finals.append((unpack_positions(s.state, s.engine.spec), hist[-1]))
    box = s.state.box
    f = fractional(finals[0][0] - finals[1][0], box)
    d = from_fractional(f - torch.round(f), box)
    assert float(d.abs().max()) <= 1e-3
    np.testing.assert_allclose(finals[0][1]["cv"], finals[1][1]["cv"],
                               rtol=1e-4, atol=1e-5)
