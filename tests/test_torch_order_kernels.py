"""The hand-written order-CV kernels (``csrc/packed_order.cu``,
``csrc/packed_fused_lj_order.cu``) against their plain PyTorch versions,
and the contract between their wrappers and the CUDA code.

On the CPU: the CV descriptor the wrappers upload, read back the way the
kernels read it.  On a card (``cuda`` tests, skipped elsewhere): each
kernel against its plain version on the same CUDA tensors, the refusals,
a failed launch that raises, and the lagged Config 3 slice on the kernels
against the same slice on the plain versions, with its launch counts.

This file imports no jax, so the ``cuda`` tests run where the JAX
package's dependencies are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_order_kernels.py

Inputs: 500 fcc particles (a = 1.62) with Gaussian noise 0.08, from a seed.
Tolerances: values rtol 2e-5; forces rtol 2e-3 and atol 2e-4 of the
largest component; the fused kernel's LJ force atol 1e-3 of its largest
component and its values rtol 2e-4 (the reference's kernel-vs-XLA
tolerances); the slice, kernels against plain versions over 40 steps at
γ = 0: positions atol 1e-3.
"""
import contextlib

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedCoordination, PackedEngine,
    PackedSpec, PackedSteinhardtQl, WallSpec, WELL_TEMPERED, fcc_lattice,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch.cv import packed_order as tpo
from metadyn_tpu_torch.cv.steinhardt import (
    _dcoeffs, _norms, _plm_over_sinm_coeffs,
)
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc
from metadyn_tpu_torch.ops import packed_order_cuda as poc
from metadyn_tpu_torch.ops.packed import (
    pack_host, packed_lj_force, unpack_positions,
)
from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

A_LAT = 1.62
NN = A_LAT / np.sqrt(2)
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


def _spec(sentinel: bool = True) -> PackedSpec:
    kw = dict(uniform_sigma=1.0, uniform_eps=1.0) if sentinel else {}
    return PackedSpec.create(5 * A_LAT, 500, r_cut=2.5, skin=0.15, cap=40,
                             shift_energy=False, **kw)


def _cv_sets(spec) -> dict:
    return {
        "q6_coord": [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6),
                     PackedCoordination(spec, r0=NN * 1.35,
                                        r_cut=NN * 1.35 * 1.5)],
        "coord_no_cut": [PackedCoordination(spec, r0=NN * 1.35)],
        "q4": [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=4)],
    }


def _state(device, spec):
    pos = fcc_lattice(5, A_LAT)
    n = pos.shape[0]
    pos = (pos + np.random.default_rng(5).normal(0.0, 0.08, pos.shape)
           ).astype(np.float32)
    st, ovf = pack_host(pos, Box.cubic(5 * A_LAT, device), spec,
                        np.zeros(n, np.int32), np.ones(n, np.float32),
                        np.ones(n, np.float32), device)
    assert not ovf
    return st


def _close(a, b, rtol, atol_frac, what):
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=atol_frac * np.abs(b).max(), err_msg=what)


def _lanes(terms) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])


def test_descriptor_matches_kernel_layout():
    """Read the descriptor back the way csrc/order_cv.cuh reads it."""
    spec = _spec()
    cvs = _cv_sets(spec)["q6_coord"] + _cv_sets(spec)["q4"]
    desc = poc.cv_descriptor(cvs)
    aux_off, val_off, n_aux, n_vals = poc.lane_layout(cvs)
    assert (n_vals, n_aux) == (15 + 1 + 11, 14 + 1 + 10)
    for c, cv in enumerate(cvs):
        h = desc[c * poc.HDR:(c + 1) * poc.HDR]
        assert (int(h[2]), int(h[3])) == (val_off[c], aux_off[c])
        if isinstance(cv, PackedCoordination):
            assert int(h[0]) == tpo.KIND_COORD
            np.testing.assert_allclose(h[5:9], [cv.r_cut ** 2, cv.r0 ** 2,
                                                *cv._stretch()], rtol=1e-6)
            continue
        assert (int(h[0]), int(h[1])) == (tpo.KIND_QL, cv.l)
        assert h[5] == np.float32(cv.r_cut ** 2)
        l, tab = cv.l, desc[int(h[4]):]
        np.testing.assert_array_equal(tab[:l + 1], _norms(l))
        co = l + 1
        dco = co + (l + 1) * (l + 2) // 2
        for m in range(l + 1):
            nc = l - m + 1
            nd = max(nc - 1, 1)
            np.testing.assert_array_equal(
                tab[co:co + nc], np.float32(_plm_over_sinm_coeffs(l)[m]))
            np.testing.assert_array_equal(tab[dco:dco + nd],
                                          np.float32(_dcoeffs(l)[m]))
            co, dco = co + nc, dco + nd
    with pytest.raises(NotImplementedError):
        poc.cv_descriptor([PackedSteinhardtQl(spec, r_cut=1.3, l=14)])
    with pytest.raises(ValueError):
        poc.cv_descriptor([])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q6_coord", "coord_no_cut", "q4"])
def test_order_kernels_match_plain(cuda_device, which):
    spec = _spec()
    st = _state(cuda_device, spec)
    cvs = _cv_sets(spec)[which]
    vac = st.pid >= spec.n_real
    before = (poc.order_values_cuda.launches, poc.order_force_cuda.launches,
              pfc.fused_lj_order_force_cuda.launches)

    terms = poc.order_values_cuda(st, spec, cvs)
    ref = tpo.order_values_plain(st, spec, cvs)
    _close(_lanes(terms), _lanes(ref), 2e-5, 1e-6, "value terms")

    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=cuda_device))
            for i, (cv, t) in enumerate(zip(cvs, ref))]
    g = poc.order_force_cuda(st, spec, cvs, auxs)
    g_ref = tpo.order_force_plain(st, spec, cvs, auxs)
    assert float(g_ref.abs().max()) > 1e-3
    _close(g, g_ref, 2e-3, 2e-4, "bias force")
    assert torch.all(g[:, vac] == 0.0)

    f, g4, terms4 = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    f_ref = packed_lj_force(st, spec, with_energy=False).f
    _close(f, f_ref, 0.0, 1e-3, "fused LJ force")
    _close(g4, g_ref, 2e-3, 2e-4, "fused bias force")
    s4 = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms4)])
    s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, ref)])
    _close(s4, s, 2e-4, 0.0, "fused values")
    assert torch.all(f[:, vac] == 0.0) and torch.all(g4[:, vac] == 0.0)

    after = (poc.order_values_cuda.launches, poc.order_force_cuda.launches,
             pfc.fused_lj_order_force_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)


@pytest.mark.cuda
def test_order_wrappers_refuse_what_they_do_not_take(cuda_device):
    spec = _spec()
    st = _state(cuda_device, spec)
    cvs = _cv_sets(spec)["q6_coord"]
    auxs = [cv.grad_aux(t, torch.tensor(1.0, device=cuda_device))
            for cv, t in zip(cvs, tpo.order_values_plain(st, spec, cvs))]
    validity = _spec(sentinel=False)
    vst = _state(cuda_device, validity)
    vcvs = _cv_sets(validity)["q6_coord"]
    # the validity layout is taken (tests/test_torch_triclinic_kernels.py);
    # its pids must be the int32 the kernels read
    wide = vst.replace(pid=vst.pid.long())
    with pytest.raises(ValueError, match="pid"):
        poc.order_values_cuda(wide, validity, vcvs)
    with pytest.raises(ValueError, match="pid"):
        poc.order_force_cuda(wide, validity, vcvs, auxs)
    # the fused kernel keeps the reference's sentinel-only rule
    with pytest.raises(ValueError, match="sentinel"):
        pfc.fused_lj_order_force_cuda(vst, validity, vcvs, auxs)
    # kernel 2 takes cell_mask since the slab decomposition (tests/
    # test_torch_spatial.py); a kernel-4 mask still needs the monomial
    # mode, as in the reference, and a mask must lie on the state's device
    with pytest.raises(NotImplementedError):
        pfc.fused_lj_order_force_cuda(
            st, spec, cvs, auxs,
            cell_mask=torch.ones(spec.n_cells, device=cuda_device))
    with pytest.raises(ValueError, match="cell_mask"):
        poc.order_values_cuda(st, spec, cvs,
                              cell_mask=torch.ones(spec.n_cells))
    with pytest.raises(ValueError):
        poc.order_values_cuda(st.replace(r=st.r.double()), spec, cvs)


@pytest.mark.cuda
def test_failed_launch_raises(cuda_device, monkeypatch):
    """A launch the CUDA side refuses (a descriptor past its limit) raises:
    no wrapper returns the plain result instead, and no launch counts."""
    spec = _spec()
    st = _state(cuda_device, spec)
    cvs = _cv_sets(spec)["q6_coord"]
    auxs = [cv.grad_aux(t, torch.tensor(1.0, device=cuda_device))
            for cv, t in zip(cvs, tpo.order_values_plain(st, spec, cvs))]
    plan = poc._plan(tuple(cvs), st.r.device)
    oversized = torch.zeros(poc.MAX_DESC + 1, device=cuda_device)
    oversized[:plan.desc.numel()] = plan.desc
    # the fused wrapper also passes its mode (the monomial one since the
    # slab decomposition)
    bad_plan = lambda cvs_, dev, mono=False: plan._replace(  # noqa: E731
        desc=oversized)
    monkeypatch.setattr(poc, "_plan", bad_plan)
    monkeypatch.setattr(pfc, "_plan", bad_plan)
    before = (poc.order_values_cuda.launches, poc.order_force_cuda.launches,
              pfc.fused_lj_order_force_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        poc.order_values_cuda(st, spec, cvs)
    with pytest.raises(RuntimeError, match="launch failed"):
        poc.order_force_cuda(st, spec, cvs, auxs)
    with pytest.raises(RuntimeError, match="launch failed"):
        pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    assert (poc.order_values_cuda.launches, poc.order_force_cuda.launches,
            pfc.fused_lj_order_force_cuda.launches) == before


@contextlib.contextmanager
def _plain_order_path():
    """The wrappers' plain versions, patched in where the port looks the
    wrappers up."""
    import metadyn_tpu_torch.sampler as sm
    saved = (tpo.order_values_cuda, tpo.order_force_cuda,
             sm.fused_lj_order_force_cuda)
    tpo.order_values_cuda = tpo.order_values_plain
    tpo.order_force_cuda = tpo.order_force_plain
    sm.fused_lj_order_force_cuda = pfc.fused_lj_order_force_plain
    try:
        yield
    finally:
        (tpo.order_values_cuda, tpo.order_force_cuda,
         sm.fused_lj_order_force_cuda) = saved


class _PlainForceEngine(PackedEngine):
    def _pair_force(self, state, with_energy):
        return packed_lj_force(state, self.spec, with_energy=with_energy)


def _lagged_sampler(device, engine_cls):
    """Config 3's sampler at 500 particles: stride 20, bias_every 5, γ = 0."""
    spec = _spec()
    pos = fcc_lattice(5, A_LAT)
    n = pos.shape[0]
    rng = np.random.default_rng(3)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    vel = rng.normal(0.0, np.sqrt(0.6), (n, 3)).astype(np.float32)
    engine = engine_cls(spec, device, rebuild_every=10)
    st, ovf = engine.pack_state(
        pos, Box.cubic(5 * A_LAT, device), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
    assert not ovf
    grid = GridSpec.create([0.0, 4.0], [0.7, 28.0], [48, 48], [0.015, 0.5],
                           device)
    return MetadSampler(
        make_system(n, device), st, engine, _cv_sets(spec)["q6_coord"], grid,
        HillSpec.create(W=0.4, stride=20, mode=WELL_TEMPERED, deltaT=6.0),
        lambda f: make_packed_langevin_step(f, dt=0.004, kT=0.6, gamma=0.0),
        seed=0, chunks_per_block=2,
        walls=WallSpec.at_grid_edges(grid, k=200.0), bias_every=5,
        mts_lag=True)


@pytest.mark.cuda
def test_lagged_slice_kernel_path_matches_plain_path(cuda_device):
    """mts_lag, 2 strides of 20 at γ = 0: the kernels against the plain
    versions, and exact launch counts per stride (2 rebuild blocks of 2
    sub-chunks: 16 held steps + 1 energy refresh on the pair kernel, 4
    fused calls, 2 value sweeps for the stride-end CVs, no force sweep)."""
    finals = []
    for plain in (False, True):
        with _plain_order_path() if plain else contextlib.nullcontext():
            s = _lagged_sampler(cuda_device,
                                _PlainForceEngine if plain else PackedEngine)
            counts0 = (packed_lj_force_cuda.launches,
                       pfc.fused_lj_order_force_cuda.launches,
                       poc.order_values_cuda.launches,
                       poc.order_force_cuda.launches)
            hist = s.run(40)
            counts = tuple(
                a - b for a, b in zip(
                    (packed_lj_force_cuda.launches,
                     pfc.fused_lj_order_force_cuda.launches,
                     poc.order_values_cuda.launches,
                     poc.order_force_cuda.launches), counts0))
        assert counts == ((0, 0, 0, 0) if plain else (34, 8, 4, 0))
        assert all(np.isfinite(m["cv"]).all() for m in hist)
        finals.append((unpack_positions(s.state, s.engine.spec).cpu().numpy(),
                       hist[-1]["cv"]))
    L = 5 * A_LAT
    d = finals[0][0] - finals[1][0]
    d -= L * np.round(d / L)
    assert np.abs(d).max() <= 1e-3
    np.testing.assert_allclose(finals[0][1], finals[1][1], rtol=1e-4,
                               atol=1e-5)
