"""The x-slab decomposition's kernel variants on the card, and its halo
geometry on the CPU.

On the CPU: the extended grids ``parallel/spatial.Slabs`` builds (each
shard's planes between its ring neighbours' boundary planes, the seam
shift of ±Lx with the paired image adjustment, cx_l = 1 included), the
interior masks, the shards' masked value sums against the unsharded sweep
in the validity layout and a tilted box, kernel 1's plain walker batch
under the mask (each walker in its own box), and the refusals (a grid
that does not divide; a walker batch only on the product).  On a card (``cuda`` tests, skipped
elsewhere), on the extended grids of 2 and 4 shards: kernel 2 with
``cell_mask``, kernel 4 in the monomial mode with and without the mask,
kernel 1's masked energy and virial, each against its plain version, and
kernel 2's mask in the validity layout and a tilted box; kernel 1's
walker batch under the mask against single masked launches; the monomial
mode
against the recurrence mode on the whole grid; two calls give the same
bits; and the slab engine against the single-grid engine over 20 lagged
steps at γ = 0, with the sharded repack bit for bit.

This file imports no jax, so the ``cuda`` tests run where the JAX
package's dependencies are not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_spatial_kernels.py

Inputs: 2,048 fcc particles (fcc 8³, a = 1.62) with Gaussian noise 0.05,
from a seed; r_cut 2.5, skin 0.5, cap 48 (4³ cells: 2 shards of 2 planes,
4 shards of 1).  Tolerances (``chip_smoke.py``'s §2 gates): values lanes
rtol 2e-5 of each CV's largest, fused lanes 2e-4; bias forces rtol 2e-3
and atol 2e-4 of the largest component; LJ forces atol 1e-3 of the
largest; pair forces atol 1e-4 of the largest + 1e-3, PE and virial rtol
1e-5; the slice's positions atol 1e-3, CVs rtol 1e-4.
"""
import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, GridSpec, HillSpec, MetadSampler, PackedCoordination, PackedEngine,
    PackedSpec, PackedSteinhardtQl, WELL_TEMPERED, fcc_lattice,
    make_packed_langevin_step, make_system,
)
from metadyn_tpu_torch.cv.packed_order import order_values_plain
from metadyn_tpu_torch.ops import packed_fused_cuda as pfc
from metadyn_tpu_torch.ops import packed_order_cuda as poc
from metadyn_tpu_torch.ops.packed import (
    packed_lj_force, repack_incremental, unpack_positions,
)
from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda
from metadyn_tpu_torch.parallel import spatial as sp

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


def _case(device, seed: int = 0):
    pos = fcc_lattice(8, A_LAT)
    n, L = pos.shape[0], 8 * A_LAT
    rng = np.random.default_rng(seed)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    vel = rng.normal(0.0, 0.5, pos.shape).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=48,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    engine = PackedEngine(spec, device, rebuild_every=5)
    st, ovf = engine.pack_state(pos, Box.cubic(L, device),
                                np.zeros(n, np.int32), np.ones(n, np.float32),
                                np.ones(n, np.float32), vel=vel)
    assert not ovf and spec.cells_per_dim == (4, 4, 4)
    cvs = [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6"),
           PackedCoordination(spec, r0=NN * 1.35, r_cut=NN * 1.35 * 1.5,
                              name="co")]
    return st, spec, cvs


def _ext(slabs, st):
    """The shards' extended states with the columns the kernels and their
    plain versions read."""
    return slabs.halo_states(st, pid=True, attrs=("se", "hs"))


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_extended_grids_and_seam_shift(n_dev):
    """Each shard's extended grid holds its planes between the ring
    neighbours' boundary planes; across the periodic seam x shifts by ∓Lx
    and the x image by ±1; the interior mask is 0 on the two ghost
    planes; the gather puts every interior back."""
    st, spec, _ = _case("cpu")
    slabs = sp.Slabs(spec, ["cpu"] * n_dev)
    cx, cy, cz = spec.cells_per_dim
    cx_l, plane = cx // n_dev, cy * cz
    assert slabs.spec_ext.cells_per_dim == (cx_l + 2, cy, cz)
    L = st.box.L_host[0]
    cols = torch.cat([st.r, st.image.to(torch.float32)])      # (6, Npad)
    grid = cols.reshape(6, spec.cap, cx, plane)
    parts = []
    for k in range(n_dev):
        ext = slabs.extend(cols, k, L, image_row=3).reshape(
            6, spec.cap, cx_l + 2, plane)
        for j, gx in enumerate(range(k * cx_l - 1, (k + 1) * cx_l + 1)):
            want = grid[:, :, gx % cx].clone()
            if gx < 0:
                want[0] -= L
                want[3] += 1.0
            elif gx >= cx:
                want[0] += L
                want[3] -= 1.0
            assert torch.equal(ext[:, :, j], want), (k, j)
        m = slabs.interior[k].reshape(cx_l + 2, plane)
        assert torch.all(m[1:-1] == 1.0) and torch.all(m[[0, -1]] == 0.0)
        parts.append(ext.reshape(6, -1))
    assert torch.equal(slabs.gather(parts), cols)


def test_slabs_refuse_what_the_reference_refuses():
    """cx must divide over the shards (the reference's assert); a walker
    batch only on the walkers × space product (``nested=True``), as in the
    reference."""
    _, spec, cvs = _case("cpu")
    with pytest.raises(ValueError, match="divide"):
        sp.Slabs(spec, ["cpu"] * 3)
    for make in (sp.make_sharded_lj_force, sp.make_sharded_repack):
        with pytest.raises(ValueError, match="divide"):
            make(spec, ["cpu"] * 3)
    with pytest.raises(ValueError, match="divide"):
        sp.make_sharded_order_parts(cvs, spec, ["cpu"] * 3)
    assert not sp.SpatialPackedEngine(spec, ["cpu"] * 2).walker_batch
    assert sp.SpatialPackedEngine(spec, ["cpu"] * 2, nested=True).walker_batch


def _validity_tilted(device):
    """The validity layout (per-slot se/hs, vacancy by pid) in a tilted
    box: fcc 8³ in the cell tilted (0.2, -0.1, 0.1), Q6 + coordination."""
    pos = fcc_lattice(8, A_LAT)
    n, L = pos.shape[0], 8 * A_LAT
    rng = np.random.default_rng(6)
    pos = (pos + rng.normal(0.0, 0.05, pos.shape)).astype(np.float32)
    tilt = (0.2, -0.1, 0.1)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=48,
                             shift_energy=False, tilt=tilt)
    assert not spec.sentinel and spec.cells_per_dim[0] % 2 == 0
    st, ovf = PackedEngine(spec, device).pack_state(
        pos, Box.triclinic(L, L, L, device, *tilt), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.ones(n, np.float32))
    assert not ovf
    cvs = [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6"),
           PackedCoordination(spec, r0=NN * 1.35, r_cut=NN * 1.35 * 1.5,
                              name="co")]
    return st, spec, cvs


def test_masked_values_add_to_the_grid_validity_tilted():
    """The plain masked value sweep on each shard's extended grid, validity
    layout, tilted box: the shards' sums equal the unsharded sweep (each
    ordered pair counted on one shard, with its i cell's weight)."""
    st, spec, cvs = _validity_tilted("cpu")
    ref = order_values_plain(st, spec, cvs)
    slabs = sp.Slabs(spec, ["cpu"] * 2)
    total = None
    for se, m in zip(_ext(slabs, st), slabs.interior):
        t = order_values_plain(se, slabs.spec_ext, cvs, cell_mask=m)
        total = t if total is None else tuple(
            tuple(x + y for x, y in zip(u, v)) for u, v in zip(total, t))
    _lanes_close(cvs, total, ref, 2e-5, "summed masked values")


def _lanes(terms):
    return torch.cat([t.reshape(-1) for cv_t in terms for t in cv_t])


def _lanes_close(cvs, a, b, rtol, what):
    for cv, x, y in zip(cvs, a, b):
        d = float((_lanes([x]) - _lanes([y])).abs().max())
        scale = float(_lanes([y]).abs().max())
        assert np.isfinite(d) and d <= rtol * scale, (what, cv.name, d,
                                                      scale)


def _close(a, b, rtol, atol_frac, what):
    scale = float(b.abs().max())
    worst = float(((a - b).abs() - rtol * b.abs()).max())
    assert np.isfinite(scale) and worst <= atol_frac * scale, (what, worst,
                                                                scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev", [2, 4])
def test_variants_match_plain_on_extended_grids(cuda_device, n_dev):
    st, spec, cvs = _case(cuda_device)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=cuda_device))
            for i, (cv, t) in enumerate(zip(cvs, order_values_plain(
                st, spec, cvs)))]
    slabs = sp.Slabs(spec, [cuda_device] * n_dev)
    sx = slabs.spec_ext
    for se, m in zip(_ext(slabs, st), slabs.interior):
        tk = poc.order_values_cuda(se, sx, cvs, cell_mask=m)
        _lanes_close(cvs, tk, order_values_plain(se, sx, cvs, cell_mask=m),
                     2e-5, "values masked")
        again = poc.order_values_cuda(se, sx, cvs, cell_mask=m)
        assert torch.equal(_lanes(tk), _lanes(again))
        for mask in (None, m):
            f, g, t = pfc.fused_lj_order_force_cuda(se, sx, cvs, auxs,
                                                    mono=True, cell_mask=mask)
            fp, gp, tp = pfc.fused_lj_order_force_plain(
                se, sx, cvs, auxs, mono=True, cell_mask=mask)
            _close(f, fp, 0.0, 1e-3, "fused LJ force")
            _close(g, gp, 2e-3, 2e-4, "fused bias force")
            _lanes_close(cvs, t, tp, 2e-4, "fused lanes")
            f2, g2, t2 = pfc.fused_lj_order_force_cuda(
                se, sx, cvs, auxs, mono=True, cell_mask=mask)
            assert torch.equal(g, g2) and torch.equal(_lanes(t), _lanes(t2))
        a = packed_lj_force_cuda(se, sx, with_energy=True, cell_mask=m)
        b = packed_lj_force(se, sx, with_energy=True, cell_mask=m)
        _close(a.f, b.f, 0.0, 1e-4 + 1e-3 / float(b.f.abs().max()),
               "pair force")
        assert abs(float(a.potential_energy - b.potential_energy)) <= \
            1e-5 * abs(float(b.potential_energy))
        _close(a.virial, b.virial, 1e-5, 0.0, "virial")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_walker_batch_under_the_mask(device):
    """The walkers × space product: kernel 1 on a shard's extended grid for
    a batch of 4 walkers, each with a box of its own, under the interior
    mask with energy and virial.  On the CPU the plain batch is each
    walker alone; on a card one launch equals 4 single masked launches to
    the bit and is within tolerance of the plain version."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch finds no CUDA device)")
    from metadyn_tpu_torch.core.batch import stack_walkers
    from metadyn_tpu_torch.core.batch import walker as walker_of
    singles = []
    for w in range(4):
        st, spec, _ = _case(device, seed=w)
        box = Box.cubic(float(st.box.L[0]) * (1.0 + 0.005 * w), device)
        singles.append(st.replace(box=box))
    slabs = sp.Slabs(spec, [torch.device(device)] * 2)
    batch = stack_walkers(singles)
    for k, se in enumerate(_ext(slabs, batch)):
        m = slabs.interior[k]
        launches = packed_lj_force_cuda.launches
        a = packed_lj_force_cuda(se, slabs.spec_ext, with_energy=True,
                                 cell_mask=m)
        if device == "cuda":
            assert packed_lj_force_cuda.launches == launches + 1
        b = packed_lj_force(se, slabs.spec_ext, with_energy=True,
                            cell_mask=m)
        for w in range(4):
            one = packed_lj_force_cuda(walker_of(se, w), slabs.spec_ext,
                                       with_energy=True, cell_mask=m)
            assert torch.equal(a.f[w], one.f)
            assert torch.equal(a.potential_energy[w], one.potential_energy)
            assert torch.equal(a.virial[w], one.virial)
            _close(a.f[w], b.f[w], 0.0,
                   1e-4 + 1e-3 / float(b.f[w].abs().max()), "pair force")
            _close(a.virial[w], b.virial[w], 1e-5, 0.0, "virial")
        assert not torch.equal(a.virial[0], a.virial[1])


@pytest.mark.cuda
def test_masked_values_kernel_validity_tilted(cuda_device):
    """Kernel 2 with the mask in the validity layout and a tilted box,
    against its plain version on each shard's extended grid."""
    st, spec, cvs = _validity_tilted(cuda_device)
    slabs = sp.Slabs(spec, [cuda_device] * 2)
    for se, m in zip(_ext(slabs, st), slabs.interior):
        _lanes_close(cvs, poc.order_values_cuda(se, slabs.spec_ext, cvs,
                                                cell_mask=m),
                     order_values_plain(se, slabs.spec_ext, cvs,
                                        cell_mask=m), 2e-5, "values masked")


@pytest.mark.cuda
def test_mono_matches_recurrence_on_the_whole_grid(cuda_device):
    st, spec, cvs = _case(cuda_device, seed=2)
    auxs = [cv.grad_aux(t, torch.tensor(DV[i], device=cuda_device))
            for i, (cv, t) in enumerate(zip(cvs, order_values_plain(
                st, spec, cvs)))]
    before = (pfc.fused_lj_order_force_cuda.mono_launches,
              pfc.fused_lj_order_force_cuda.launches)
    fm, gm, tm = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs,
                                               mono=True)
    fr, gr, tr = pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs)
    assert (pfc.fused_lj_order_force_cuda.mono_launches - before[0],
            pfc.fused_lj_order_force_cuda.launches - before[1]) == (1, 2)
    _close(fm, fr, 0.0, 1e-3, "LJ force")
    _close(gm, gr, 2e-3, 2e-4, "bias force")
    _lanes_close(cvs, tm, tr, 2e-5, "lanes")
    sm = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tm)])
    sr = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, tr)])
    _close(sm, sr, 2e-5, 0.0, "values")
    with pytest.raises(ValueError, match="cell_mask"):
        pfc.fused_lj_order_force_cuda(st, spec, cvs, auxs, mono=True,
                                      cell_mask=torch.ones(spec.n_cells))


@pytest.mark.cuda
def test_slab_engine_matches_single_grid(cuda_device):
    """20 lagged steps at γ = 0 on 2 shards against the single grid, both
    on the kernels; then the sharded repack on the displaced end state,
    bit for bit."""
    pos = fcc_lattice(8, A_LAT)
    n, L = pos.shape[0], 8 * A_LAT
    rng = np.random.default_rng(1)
    vel = rng.normal(0.0, 0.7, pos.shape).astype(np.float32)
    spec = PackedSpec.create(L, n, r_cut=2.5, skin=0.5, cap=48,
                             shift_energy=False, uniform_sigma=1.0,
                             uniform_eps=1.0)
    out = []
    for engine in (PackedEngine(spec, cuda_device, rebuild_every=10),
                   sp.SpatialPackedEngine(spec, [cuda_device] * 2,
                                          rebuild_every=10)):
        st, ovf = engine.pack_state(pos, Box.cubic(L, cuda_device),
                                    np.zeros(n, np.int32),
                                    np.ones(n, np.float32),
                                    np.ones(n, np.float32), vel=vel)
        cvs = [PackedSteinhardtQl(spec, r_cut=NN * 1.2, l=6, name="q6"),
               PackedCoordination(spec, r0=NN * 1.35, r_cut=NN * 1.35 * 1.5,
                                  name="co")]
        s = MetadSampler(
            make_system(n, cuda_device), st, engine, cvs,
            GridSpec.create([0.0, 4.0], [0.7, 28.0], [32, 32],
                            [0.02, 0.5], cuda_device),
            HillSpec.create(W=0.3, stride=10, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.004, kT=0.6,
                                                gamma=0.0),
            seed=0, chunks_per_block=1, bias_every=5, mts_lag=True)
        m = s.run(20)[-1]
        out.append((unpack_positions(s.state, spec).cpu().numpy(), m["cv"],
                    s.state))
    d = out[0][0] - out[1][0]
    d -= L * np.round(d / L)
    assert np.abs(d).max() <= 1e-3
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-4)
    st = out[1][2]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    st = st.replace(r=torch.where(
        (st.pid < n)[None],
        st.r + 0.4 * torch.randn(st.r.shape, generator=gen,
                                 device=cuda_device), st.r))
    ref, bad_ref = repack_incremental(st, spec)
    got, bad = sp.make_sharded_repack(spec, [cuda_device] * 2)(st)
    assert not bool(bad_ref) and not bool(bad)
    for k in ("r", "v", "f", "image", "pid", "typ", "slot_of"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ref.attrs:
        assert torch.equal(got.attrs[k], ref.attrs[k]), k
