"""Kernel 1's walker batch (``csrc/packed_lj_force.cu``: W states of one
box stacked on a leading dimension, one launch for all W).

On the CPU: the wrapper's plain path takes the batch walker by walker,
equal to the bit to one call per walker, each walker in its own box (the
kernel reads one cell matrix per walker, ``Box.h`` (W, 6)), and a batch
whose boxes differ in kind (tilted and not) is refused.

On a card (``cuda`` tests, skipped elsewhere): in the sentinel, per-slot,
table + FENE and soft layouts, forces only and with energy, the batched
launch equals W single launches to the bit (forces, energies, virials), and
matches the plain batched version with chip_smoke.py's tolerances (max|Δf|
≤ 1e-4·max|f| + 1e-3, PE and virial rtol 1e-5); one launch counts once in
``launches`` and W times in ``walkers``; at W = 1 the batch is the single
launch.

Inputs: ``fcc_lattice(6, 1.68)`` (864 particles, 3³ cells, r_cut 2.5, skin
0.4) plus Gaussian noise from one numpy seed per walker.

This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_walker_kernels.py
"""
import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, PackedSpec, bond_partner_attrs, fcc_lattice, pair_scale_tables,
)
from metadyn_tpu_torch.core.batch import batch_size, stack_walkers, walker
from metadyn_tpu_torch.ops.packed import pack_host, packed_lj_force
from metadyn_tpu_torch.ops.packed_cuda import packed_lj_force_cuda

A_LAT = 1.68
N_CELLS = 6
L = N_CELLS * A_LAT
LAYOUTS = {
    "sentinel": dict(uniform_sigma=1.0, uniform_eps=1.0),
    "se_hs": dict(),
    "table_fene": dict(eps_table=[[1.0, 0.6], [0.6, 1.0]], fene_k=30.0,
                       fene_r0=1.5),
    "soft": dict(pair_kind="soft"),
}


# NPT walkers' boxes: each its own edge (the cell grid of L holds them all)
OWN_BOXES = (L, L * 1.01, L * 1.02)


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


def walker_batch(device, layout: str, n_walkers: int, box_L=(L,)):
    """(list of walkers' states, spec): fcc plus noise 0.05 from seed 10 +
    w per walker, in a layout of LAYOUTS; walker w's cubic box has edge
    ``box_L[w]`` (the last one repeated)."""
    kw = dict(LAYOUTS[layout])
    kw.setdefault("shift_energy", False)
    pos0 = fcc_lattice(N_CELLS, A_LAT)
    n = pos0.shape[0]
    types = (np.arange(n) % 2).astype(np.int32)
    eps_i = np.ones(n, np.float32)
    table = kw.pop("eps_table", None)
    if table is not None:
        eps_scale, _, eps_diag, _ = pair_scale_tables(table)
        kw["eps_scale"] = eps_scale
        eps_i = eps_diag[types]
    r_cut = 1.0 if layout == "soft" else 2.5
    spec = PackedSpec.create(L, n, r_cut=r_cut, skin=0.4, cap=40, **kw)
    extra = None
    if spec.has_bonds:
        bonds = np.stack([np.arange(0, n, 2), np.arange(1, n, 2)], axis=1)
        extra = bond_partner_attrs(bonds, n)
    states = []
    for w in range(n_walkers):
        pos = (pos0 + np.random.default_rng(10 + w).normal(
            0.0, 0.05, pos0.shape)).astype(np.float32)
        box = Box.cubic(box_L[min(w, len(box_L) - 1)], device)
        st, ovf = pack_host(pos, box, spec, types, eps_i,
                            np.ones(n, np.float32), device,
                            extra_attrs=extra)
        assert not ovf
        states.append(st)
    return states, spec


@pytest.mark.parametrize("with_energy", [False, True])
def test_plain_batch_is_each_walker_alone(with_energy):
    states, spec = walker_batch("cpu", "se_hs", 3)
    batch = stack_walkers(states)
    out = packed_lj_force_cuda(batch, spec, with_energy=with_energy)
    assert batch_size(out) == 3 and out.f.shape == (3, 3, spec.n_pad)
    for w, st in enumerate(states):
        one = packed_lj_force(st, spec, with_energy=with_energy)
        assert torch.equal(out.f[w], one.f)
        if with_energy:
            assert torch.equal(out.potential_energy[w],
                               one.potential_energy)
            assert torch.equal(out.virial[w], one.virial)


def test_batch_of_different_boxes_is_refused():
    states, spec = walker_batch("cpu", "se_hs", 2)
    tilted = states[1].replace(box=Box.triclinic(L, L, L, "cpu", 0.1))
    with pytest.raises(ValueError, match="tilted, or none"):
        stack_walkers([states[0], tilted])


@pytest.mark.parametrize("with_energy", [False, True])
def test_plain_batch_of_own_boxes_is_each_walker_alone(with_energy):
    """NPT walkers: each walker's box of its own, the batch's cell
    matrices (W, 6) stacked per walker."""
    states, spec = walker_batch("cpu", "se_hs", 3, box_L=OWN_BOXES)
    batch = stack_walkers(states)
    assert batch.box.h.shape == (3, 6)
    out = packed_lj_force_cuda(batch, spec, with_energy=with_energy)
    for w, st in enumerate(states):
        one = packed_lj_force(st, spec, with_energy=with_energy)
        assert torch.equal(out.f[w], one.f)
        if with_energy:
            assert torch.equal(out.virial[w], one.virial)
    assert not torch.equal(out.f[0], out.f[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_walker_batch_is_single_launches_to_the_bit(cuda_device, layout,
                                                     with_energy):
    states, spec = walker_batch(cuda_device, layout, 3)
    batch = stack_walkers(states)
    launches, walkers = (packed_lj_force_cuda.launches,
                         packed_lj_force_cuda.walkers)
    a = packed_lj_force_cuda(batch, spec, with_energy=with_energy)
    assert packed_lj_force_cuda.launches == launches + 1
    assert packed_lj_force_cuda.walkers == walkers + 3
    b = packed_lj_force(batch, spec, with_energy=with_energy)
    for w, st in enumerate(states):
        one = packed_lj_force_cuda(st, spec, with_energy=with_energy)
        assert torch.equal(a.f[w], one.f)
        if with_energy:
            assert torch.equal(a.potential_energy[w], one.potential_energy)
            assert torch.equal(a.virial[w], one.virial)
        aw, bw = walker(a, w), walker(b, w)
        fmax = float(bw.f.abs().max())
        df = float((aw.f - bw.f).abs().max())
        assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (df, fmax)
        if with_energy:
            torch.testing.assert_close(aw.potential_energy,
                                       bw.potential_energy, rtol=1e-5,
                                       atol=0.0)
            torch.testing.assert_close(aw.virial, bw.virial, rtol=1e-5,
                                       atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True])
@pytest.mark.parametrize("layout", ["sentinel", "table_fene"])
def test_walker_batch_of_own_boxes_is_single_launches(cuda_device, layout,
                                                      with_energy):
    """Each block reads its walker's cell matrix from device memory: a
    batch of three boxes equals three single launches to the bit and its
    plain version within tolerance."""
    states, spec = walker_batch(cuda_device, layout, 3, box_L=OWN_BOXES)
    batch = stack_walkers(states)
    a = packed_lj_force_cuda(batch, spec, with_energy=with_energy)
    b = packed_lj_force(batch, spec, with_energy=with_energy)
    for w, st in enumerate(states):
        one = packed_lj_force_cuda(st, spec, with_energy=with_energy)
        assert torch.equal(a.f[w], one.f)
        if with_energy:
            assert torch.equal(a.virial[w], one.virial)
        fmax = float(b.f[w].abs().max())
        df = float((a.f[w] - b.f[w]).abs().max())
        assert np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (df, fmax)
        if with_energy:
            torch.testing.assert_close(a.virial[w], b.virial[w], rtol=1e-5,
                                       atol=0.0)


@pytest.mark.cuda
def test_one_walker_batch_is_the_single_launch(cuda_device):
    states, spec = walker_batch(cuda_device, "sentinel", 1)
    a = packed_lj_force_cuda(stack_walkers(states), spec)
    one = packed_lj_force_cuda(states[0], spec)
    assert torch.equal(a.f[0], one.f)
    assert torch.equal(a.potential_energy[0], one.potential_energy)
    assert torch.equal(a.virial[0], one.virial)
