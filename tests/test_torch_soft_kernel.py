"""The soft push-off layout of the pair kernel (``csrc/packed_lj_force.cu``
with ``pair_kind="soft"``): the DPD-conservative pair u = A·rc/2·(1 −
r/rc)², A = se_i·se_j, in the per-slot ``se``/``hs`` layout, with FENE
bonds or none, on the staged block-per-cell traversal.  The reference has
no Pallas kernel for it (its XLA roll sweep, ``metadyn_tpu/ops/packed.py:
830``); the kernel is held against the port's plain sweep, its port.

On the CPU: which soft specs the kernel takes and which stay refused (the
sentinel or uniform-σ layouts, tables, harmonic bonds), and that the
engine runs the plain sweep there.

On a card (``cuda`` tests, skipped elsewhere), against the plain sweep:
with and without FENE bonds, forces only and with energy, at cap 46 (the
push-off's cap at 1M beads); vacant slots moved next to real particles and
two vacant slots 1e-4 apart (no NaN, zero force on vacant slots); a cap
near the shared-memory limit (340: 27 × 340 staged rows of 24 bytes) and
one past it (352) that raises; the engine's soft spec launching the
kernel.  Two calls on one input give the same bits.

Inputs: ``polymer_melt`` (64 chains of 16, ρ 0.85, L = 10.64, numpy seed
0): a random walk with overlaps, as the push-off meets it; A = 100 through
eps_i; r_cut 1, skin 1, 5³ cells (the largest occupancy is 27).
Tolerances as chip_smoke.py: max|Δf| ≤ 1e-4·max|f| + 1e-3, PE and virial
rtol 1e-5.

This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_soft_kernel.py
"""
import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, PackedEngine, PackedSpec, bond_partner_attrs, pair_scale_tables,
    polymer_melt,
)
from metadyn_tpu_torch.ops.packed import pack_host, packed_lj_force
from metadyn_tpu_torch.ops.packed_cuda import check_spec, packed_lj_force_cuda

N_CHAINS, CHAIN_LEN = 64, 16
N = N_CHAINS * CHAIN_LEN
L = (N / 0.85) ** (1.0 / 3.0)
A_SOFT = 100.0


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


def soft_spec(bonds: bool = True, cap: int = 46, **kw) -> PackedSpec:
    if bonds:
        kw = dict(fene_k=30.0, fene_r0=1.5, **kw)
    return PackedSpec.create(L, N, r_cut=1.0, skin=1.0, cap=cap,
                             pair_kind="soft", **kw)


def soft_melt(device, bonds: bool = True, cap: int = 46):
    """(state, spec) of the random-walk melt in the soft layout."""
    spec = soft_spec(bonds, cap)
    pos, bond_list = polymer_melt(N_CHAINS, CHAIN_LEN, L, seed=0)
    types = np.zeros(N, np.int32)
    types.reshape(N_CHAINS, CHAIN_LEN)[:, CHAIN_LEN // 2:] = 1
    extra = bond_partner_attrs(bond_list, N) if bonds else None
    st, ovf = pack_host(pos, Box.cubic(L, device), spec, types,
                        np.full(N, A_SOFT, np.float32),
                        np.ones(N, np.float32), device, extra_attrs=extra)
    assert not ovf
    return st, spec


def check_soft(st, spec, with_energy=True):
    """The kernel against the plain sweep; zero force on vacant slots; a
    second call gives the same bits."""
    before = packed_lj_force_cuda.launches
    a = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    a2 = packed_lj_force_cuda(st, spec, with_energy=with_energy)
    b = packed_lj_force(st, spec, with_energy=with_energy)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 2
    fmax = float(b.f.abs().max())
    df = float((a.f - b.f).abs().max())
    assert fmax > 1.0 and np.isfinite(df) and df <= 1e-4 * fmax + 1e-3, (
        df, fmax)
    assert torch.all(a.f[:, st.pid >= spec.n_real] == 0.0)
    assert torch.equal(a.f, a2.f)
    if with_energy:
        assert float(b.potential_energy) > 0.0
        torch.testing.assert_close(a.potential_energy, b.potential_energy,
                                   rtol=1e-5, atol=0.0)
        torch.testing.assert_close(a.virial, b.virial, rtol=1e-5, atol=0.0)
        assert torch.equal(a.potential_energy, a2.potential_energy)
        assert torch.equal(a.virial, a2.virial)


# --- the spec check and the engine, on the CPU -------------------------------

@pytest.mark.parametrize("change,taken", [
    (dict(), True),
    (dict(bonds=False), True),
    (dict(uniform_sigma=1.0, uniform_eps=100.0, bonds=False), False),
    (dict(uniform_sigma=1.0), False),
    (dict(eps_table=[[1.0, 0.6], [0.6, 1.0]]), False),
    (dict(bond_kind="harmonic"), False),
], ids=["fene", "no_bonds", "sentinel", "uniform_sigma", "table",
        "harmonic"])
def test_kernel_takes_the_soft_layouts(change, taken):
    """The soft pair is taken in the per-slot se/hs layout, with FENE bonds
    or none; the sentinel and uniform-σ layouts, tables and harmonic bonds
    stay refused (they have no caller)."""
    change = dict(change)
    bonds = change.pop("bonds", True)
    table = change.pop("eps_table", None)
    if table is not None:
        change["eps_scale"] = pair_scale_tables(table)[0]
    spec = soft_spec(bonds, **change)
    if taken:
        check_spec(spec)
    else:
        with pytest.raises(NotImplementedError, match="soft"):
            check_spec(spec)


def test_soft_engine_runs_the_plain_sweep_on_the_cpu():
    """On the CPU the engine's soft force is the plain sweep, no launch."""
    st, spec = soft_melt("cpu")
    engine = PackedEngine(spec, "cpu", rebuild_every=5)
    before = packed_lj_force_cuda.launches
    got, _ = engine.init(st)
    assert packed_lj_force_cuda.launches == before
    want = packed_lj_force(st, spec, with_energy=False)
    assert torch.equal(got.f, want.f)
    assert torch.isfinite(got.f).all() and float(got.f.abs().max()) > 1.0


# --- the kernel, on a card ---------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("with_energy", [False, True],
                         ids=["forces", "energy"])
@pytest.mark.parametrize("bonds", [True, False], ids=["fene", "no_bonds"])
def test_soft_kernel_matches_plain(cuda_device, bonds, with_energy):
    st, spec = soft_melt(cuda_device, bonds)
    occ = (st.pid < spec.n_real).reshape(spec.cap, -1).sum(0)
    assert 16 < int(occ.max()) <= spec.cap == 46
    check_soft(st, spec, with_energy)


@pytest.mark.cuda
@pytest.mark.parametrize("bonds", [True, False], ids=["fene", "no_bonds"])
def test_soft_kernel_vacant_slots_close_together(cuda_device, bonds):
    """Vacant slots (se = 0) moved 0.5 from a real particle in every cell,
    and two of them 1e-4 apart: no NaN, zero force on them, the plain
    sweep's forces elsewhere."""
    st, spec = soft_melt(cuda_device, bonds)
    r = st.r.clone()
    pid = st.pid.cpu().numpy()
    cap, C = spec.cap, spec.n_cells
    for cell in range(C):
        slots = np.arange(cap) * C + cell
        real = slots[pid[slots] < spec.n_real]
        vac = slots[pid[slots] >= spec.n_real]
        if len(real) and len(vac) >= 2:
            x0 = r[:, int(real[0])] + torch.tensor([0.5, 0.0, 0.0],
                                                   device=r.device)
            r[:, int(vac[0])] = x0
            r[:, int(vac[1])] = x0 + torch.tensor([1e-4, 0.0, 0.0],
                                                  device=r.device)
    st = st.replace(r=r)
    for we in (False, True):
        check_soft(st, spec, we)
        f = packed_lj_force_cuda(st, spec, with_energy=we).f
        assert torch.isfinite(f).all()


@pytest.mark.cuda
def test_soft_kernel_cap_near_the_shared_memory_limit(cuda_device):
    """Cap 340 (27 × 340 staged rows of 24 bytes, 225,576 bytes with the
    scratch) runs and matches; cap 352 (232,960 bytes) does not fit a
    block's 232,448 and raises."""
    st, spec = soft_melt(cuda_device, True, cap=340)
    check_soft(st, spec, True)
    st, spec = soft_melt(cuda_device, True, cap=352)
    with pytest.raises(RuntimeError, match="does not fit"):
        packed_lj_force_cuda(st, spec, with_energy=False)


@pytest.mark.cuda
def test_soft_engine_launches_the_kernel(cuda_device):
    """The engine sends a soft spec to the kernel on CUDA: init, one
    rebuild and the stride-end refresh each launch it once."""
    st, spec = soft_melt(cuda_device)
    engine = PackedEngine(spec, cuda_device, rebuild_every=5)
    before = packed_lj_force_cuda.launches
    st2, aux = engine.init(st)
    st2, aux = engine.rebuild(st2, aux)
    ref = engine.refresh_energy(st2, aux)
    torch.cuda.synchronize()
    assert packed_lj_force_cuda.launches == before + 2
    want = packed_lj_force(st2, spec, with_energy=True)
    df = float((ref.f - want.f).abs().max())
    assert df <= 1e-4 * float(want.f.abs().max()) + 1e-3
    assert not bool(aux.overflow)
