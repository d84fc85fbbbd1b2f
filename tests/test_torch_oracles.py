"""The JAX package's statistical oracles, on the port (all ``slow``: hours of
eager steps on a CPU, outside tier-1's budget).

- The flux-tempered double well (tests/test_modes.py:137-199): the
  reweighted FES within 0.1 kT after 500k transient and 8M measurement
  steps; the short run's bias toward the wells (100k steps, well minus
  barrier > 0.5); the same with ``bias_every=5`` and its histogram
  subsampling (5,000 steps count 1,000 visits).
- The well-tempered walkers (tests/test_walkers.py:96, :271): 8 walkers,
  half in each well, the time-averaged FES within 0.3 (10k + 8 x 5k
  steps) and within 0.1 kT (50k + 12 x 25k).
- The flux-tempered walkers (tests/test_flux_walkers.py:56): 8 pooled
  walkers within 0.1 (kT 0.6) after 125k + 2M steps.
- The lagged multiple-time-stepping path's ensemble
  (tests/test_fused.py:239): a 256-particle LJ liquid under a frozen
  harmonic bias on the coordination CV, 2k + 10k steps with
  ``mts_lag=True`` and ``False``; the means within max(6 standard errors,
  0.004), the spreads within half of the exact path's, the bias visibly
  displacing the ensemble.

The protocols, seeds and bounds are the reference's.  They run on a CUDA
device when there is one, else on the CPU at 2 torch threads; the files
import no JAX, so the card runs them with
    python -m pytest --noconftest -m slow tests/test_torch_oracles.py -s
Each test prints its figure beside its bound, and its seconds.
"""
import time

import numpy as np
import pytest
import torch

from metadyn_tpu_torch import (
    Box, FluxTemperedSampler, ForceField, GridSpec, HillSpec, WalkerSampler,
    WELL_TEMPERED, make_langevin_step, make_state, make_system,
)
from metadyn_tpu_torch.bias.metad import free_energy
from metadyn_tpu_torch.core.batch import stack_walkers
from metadyn_tpu_torch.cv.simple import AxisPosition

pytestmark = pytest.mark.slow


@pytest.fixture
def device():
    """The card when there is one, else the CPU at 2 torch threads."""
    if torch.cuda.is_available():
        yield "cuda"
        return
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield "cpu"
    finally:
        torch.set_num_threads(n)


def _report(name, value, bound, t0, device):
    where = (torch.cuda.get_device_name(0) if device == "cuda"
             else "the CPU")
    print(f"\n{name} on {where}: {value:.4f} (bound {bound:.4f}) in "
          f"{time.perf_counter() - t0:.1f} s")


def _double_well(a_well):
    def dw(pos, state, system):
        x = pos[0, 0]
        return (a_well * (x * x - 1.0) ** 2
                + 5.0 * (pos[0, 1] ** 2 + pos[0, 2] ** 2))
    return dw


def _fes_error(F, x, a_well, half_width=1.1):
    m = np.abs(x) <= half_width
    err = (F - a_well * (x ** 2 - 1.0) ** 2)[m]
    err -= err.mean()
    return float(np.max(np.abs(err)))


# --- the flux-tempered double well (tests/test_modes.py) ------------------

def _ft_sampler(device, kT, gamma=5.0, gain_halflife=20, bias_every=1,
                n_walkers=0, a_well=2.0):
    system = make_system(1, device)
    box = Box.cubic(50.0, device)
    start = np.asarray([[1.0, 0.0, 0.0]], np.float32)
    if n_walkers:
        state = stack_walkers([make_state(start, box, device=device)
                               for _ in range(n_walkers)])
    else:
        state = make_state(start, box, device=device)
    ff = ForceField(external=_double_well(a_well), device=device)
    return FluxTemperedSampler(
        system, state, ff.bind(system), [AxisPosition(0, 0, name="x")],
        GridSpec.create([-1.5], [1.5], [61], [0.1], device),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=kT,
                                     gamma=gamma),
        kT=kT, stride=50, update_period=100, seed=0,
        gain_halflife=gain_halflife, bias_every=bias_every,
        min_round_trips=0)


def test_flux_tempered_double_well_converges(device):
    kT, t0 = 0.6, time.perf_counter()
    s = _ft_sampler(device, kT, gamma=2.0, gain_halflife=10)
    x = s.grid_coords()
    s.run(500_000)
    s.begin_measurement()
    s.run(8_000_000)
    err = _fes_error(s.free_energy(), x, 2.0)
    _report("flux double well (reweighted FES)", err, 0.1, t0, device)
    assert err < 0.1, err
    assert max(h["round_trips"] for h in s.history) >= 1


def _well_minus_barrier(s):
    x = s.grid_coords()
    V = s.bias.grid.V.cpu().numpy()
    assert np.all(np.isfinite(V))
    return (V[np.abs(np.abs(x) - 1.0) < 0.15].max()
            - V[np.abs(x) < 0.15].max())


def test_flux_tempered_double_well_fast(device):
    t0 = time.perf_counter()
    s = _ft_sampler(device, 0.6)
    s.run(100_000)
    gap = _well_minus_barrier(s)
    _report("flux double well, short run (well - barrier, above)", gap, 0.5,
            t0, device)
    assert gap > 0.5, gap
    assert max(h["round_trips"] for h in s.history) >= 1


def test_flux_tempered_bias_every_mts(device):
    t0 = time.perf_counter()
    s = _ft_sampler(device, 0.6, bias_every=5)
    s.run(100_000)
    gap = _well_minus_barrier(s)
    _report("flux double well, bias_every 5 (well - barrier, above)", gap,
            0.5, t0, device)
    assert gap > 0.5, gap
    s.begin_measurement()
    s.run(5_000)
    assert float(s._meas_h.sum()) == 5_000 / 5
    assert max(h["round_trips"] for h in s.history) >= 1


# --- the well-tempered walkers (tests/test_walkers.py) --------------------

def _walkers(device, stride=25, seed=0):
    system = make_system(1, device)
    box = Box.cubic(50.0, device)
    states = stack_walkers([
        make_state(np.asarray([[1.0 - 2.0 * (w % 2), 0, 0]], np.float32),
                   box, device=device) for w in range(8)])
    ff = ForceField(external=_double_well(2.0), device=device)
    return WalkerSampler(
        system, states, ff.bind(system), [AxisPosition(0, 0, name="x")],
        GridSpec.create([-1.6], [1.6], [161], [0.1], device),
        HillSpec.create(W=0.1, stride=stride, mode=WELL_TEMPERED,
                        deltaT=6.0),
        lambda f: make_langevin_step(f, system, dt=0.005, kT=0.6,
                                     gamma=5.0),
        seed=seed)


def _walker_fes(s, transient, n_seg, seg, kT=0.6):
    x = s.grid_spec.axis_coords(0).cpu().numpy()
    s.run(transient)
    F_acc = np.zeros_like(x)
    for _ in range(n_seg):
        s.run(seg)
        F_acc += free_energy(s.hills, s.bias, kT).cpu().numpy()
    return _fes_error(F_acc / n_seg, x, 2.0)


def test_walkers_converge_faster_fes(device):
    t0 = time.perf_counter()
    err = _walker_fes(_walkers(device), 10_000, 8, 5_000)
    _report("8 WT walkers, short protocol", err, 0.3, t0, device)
    assert err < 0.3, err


def test_walkers_fes_tenth_kt_oracle(device):
    kT, t0 = 0.6, time.perf_counter()
    err = _walker_fes(_walkers(device), 50_000, 12, 25_000, kT)
    _report("8 WT walkers, tenth-kT oracle", err, 0.1 * kT, t0, device)
    assert err < 0.1 * kT, err / kT


# --- the flux-tempered walkers (tests/test_flux_walkers.py) ---------------

def test_flux_walkers_converge_faster(device):
    t0 = time.perf_counter()
    s = _ft_sampler(device, 0.6, gamma=2.0, gain_halflife=10, n_walkers=8,
                    a_well=3.0)
    x = s.grid_coords()
    s.run(125_000)
    s.begin_measurement()
    s.run(2_000_000)
    err = _fes_error(s.free_energy(), x, 3.0)
    _report("8 flux walkers (reweighted FES)", err, 0.1, t0, device)
    assert err < 0.1, err
    assert max(h["round_trips"] for h in s.history) >= 1


# --- the lagged MTS ensemble (tests/test_fused.py) ------------------------

def test_lagged_mts_long_run_ensemble_oracle(device):
    from metadyn_tpu_torch import (
        MetadSampler, PackedCoordination, PackedEngine, PackedSpec,
        fcc_lattice, make_packed_langevin_step,
    )
    from metadyn_tpu_torch.bias.grid import BiasGrid
    from metadyn_tpu_torch.bias.metad import BiasState

    t0 = time.perf_counter()
    kT, a_lat = 1.0, 1.55
    pos0 = fcc_lattice(4, a_lat)           # 256 particles
    n, L = pos0.shape[0], 4 * a_lat
    rng = np.random.default_rng(1)
    pos = (pos0 + rng.normal(0, 0.03, pos0.shape)).astype(np.float32)
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(0)
    system = make_system(n, device)
    gspec = GridSpec.create([3.0], [9.0], [121], [0.1], device)
    xg = np.linspace(3.0, 9.0, 121)
    k_b, s_c = 2.0, 5.0
    Vg = -0.5 * k_b * (xg - s_c) ** 2

    def bias0():
        grid = BiasGrid(spec=gspec, V=torch.as_tensor(
            Vg - Vg.max(), dtype=torch.float32, device=device),
            dV=torch.as_tensor(-k_b * (xg - s_c), dtype=torch.float32,
                               device=device)[None, :])
        return BiasState(grid=grid, n_hills=0)

    def run(lag):
        spec = PackedSpec.create(L, n, r_cut=1.5, skin=0.35, cap=24,
                                 uniform_sigma=1.0, uniform_eps=1.0,
                                 shift_energy=False)
        engine = PackedEngine(spec, device, rebuild_every=5)
        st, ovf = engine.pack_state(
            pos, Box.cubic(L, device), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.ones(n, np.float32), vel=vel)
        assert not ovf
        cv = PackedCoordination(spec, r0=1.1, r_cut=1.5, name="co")
        s = MetadSampler(
            system, st, engine, [cv], gspec,
            HillSpec.create(W=0.0, stride=10, mode=WELL_TEMPERED,
                            deltaT=5.0),
            lambda f: make_packed_langevin_step(f, dt=0.004, kT=kT,
                                                gamma=1.0),
            seed=0, chunks_per_block=16, bias_every=5, mts_lag=lag,
            add_hills=False, initial_bias=bias0())
        s.run(2000)
        h = s.run(10000)
        c = np.asarray([float(np.asarray(m["cv"]).reshape(-1)[0])
                        for m in h])
        assert np.isfinite(c).all()
        assert not any(bool(m["nlist_overflow"]) for m in h)
        return c

    c_lag, c_ex = run(True), run(False)
    assert abs(k_b * (c_lag.mean() - s_c)) > 0.1
    n_eff = len(c_lag) / 10.0
    serr = np.hypot(c_lag.std(), c_ex.std()) / np.sqrt(n_eff)
    dmean = abs(float(c_lag.mean() - c_ex.mean()))
    bound = max(6.0 * serr, 0.004)
    _report(f"lagged MTS ensemble (|mean lag - mean exact|; means "
            f"{c_lag.mean():.5f}, {c_ex.mean():.5f}, spreads "
            f"{c_lag.std():.5f}, {c_ex.std():.5f})", dmean, bound, t0,
            device)
    assert dmean < bound, (dmean, serr)
    assert abs(float(c_lag.std() - c_ex.std())) < 0.5 * c_ex.std()
