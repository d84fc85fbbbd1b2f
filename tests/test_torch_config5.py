"""Config 5's flux-tempered metadynamics (examples/config5_flux_1m.py:
``FluxTemperedSampler`` on a diblock melt with the WCA + FENE packed engine
and the S(k) mesh CV) through the port's entry points, on the CPU, against
the JAX package's sampler (its XLA sweeps on the CPU), states carried
across by ``interop``.

Cut to 200 beads, as tests/test_config5.py:23: 25 diblock chains of 8 laid
straight on a lattice (tests/test_torch_bond_kernels.lattice_melt) at ρ
0.43, so that the bond length is 0.97 (the FENE + WCA minimum) and the
start needs no push-off; L = 7.75, 4³ cells.  Config 5's production spec
otherwise: WCA r_cut 2^(1/6), skin 0.5, FENE k 30 r0 1.5, uniform σ 1,
cap 16; ``PackedMesh`` 12³ (k0 = 2π·2/L, width 0.3); the grid [0, hi] with
hi = max(8·s0, 10) on 51 points, σ hi/25; BAOAB dt 0.002, kT 1 at γ = 0
(no noise, so both packages integrate the same trajectory),
``update_period`` 2.  The bias starts as the plane V = −2·s, so the mesh
CV's autograd bias force acts from the first step.

Two runs per package from one packed start, each held by several checks:

- (a) ``gate``, at Config 5's own cadence: ``bias_every`` 1 and a repack
  check every step (``rebuild_every`` 1), stride 5 (cut from the
  script's 50 to keep the file inside its time budget), the default round-trip gate with
  ``max_defer_periods=1``, 3 periods.  The CV never reaches the mid bin,
  so period 1 is deferred (the histograms keep their counts), period 2
  forces the update and period 3 is deferred again;
- (b) ``measure``: ``bias_every`` 5 with a repack check every 5 steps,
  stride 10, the ungated cadence (``min_round_trips=0``) after
  ``begin_measurement``, 2 periods, each ending in an update: one
  histogram count per CV evaluation (stride / ``bias_every`` per stride,
  as tests/test_modes.py:179 holds), and the reweighted free energy.

Each run compiles its own reference program: the builds and compiles are
most of this file's time.

Held: per-stride CV and metrics rtol 1e-4 (the flags exactly);
``update_applied``, ``round_trips`` and ``n_updates`` per period exactly;
the visit and crossing histograms after every period exactly; V and dV
rtol and atol 1e-4; positions by particle at the end of each segment atol
1e-3.  A CV value on a half-bin boundary could put one visit in another
bin in the two packages (their CVs differ by f32 rounding); none does
here.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.bias.grid import BiasGrid as JBiasGrid
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import BiasState as JBiasState
from metadyn_tpu.core.box import Box as JBox
from metadyn_tpu.core.packed_engine import PackedEngine as JEngine
from metadyn_tpu.core.state import make_system as jmake_system
from metadyn_tpu.cv.packed import PackedMesh as JPackedMesh
from metadyn_tpu.flux_sampler import FluxTemperedSampler as JFluxSampler
from metadyn_tpu.integrate.packed import (
    make_packed_langevin_step as jlangevin,
)
from metadyn_tpu.ops import packed as jp

from metadyn_tpu_torch import (
    Box, FluxTemperedSampler, GridSpec, HillSpec, MetadSampler, PackedEngine,
    PackedMesh, PackedSpec, bond_partner_attrs, make_packed_langevin_step,
    make_system,
)
from metadyn_tpu_torch import interop
from metadyn_tpu_torch.ops.packed import unpack_positions

from tests.test_torch_bond_kernels import lattice_melt

PERIOD, SLOPE = 2, -2.0
# run: (stride, bias_every = rebuild_every, {segment: periods})
RUNS = {"cadence": (5, 1, {"gate": 3}), "mts": (10, 5, {"measure": 2})}
SEGMENTS = {seg: (run, n) for run, (_, _, segs) in RUNS.items()
            for seg, n in segs.items()}
METRICS = ("cv", "temperature", "potential_energy")
FLAGS = ("nlist_overflow", "nlist_stale", "cell_width_violation")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    # module scope, so that it is set before the module-scoped runs below
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _melt():
    pos, vel, bonds, types, L = lattice_melt(8, 5, rho=0.43)
    return pos, vel, bonds, types, L, pos.shape[0]


def _evals(run: str) -> int:
    """CV evaluations (histogram counts) per period of ``run``."""
    stride, every, _ = RUNS[run]
    return PERIOD * stride // every


def _segments(run, sampler, bias_of, flux_of, positions_of) -> dict:
    """The run's segments, one period at a time; after each period its
    metrics, the histograms, (V, dV) and the update count, and at the end
    of each segment the positions."""
    out = {}
    for seg, n_periods in RUNS[run][2].items():
        if seg == "measure":
            sampler.min_round_trips = 0
            sampler.begin_measurement()
        periods = []
        for _ in range(n_periods):
            (m,) = sampler.run(RUNS[run][0] * PERIOD)
            periods.append(dict(metrics=m, flux=flux_of(sampler),
                                bias=bias_of(sampler),
                                n_updates=sampler.n_updates))
        out[seg] = (periods, positions_of(sampler))
    return out


def _reference_start():
    """The packed start, the CV, the grid and the initial bias, shared by
    both runs."""
    pos, vel, bonds, types, L, n = _melt()
    spec = jp.PackedSpec.create(L, n, r_cut=2 ** (1 / 6), skin=0.5, cap=16,
                                fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    assert spec.cells_per_dim == (4, 4, 4)
    engine = JEngine(spec)
    assert not engine.use_pallas
    cv = JPackedMesh.create((12, 12, 12), L, n_real=n, k0=2 * np.pi * 2 / L,
                            width=0.3, name="dsa")
    state, ovf = engine.pack_state(
        pos, JBox.cubic(L), types, np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={**jp.bond_partner_attrs(bonds, n),
                     cv.attr_name: np.asarray([1.0, -1.0],
                                              np.float32)[types]})
    assert not ovf
    system = jmake_system(n, types=types, bonds=bonds)
    hi = max(8.0 * float(jax.jit(cv.value)(state, system)), 10.0)
    gspec = JGridSpec.create([0.0], [hi], [51], [hi / 25])
    s = np.asarray(gspec.axis_coords(0))
    bias = JBiasState(grid=JBiasGrid(spec=gspec,
                                     V=jnp.asarray((SLOPE * s).astype(
                                         np.float32)),
                                     dV=jnp.full((1, 51), SLOPE,
                                                 jnp.float32)),
                      n_hills=jnp.int32(0))
    return state, spec, cv, gspec, bias


def _reference(run, start):
    state, spec, cv, gspec, bias = start
    _, _, bonds, types, _, n = _melt()
    stride, every, _ = RUNS[run]
    sampler = JFluxSampler(
        jmake_system(n, types=types, bonds=bonds), state,
        JEngine(spec, rebuild_every=every), [cv], gspec,
        lambda f: jlangevin(f, dt=0.002, kT=1.0, gamma=0.0),
        kT=1.0, stride=stride, update_period=PERIOD, seed=0,
        initial_bias=bias, bias_every=every, max_defer_periods=1)
    segments = _segments(
        run, sampler,
        lambda sm: (np.asarray(sm.bias.grid.V), np.asarray(sm.bias.grid.dV)),
        lambda sm: {k: np.asarray(getattr(sm.carry.flux, k))
                    for k in ("hist", "flux_up", "flux_down", "prev_bin")},
        lambda sm: np.asarray(jp.unpack_positions(sm.state, spec)))
    return segments, sampler


def _port(run, start):
    jstate, jspec, jcv, jgspec, jbias = start
    spec = interop.packed_spec_from(jspec)
    _, _, bonds, types, _, n = _melt()
    stride, every, _ = RUNS[run]
    sampler = FluxTemperedSampler(
        make_system(n, "cpu", types=types, bonds=bonds),
        interop.packed_state_from(jstate, "cpu"),
        PackedEngine(spec, "cpu", rebuild_every=every),
        [interop.mesh_from(jcv, "cpu")],
        interop.grid_spec_from(jgspec, "cpu"),
        lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0, gamma=0.0),
        kT=1.0, stride=stride, update_period=PERIOD, seed=0,
        initial_bias=interop.bias_state_from(jbias, "cpu"),
        bias_every=every, max_defer_periods=1)
    segments = _segments(
        run, sampler,
        lambda sm: (sm.bias.grid.V.numpy(), sm.bias.grid.dV.numpy()),
        lambda sm: interop.flux_state_arrays(sm.carry.flux),
        lambda sm: unpack_positions(sm.state, spec).numpy())
    return segments, sampler


@pytest.fixture(scope="module")
def runs():
    """run -> both packages' segments and samplers, each run made once per
    file, on first use."""
    start, made = _reference_start(), {}

    def get(run):
        if run not in made:
            jsegments, jsampler = _reference(run, start)
            segments, sampler = _port(run, start)
            made[run] = jsegments, jsampler, segments, sampler
        return made[run]
    return get, float(np.asarray(start[0].box.L)[0])


@pytest.mark.parametrize("check", ["periods", "histograms", "bias",
                                   "positions", "schedule"])
@pytest.mark.parametrize("segment", list(SEGMENTS))
def test_flux_sampler_matches_reference(runs, segment, check):
    """One check of a segment of the port's run against the reference's:
    the per-period metrics and gate, the histograms and the bias after each
    period, the positions at the segment's end, or what the segment's
    schedule must show."""
    get, L = runs
    run, n_periods = SEGMENTS[segment]
    jsegments, jsampler, segments, sampler = get(run)
    (periods, final), (jperiods, jfinal) = segments[segment], jsegments[
        segment]
    assert len(periods) == len(jperiods) == n_periods
    if check == "periods":
        for p, jp_ in zip(periods, jperiods):
            m, jm = p["metrics"], jp_["metrics"]
            assert set(m) == set(jm)
            for k in FLAGS:
                assert not np.any(m[k]) and not np.any(jm[k]), k
            for k in METRICS:
                assert np.asarray(m[k]).shape == np.asarray(jm[k]).shape, k
                assert np.all(np.isfinite(m[k])), k
                np.testing.assert_allclose(m[k], jm[k], rtol=1e-4,
                                           err_msg=k)
            assert m["update_applied"] == jm["update_applied"]
            assert m["round_trips"] == jm["round_trips"]
            assert p["n_updates"] == jp_["n_updates"]
    elif check == "histograms":
        for p, jp_ in zip(periods, jperiods):
            for k in ("hist", "flux_up", "flux_down", "prev_bin"):
                np.testing.assert_array_equal(p["flux"][k],
                                              jp_["flux"][k], err_msg=k)
    elif check == "bias":
        for p, jp_ in zip(periods, jperiods):
            for a, b in zip(p["bias"], jp_["bias"]):
                assert np.all(np.isfinite(a))
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        if segment == "measure":
            np.testing.assert_array_equal(sampler._meas_h, jsampler._meas_h)
            np.testing.assert_allclose(sampler.free_energy(),
                                       jsampler.free_energy(), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(sampler.grid_coords(),
                                       jsampler.grid_coords(), rtol=1e-6)
    elif check == "positions":
        d = final - jfinal
        np.testing.assert_allclose(d - L * np.round(d / L), 0.0, atol=1e-3)
    elif segment == "gate":
        # deferred, forced, deferred: the histograms keep their counts
        # across the deferred period and reset at the forced update
        applied = [p["metrics"]["update_applied"] for p in periods]
        assert applied == [False, True, False]
        assert [p["metrics"]["round_trips"] for p in periods] == [0.0] * 3
        assert [p["n_updates"] for p in periods] == [0, 1, 1]
        assert [float(p["flux"]["hist"].sum()) for p in periods] == [
            _evals(run), 0.0, _evals(run)]
        assert periods[1]["flux"]["prev_bin"] == -1
        V0 = SLOPE * sampler.grid_coords()
        np.testing.assert_allclose(periods[0]["bias"][0], V0, rtol=1e-6,
                                   atol=1e-5)
        assert np.abs(periods[1]["bias"][0] - V0).max() > 1e-2
    else:
        # one count per CV evaluation, each period's consumed by its update
        assert [p["n_updates"] for p in periods] == [1, 2]
        assert all(p["metrics"]["update_applied"] for p in periods)
        assert float(sampler._meas_h.sum()) == 2 * _evals(run)
        assert sampler._meas_n == 2


def _small_setup():
    pos, vel, bonds, types, L, n = _melt()
    spec = PackedSpec.create(L, n, r_cut=2 ** (1 / 6), skin=0.5, cap=16,
                             fene_k=30.0, fene_r0=1.5, uniform_sigma=1.0)
    engine = PackedEngine(spec, "cpu")
    cv = PackedMesh.create((12, 12, 12), L, n_real=n, k0=2 * np.pi * 2 / L,
                           width=0.3, name="dsa")
    state, _ = engine.pack_state(
        pos, Box.cubic(L, "cpu"), types, np.ones(n, np.float32),
        np.ones(n, np.float32), vel=vel,
        extra_attrs={**bond_partner_attrs(bonds, n),
                     cv.attr_name: np.asarray([1.0, -1.0],
                                              np.float32)[types]})
    return make_system(n, "cpu"), state, engine, cv


@pytest.mark.parametrize("case", ["two_cvs", "mesh", "checkpoints"])
def test_flux_sampler_refusals(case):
    """Two CVs raise the reference's AssertionError; a ``mesh`` raises
    ValueError: the port's walkers are a walker batch on one device (the
    stacked states), not a device mesh.  Checkpoints are ported; loading one saved by a
    ``MetadSampler`` (another carry) raises ValueError, and a failed load
    leaves the sampler as it was."""
    system, state, engine, cv = _small_setup()
    integ = lambda f: make_packed_langevin_step(f, dt=0.002, kT=1.0)  # noqa
    if case == "two_cvs":
        g2 = GridSpec.create([0.0, 0.0], [10.0, 10.0], [11, 11],
                             [0.5, 0.5], "cpu")
        with pytest.raises(AssertionError, match="exactly one CV"):
            FluxTemperedSampler(system, state, engine, [cv, cv], g2, integ,
                                kT=1.0)
        jg2 = JGridSpec.create([0.0, 0.0], [10.0, 10.0], [11, 11],
                               [0.5, 0.5])
        with pytest.raises(AssertionError, match="exactly one CV"):
            JFluxSampler(None, None, None, [cv, cv], jg2, None, kT=1.0)
        return
    g = GridSpec.create([0.0], [10.0], [11], [0.5], "cpu")
    if case == "mesh":
        with pytest.raises(ValueError, match="walker batch"):
            FluxTemperedSampler(system, state, engine, [cv], g, integ,
                                kT=1.0, mesh=object())
        return
    s = FluxTemperedSampler(system, state, engine, [cv], g, integ, kT=1.0,
                            stride=10, update_period=1)
    m = MetadSampler(system, state, engine, [cv], g,
                     HillSpec.create(W=0.1, stride=10), integ)
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "metad.npz")
        m.save_checkpoint(ck)
        carry = s.carry
        with pytest.raises(ValueError, match="structure"):
            s.load_checkpoint(ck)
        assert s.carry is carry and s.n_updates == 0
