"""The flux-tempered bias functions (``metadyn_tpu_torch/bias/flux.py``)
against the JAX package's (``metadyn_tpu/bias/flux.py``), on the CPU.

Inputs from numpy seeds: 200 CV values per grid, a mix of uniform draws
reaching half a grid span past both ends, exact grid nodes and exact
half-bin boundaries (on the grids whose spacing is a power of two, so that
(s − lo)/Δ is exactly k + ½ in f32 and both packages round half to even);
and a starting V drawn per grid.  Grids: non-periodic [−1, 1] on 9 nodes,
periodic [−1, 1) on 8, and Config 5's 101 nodes over [0, 13.7].

Held: bins, the visit and crossing histograms and the last bin exactly;
V and ∂V/∂s after ``update_bias`` (both rules) rtol and atol 1e-6; the
round-trip diagnostic exactly; a state carried across by ``interop``
mid-sequence goes on as the reference's does.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metadyn_tpu.bias import flux as jflux
from metadyn_tpu.bias.grid import BiasGrid as JBiasGrid
from metadyn_tpu.bias.grid import GridSpec as JGridSpec
from metadyn_tpu.bias.metad import BiasState as JBiasState

from metadyn_tpu_torch import GridSpec, interop
from metadyn_tpu_torch.bias import flux

# name -> (lo, hi, points, periodic, exact half-bin ties)
GRIDS = {
    "ties": (-1.0, 1.0, 9, False, True),
    "ties_periodic": (-1.0, 1.0, 8, True, True),
    "config5": (0.0, 13.7, 101, False, False),
}
N_VALUES = 200


def _grids(name: str):
    lo, hi, n, periodic, _ = GRIDS[name]
    args = ([lo], [hi], [n], [(hi - lo) / 40])
    return (JGridSpec.create(*args, periodic=[periodic]),
            GridSpec.create(*args, "cpu", periodic=[periodic]))


def _values(name: str) -> np.ndarray:
    """200 CV values: uniform past both ends, nodes and half-bin ties, in
    an order drawn from the seed."""
    lo, hi, n, periodic, ties = GRIDS[name]
    rng = np.random.default_rng(3)
    span = hi - lo
    dx = span / (n if periodic else n - 1)
    k = np.arange(-2, n + 2)
    special = [lo + k * dx]
    if ties:
        special.append(lo + (k + 0.5) * dx)
    special = np.concatenate(special)
    uniform = rng.uniform(lo - 0.5 * span, hi + 0.5 * span,
                          N_VALUES - len(special))
    s = np.concatenate([special, uniform]).astype(np.float32)
    return s[rng.permutation(N_VALUES)]


@functools.lru_cache(maxsize=None)
def _reference_states(name: str) -> tuple:
    """The reference's state after each of the values, made once per grid
    (jitted: its op-by-op dispatch was most of this file's time)."""
    jspec, _ = _grids(name)
    jst = jflux.FluxState.zeros(jspec)
    out = [jst]
    accumulate = jax.jit(jflux.accumulate)
    for v in _values(name):
        jst = accumulate(jst, jspec, jnp.asarray([v]))
        out.append(jst)
    return tuple(out)


def _sequence(name: str, start: int = 0):
    """Both packages' states after accumulating all the values; the port
    accumulates from ``start``, starting from the reference's state there
    (``interop``)."""
    _, spec = _grids(name)
    jstates = _reference_states(name)
    st = (interop.flux_state_from(jstates[start], "cpu") if start
          else flux.FluxState.zeros(spec))
    for v in _values(name)[start:]:
        st = flux.accumulate(st, spec, torch.tensor([v]))
    return jstates[-1], st


def _assert_flux_equal(st, jst):
    got = interop.flux_state_arrays(st)
    for k in ("hist", "flux_up", "flux_down", "prev_bin"):
        want = np.asarray(getattr(jst, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_bin_of_matches_reference(grid):
    jspec, spec = _grids(grid)
    s = _values(grid)
    got = np.asarray([int(flux.bin_of(spec, torch.tensor([v]))) for v in s])
    want = np.asarray([int(jflux.bin_of(jspec, jnp.asarray([v])))
                       for v in s])
    np.testing.assert_array_equal(got, want)
    n = GRIDS[grid][2]
    assert got.min() >= 0 and got.max() <= n - 1
    if GRIDS[grid][4]:
        # exact ties present, rounded half to even in both
        t = ((s - np.float32(GRIDS[grid][0]))
             / np.float32(float(spec.spacing(0))))
        half = np.abs(t - np.floor(t) - 0.5) == 0.0
        assert half.sum() >= n
        even = np.round(t[half]).astype(np.int64)
        assert np.all(even % 2 == 0)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_accumulate_matches_reference(grid):
    jst, st = _sequence(grid)
    _assert_flux_equal(st, jst)
    assert float(st.hist.sum()) == N_VALUES
    assert float(st.flux_up.sum()) > 0 and float(st.flux_down.sum()) > 0


@pytest.mark.parametrize("grid", list(GRIDS))
def test_flux_state_carried_by_interop(grid):
    jst, st = _sequence(grid, start=N_VALUES // 2)
    _assert_flux_equal(st, jst)


@pytest.mark.parametrize("rule", [flux.FLUX, flux.VISITS])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_update_bias_matches_reference(grid, rule):
    jspec, spec = _grids(grid)
    jst, st = _sequence(grid)
    n = GRIDS[grid][2]
    V0 = np.random.default_rng(5).normal(0.0, 1.0, n).astype(np.float32)
    dV0 = np.zeros((1, n), np.float32)
    jbias = JBiasState(grid=JBiasGrid(spec=jspec, V=jnp.asarray(V0),
                                      dV=jnp.asarray(dV0)),
                       n_hills=jnp.int32(3))
    bias = interop.bias_state_from(jbias, "cpu")
    jnew, jreset = jflux.update_bias(jbias, jst, 0.8, gain=0.3, rule=rule)
    new, reset = flux.update_bias(bias, st, 0.8, gain=0.3, rule=rule)
    np.testing.assert_allclose(new.grid.V.numpy(), np.asarray(jnew.grid.V),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new.grid.dV.numpy(), np.asarray(jnew.grid.dV),
                               rtol=1e-6, atol=1e-6)
    assert new.grid.dV.shape == (1, n)
    assert new.n_hills == int(jnew.n_hills) == 4
    assert np.abs(new.grid.V.numpy() - V0).max() > 1e-3
    _assert_flux_equal(reset, jreset)
    assert int(reset.prev_bin) == -1


@pytest.mark.parametrize("grid", list(GRIDS))
def test_round_trips_matches_reference(grid):
    jst, st = _sequence(grid)
    got = flux.round_trips(st)
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == float(jflux.round_trips(jst))
