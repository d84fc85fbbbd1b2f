"""Flux-tempered metadynamics sampler (counterpart of
``metadyn_tpu/flux_sampler.py``).

Between updates the run deposits nothing: the grid bias force acts every
step, and one CV evaluation per ``bias_every`` steps feeds both the held
bias force and the visit/crossing histograms (``bias/flux.py``), on the
device.  Every ``update_period`` strides the bias is rebuilt from the
histograms and the statistics reset, unless the round-trip criterion
defers the update.

The reference's ``lax.scan`` loops are Python loops here, as in
``sampler.MetadSampler``: a stride is a loop over rebuild blocks, each a
loop over sub-chunks of ``bias_every`` steps, then the energy refresh and
the CV and metrics.  The per-stride metrics of a period and its round-trip
count go to the host in one transfer.  Random numbers come from one
``torch.Generator`` on the engine's device, seeded from ``seed``.

A checkpoint holds the carry, the bias, the update count, the deferral
count and, after ``begin_measurement``, the measurement's accumulators.
Not ported: multiple walkers (``mesh``, ROADMAP queue 1 item 5) raise
NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from .bias.flux import FLUX, FluxState, accumulate, round_trips, update_bias
from .bias.grid import GridSpec
from .bias.metad import BiasState, WallSpec
from .core.state import System
from .io.checkpoint import load_checkpoint, save_checkpoint
from .sampler import _metrics_to_host, cv_stack, make_bias_force_parts
from .utils.profiling import phase


@dataclass
class FluxCarry:
    state: object
    aux: object
    flux: FluxState
    generator: torch.Generator


class FluxTemperedSampler:
    """User-facing entry point of flux-tempered mode, with the reference's
    signature and defaults.  ``engine`` is a :class:`~metadyn_tpu_torch.
    core.packed_engine.PackedEngine`; the sampler works on its device."""

    def __init__(
        self,
        system: System,
        state,
        engine,
        cvs: Sequence,
        grid_spec: GridSpec,
        integrator_factory,
        kT: float,
        stride: int = 100,
        update_period: int = 20,       # strides per bias update
        seed: int = 0,
        walls: Optional[WallSpec] = None,
        initial_bias: Optional[BiasState] = None,
        gain0: float = 0.5,
        gain_halflife: int = 20,   # updates until the gain halves
        update_rule: str = FLUX,   # FLUX (reference method) or VISITS
        bias_every: int = 1,
        mesh=None,
        walker_axis: str = "walkers",
        min_round_trips: int = 1,
        max_defer_periods: int = 4,
    ):
        """``bias_every`` > 1 holds the bias force for that many MD steps
        between CV evaluations; the histograms then count one visit per
        evaluation.  ``min_round_trips`` > 0 defers each update until the
        round-trip diagnostic reaches it, at most ``max_defer_periods``
        periods in a row (0: update every period)."""
        if not (grid_spec.ndim == 1 and len(cvs) == 1):
            raise AssertionError(
                "flux-tempered metadynamics supports exactly one CV")
        if mesh is not None:
            raise NotImplementedError(
                "multiple-walker flux tempering (mesh) is not ported yet "
                "(ROADMAP queue 1, item 5)")
        if not hasattr(engine, "force_into"):
            raise NotImplementedError(
                "FluxTemperedSampler: engines without force_into (the "
                "particle-order engines) are not ported yet")
        self.engine = engine
        self.system = system
        self.cvs = list(cvs)
        self.kT = kT
        self.stride = stride
        self.update_period = update_period
        self.grid_spec = grid_spec
        self.bias = (initial_bias if initial_bias is not None
                     else BiasState.zeros(grid_spec))
        eval_bias, apply_force = make_bias_force_parts(engine, cvs, system,
                                                       walls)
        self.min_round_trips = min_round_trips
        self.max_defer_periods = max_defer_periods
        self._deferred = 0

        r = min(engine.rebuild_every, stride)
        if stride % r:
            raise ValueError(f"stride={stride} must be a multiple of "
                             f"rebuild_every={r}")
        if r % bias_every:
            raise ValueError(f"bias_every={bias_every} must divide "
                             f"min(rebuild_every, stride)={r}")
        n_blocks = stride // r

        # prime the aux and the forces at the initial positions
        state, aux = engine.init(state)
        g, dVds, _ = eval_bias(state, aux, self.bias)
        state = apply_force(state, aux, g, dVds)
        generator = torch.Generator(device=engine.device)
        generator.manual_seed(seed)
        self.carry = FluxCarry(state=state, aux=aux,
                               flux=FluxState.zeros(grid_spec),
                               generator=generator)

        def chunk(carry: FluxCarry, bias: BiasState):
            """One stride: rebuild blocks of sub-chunks, then the energy
            refresh and the metrics (device tensors)."""
            state, aux, fx = carry.state, carry.aux, carry.flux
            gen = carry.generator
            for _ in range(n_blocks):
                with phase("nlist_rebuild"):
                    state, aux = engine.rebuild(state, aux)
                with phase("md_steps"):
                    for _ in range(r // bias_every):
                        # one CV sweep feeds the bias force and the
                        # histograms (pre-step positions)
                        with phase("cv_eval"):
                            g, dVds, s = eval_bias(state, aux, bias)
                            fx = accumulate(fx, grid_spec, s)
                        step_fn = integrator_factory(
                            lambda s2, aux=aux, g=g, dVds=dVds:
                            apply_force(s2, aux, g, dVds))
                        for _ in range(bias_every):
                            state = step_fn(state, gen)
            with phase("energy_refresh"):
                state = engine.refresh_energy(state, aux)
            with phase("cv_eval"):
                s = cv_stack(self.cvs, state, system)
            metrics = {"cv": s, **engine.metrics(state, aux)}
            return FluxCarry(state, aux, fx, gen), metrics

        self._chunk = chunk
        self.history: list[dict] = []
        self.n_updates = 0
        self.gain0 = gain0
        self.gain_halflife = gain_halflife
        self.update_rule = update_rule
        self._meas_h: Optional[np.ndarray] = None
        self._meas_V: Optional[np.ndarray] = None
        self._meas_n = 0

    @property
    def state(self):
        return self.carry.state

    def _run_period(self) -> dict:
        """``update_period`` strides under the period's bias.  Returns the
        period's metrics (numpy, a leading axis of strides) with its
        ``round_trips``, from one device-to-host transfer."""
        metrics = []
        for _ in range(self.update_period):
            self.carry, m = self._chunk(self.carry, self.bias)
            metrics.append(m)
        stacked = {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
        stacked["round_trips"] = round_trips(self.carry.flux)
        (out,) = _metrics_to_host([stacked])
        out["round_trips"] = float(out["round_trips"])
        return out

    def run(self, n_steps: int) -> list[dict]:
        """Run ``n_steps`` (a multiple of stride·update_period): one bias
        update and histogram reset per period, deferred while the
        ``min_round_trips`` criterion is unmet, up to
        ``max_defer_periods``.  Returns one metric dict per period."""
        period_steps = self.stride * self.update_period
        if n_steps % period_steps:
            raise ValueError("n_steps must be a multiple of "
                             f"stride*update_period={period_steps}")
        out = []
        for _ in range(n_steps // period_steps):
            m = self._run_period()
            rt = m["round_trips"]
            if self._meas_h is not None:
                # measurement phase: V̄ accumulates once per period (the
                # bias is constant across deferred periods, so per-period
                # entries weight it by residence time)
                self._meas_V += self.bias.grid.V.cpu().numpy()
                self._meas_n += 1
            defer = (self.min_round_trips > 0
                     and rt < self.min_round_trips
                     and self._deferred < self.max_defer_periods)
            m["update_applied"] = not defer
            out.append(m)
            if defer:
                self._deferred += 1
                continue
            self._deferred = 0
            flux = self.carry.flux
            if self._meas_h is not None:
                # the visit histogram since the last reset, counted once,
                # right before update_bias resets it
                self._meas_h += flux.hist.cpu().numpy()
            gain = self.gain0 / (1.0 + self.n_updates / self.gain_halflife)
            self.bias, new_flux = update_bias(self.bias, flux, self.kT,
                                              gain=gain,
                                              rule=self.update_rule)
            self.carry = replace(self.carry, flux=new_flux)
            self.n_updates += 1
        self.history.extend(out)
        return out

    def save_checkpoint(self, path: str) -> None:
        """Persist the carry and the bias with the gain schedule's position
        (the bias lives outside the carry: a carry-only checkpoint would
        resume with a zero bias and a reset schedule), and the
        measurement's accumulators after :meth:`begin_measurement`."""
        extra = {"n_updates": self.n_updates, "deferred": self._deferred}
        if self._meas_h is not None:
            extra.update(meas_h=self._meas_h, meas_V=self._meas_V,
                         meas_n=self._meas_n)
        save_checkpoint(path, (self.carry, self.bias), extra=extra)

    def load_checkpoint(self, path: str) -> None:
        (self.carry, self.bias), extras = load_checkpoint(
            path, (self.carry, self.bias))
        self.n_updates = int(extras["n_updates"])
        self._deferred = int(extras.get("deferred", 0))
        if "meas_h" in extras:
            self._meas_h = np.asarray(extras["meas_h"])
            self._meas_V = np.asarray(extras["meas_V"])
            self._meas_n = int(extras["meas_n"])

    def begin_measurement(self) -> None:
        """Start (or reset) the reweighted-FES measurement: later periods
        accumulate the visit histogram and the time-averaged bias, and
        :meth:`free_energy` returns F̂(s) = −V̄(s) − kT·ln Σ_p h_p(s)."""
        n = self.grid_spec.shape[0]
        self._meas_h = np.zeros(n)
        self._meas_V = np.zeros(n)
        self._meas_n = 0

    def free_energy(self) -> np.ndarray:
        if self._meas_n > 0:
            Vbar = self._meas_V / self._meas_n
            F = -Vbar - self.kT * np.log(np.maximum(self._meas_h, 1.0))
        else:
            F = -self.bias.grid.V.cpu().numpy()
        return F - F.min()

    def grid_coords(self) -> np.ndarray:
        return self.grid_spec.axis_coords(0).cpu().numpy()
