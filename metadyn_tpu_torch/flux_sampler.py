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

Multiple walkers: a walker batch as ``state`` (``core/batch.py``, W
states stacked on a leading dimension; the reference shards them over a
``mesh`` axis) runs W replicas under the shared bias.  Each keeps its own
histograms through a period; every update pools them over the walkers
(the reference's sum over its walker axis), and the round-trip gate reads
the pooled statistics.  As in ``parallel/walkers.py``, the packed engine
with batch-taking CVs steps all W at once, any other engine or CV one
walker after another.  An engine without ``force_into`` (a plain force
callable on the particle-order state) is adapted as ``MetadSampler``
adapts it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from .bias.flux import FLUX, FluxState, accumulate, round_trips, update_bias
from .bias.grid import GridSpec
from .bias.metad import BiasState, WallSpec
from .core.batch import batch_size, stack_walkers
from .core.state import System
from .io.checkpoint import load_checkpoint, save_checkpoint
from .parallel.walkers import join_groups, takes_batch, walker_groups
from .sampler import (
    _CallableEngine, _metrics_to_host, cv_stack, make_bias_force_parts,
)
from .utils.profiling import phase


@dataclass
class FluxCarry:
    """The run's carry; with walkers, ``state``, ``aux`` and ``flux`` are
    lists with one entry per walker group."""

    state: object
    aux: object
    flux: object
    generator: torch.Generator


class FluxTemperedSampler:
    """User-facing entry point of flux-tempered mode, with the reference's
    signature and defaults.  ``engine`` is an engine-protocol object or a
    plain force callable; the sampler works on its device.  ``state`` is
    one walker's state or a walker batch (multiple walkers)."""

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
        min_round_trips: int = 1,
        max_defer_periods: int = 4,
    ):
        """``bias_every`` > 1 holds the bias force for that many MD steps
        between CV evaluations; the histograms then count one visit per
        evaluation.  ``min_round_trips`` > 0 defers each update until the
        round-trip diagnostic reaches it, at most ``max_defer_periods``
        periods in a row (0: update every period).  With a walker batch,
        :meth:`run` counts steps per walker."""
        if not (grid_spec.ndim == 1 and len(cvs) == 1):
            raise AssertionError(
                "flux-tempered metadynamics supports exactly one CV")
        if mesh is not None:
            raise ValueError(
                "FluxTemperedSampler: the port runs multiple walkers on one "
                "device as a walker batch: pass the stacked states "
                "(core.batch.stack_walkers) and no mesh")
        if not hasattr(engine, "force_into"):
            engine = _CallableEngine(engine, system)
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

        def prime(state):
            """The aux and the forces at the initial positions."""
            state, aux = engine.init(state)
            g, dVds, _ = eval_bias(state, aux, self.bias)
            return apply_force(state, aux, g, dVds), aux

        def zeros(state) -> FluxState:
            w = batch_size(state)
            return FluxState.zeros(grid_spec, () if w is None else (w,))

        self.n_walkers = batch_size(state)
        self.batched = takes_batch(engine, self.cvs)
        if self.n_walkers is None:
            state, aux = prime(state)
            flux = zeros(state)
        else:
            primed = [prime(st) for st in
                      walker_groups(engine, self.cvs, state)]
            state, aux = [p[0] for p in primed], [p[1] for p in primed]
            flux = [zeros(st) for st in state]
        self._zeros = zeros
        first = state if self.n_walkers is None else state[0]
        device = getattr(engine, "device", engine.positions(first).device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        self.carry = FluxCarry(state=state, aux=aux, flux=flux,
                               generator=generator)

        def group_stride(state, aux, fx, gen, bias: BiasState):
            """One stride of one walker or walker batch: rebuild blocks of
            sub-chunks, then the energy refresh and the metrics (device
            tensors)."""
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
            return state, aux, fx, {"cv": s, **engine.metrics(state, aux)}

        def chunk(carry: FluxCarry, bias: BiasState):
            """One stride of every walker: (carry, metrics), the metrics
            with a leading walker dimension in walker mode."""
            gen = carry.generator
            if self.n_walkers is None:
                st, ax, fx, m = group_stride(carry.state, carry.aux,
                                             carry.flux, gen, bias)
                return FluxCarry(st, ax, fx, gen), m
            outs = [group_stride(st, ax, fx, gen, bias) for st, ax, fx in
                    zip(carry.state, carry.aux, carry.flux)]
            ms = [o[3] for o in outs]
            metrics = {k: join_groups([m[k] for m in ms], self.batched)
                       for k in ms[0]}
            return FluxCarry([o[0] for o in outs], [o[1] for o in outs],
                             [o[2] for o in outs], gen), metrics

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
        """The state; in walker mode the walkers as one walker batch."""
        st = self.carry.state
        if self.n_walkers is None:
            return st
        return st[0] if self.batched else stack_walkers(st)

    def _pooled_flux(self) -> FluxState:
        """The update's statistics: the walker-summed histograms in walker
        mode (the reference's sum over its walker axis), the carry's
        otherwise."""
        fx = self.carry.flux
        if self.n_walkers is None:
            return fx
        pools = [f.pooled() for f in fx]
        return FluxState(hist=sum(p.hist for p in pools),
                         flux_up=sum(p.flux_up for p in pools),
                         flux_down=sum(p.flux_down for p in pools),
                         prev_bin=pools[0].prev_bin)

    def _run_period(self) -> tuple:
        """``update_period`` strides under the period's bias.  Returns the
        period's metrics (numpy, a leading axis of strides; walkers first
        in walker mode, as the reference's) with its ``round_trips``, from
        one device-to-host transfer, and the pooled statistics."""
        metrics = []
        for _ in range(self.update_period):
            self.carry, m = self._chunk(self.carry, self.bias)
            metrics.append(m)
        stacked = {k: torch.stack([m[k] for m in metrics],
                                  dim=0 if self.n_walkers is None else 1)
                   for k in metrics[0]}
        pooled = self._pooled_flux()
        stacked["round_trips"] = round_trips(pooled)
        (out,) = _metrics_to_host([stacked])
        out["round_trips"] = float(out["round_trips"])
        return out, pooled

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
            m, pooled = self._run_period()
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
            if self._meas_h is not None:
                # the visit histogram since the last reset, counted once,
                # right before update_bias resets it
                self._meas_h += pooled.hist.cpu().numpy()
            gain = self.gain0 / (1.0 + self.n_updates / self.gain_halflife)
            self.bias, new_flux = update_bias(self.bias, pooled, self.kT,
                                              gain=gain,
                                              rule=self.update_rule)
            if self.n_walkers is not None:
                new_flux = [self._zeros(st) for st in self.carry.state]
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
