"""The metadynamics sampler (counterpart of ``metadyn_tpu/sampler.py``).

A deposition stride is a loop over rebuild blocks of MD steps, followed by
an energy refresh, a CV evaluation and a hill deposit.  Within a stride the
bias grid is constant; the bias force F = −∂V/∂s · ∂s/∂r comes from the
CVs' analytic ``accum_bias_force`` where every CV has one, and otherwise
from ``torch.autograd.grad`` of the stacked CV values (the reference's
``jax.vjp`` path; the mesh S(k) CV takes it).  CVs with a ``bias_virial``
add it to the state's virial after each force call.  With ``bias_every`` > 1 the CV sweeps
and ∂V/∂s run once per ``bias_every`` steps and the bias force is held over
them (multiple time stepping); the pair force stays exact every step.

When every CV is a packed order CV (Q_l, coordination), their values come
from one fused value sweep and their bias forces from one force sweep
(``cv/packed_order.make_fused_order_force``).  With ``mts_lag`` the last
step of each sub-chunk instead runs one fused traversal for the LJ force,
the bias force from the previous sub-chunk's CV terms and fresh terms
(:func:`make_lagged_parts`).  An engine that cuts the grid into slabs
(``parallel/spatial.SpatialPackedEngine``) gives both as its own islands
(``make_order_parts``, ``make_lagged_parts``), which the sampler asks for
first, as the reference does.

The reference's ``lax.scan`` loops are Python loops here; the device state
stays on the device, and the per-stride metrics of ``chunks_per_block``
strides go to the host in one transfer.  Random numbers come from one
``torch.Generator`` on the engine's device (for a plain force callable,
the state's), seeded from ``seed``.

The engine is the packed engine, a particle-order engine
(``core/engine.py``) or a plain apply-style ``force_apply(state) ->
state`` on the particle-order ``State`` (:class:`_CallableEngine` adapts
it: a ``ForceField.bind``, as the double-well oracle uses).

The hill log (``hill_file``) is written from those host metrics: a
stride's hill record (step, centre, height) is its ``step``, ``cv`` and
``hill_height`` metrics, so the log adds no device-to-host transfer.
``save_checkpoint``/``load_checkpoint`` persist the whole carry, the
generator's state included (``io/checkpoint.py``): a resumed run repeats
the straight one bit for bit.

Ported: grid mode and the reference's hill-list mode (``grid_spec=None``:
``bias/hill_list.py``, the hills in a buffer on the device, with an
optional spill grid), analytic-force CVs (the energy CVs of the
well-tempered ensemble among them), the autograd path (the packed mesh CV
and every particle-order CV), the fused order-CV path, with and without
``mts_lag``, and its neighbour-table twin where the engine keeps a slot
neighbour table (``PackedEngine(nbr_table=...)``).

The CV functions here take one walker's state or a walker batch
(``core/batch.py``) where the engine and the CVs do: the stacked CV values
are then (W, d), ∂V/∂s too, and each CV's bias force takes its column.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .bias.metad import (
    BiasState, HillRecord, HillSpec, WallSpec, bias_value_and_grad, deposit,
    free_energy,
)
from .bias.grid import BiasGrid, GridSpec
from .bias.hill_list import HillListBias, evaluate_on_grid
from .core.engine import EngineAux
from .core.state import System, temperature
from .cv.packed_order import make_fused_order_force, make_table_order_force
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.hill_log import HillLog
from .ops.packed_fused_cuda import fused_lj_order_force_cuda
from .utils.profiling import phase


@dataclass
class SamplerCarry:
    state: object
    bias: object  # BiasState, or HillListBias in hill-list mode
    aux: object
    generator: torch.Generator
    step: int  # global step counter (host)
    # lagged-MTS context: the CV value terms of the last fused call
    # (see make_lagged_parts); None outside mts_lag runs
    ctx: object = None


class _CallableEngine:
    """A plain apply-style ``force_apply(state) -> state`` on the
    particle-order ``State`` as a rebuild-free engine."""

    rebuild_every: int = 10 ** 9

    def __init__(self, fn: Callable, system: System):
        self.fn = fn
        self.system = system

    def init(self, state):
        return self.fn(state), EngineAux.create(state.pos.device)

    def rebuild(self, state, aux):
        return state, aux

    def force_into(self, state, aux, extra_force=None):
        state = self.fn(state)
        if extra_force is not None:
            state = state.replace(force=state.force + extra_force)
        return state

    def positions(self, state):
        return state.pos

    def with_positions(self, state, r):
        return state.replace(pos=r)

    def refresh_energy(self, state, aux):
        return state

    def metrics(self, state, aux):
        return {
            "temperature": temperature(state, self.system),
            "potential_energy": state.potential_energy,
            "nlist_overflow": aux.overflow,
            "nlist_stale": aux.stale,
        }


def cv_stack(cvs, state, system: System) -> torch.Tensor:
    """The CV values, (d,); (W, d) for a walker batch."""
    return torch.stack([cv.value(state, system) for cv in cvs], dim=-1)


def _grad_with_walls(bias, s: torch.Tensor,
                     walls: Optional[WallSpec]) -> torch.Tensor:
    """∂V/∂s of the bias, plus the walls' gradient."""
    _, dVds = bias_value_and_grad(bias, s)
    if walls is not None:
        _, gw = walls.energy_and_grad(s)
        dVds = dVds + gw
    return dVds


def make_bias_force_parts(engine, cvs, system: System,
                          walls: Optional[WallSpec] = None):
    """Split the biased force into ``(eval_bias, apply_force)``:

      eval_bias(state, aux, bias) -> (g, dVds, s)   # the CV sweeps
      apply_force(state, aux, g, dVds) -> state     # engine force + held g

    When every CV implements the pair-sweep protocol (the packed order
    CVs), all values come from one fused value sweep and all bias forces
    from one force sweep; when every CV has ``accum_bias_force``, from
    those; otherwise g = −∂V/∂s · ∂s/∂r of the whole CV stack comes from
    autograd.  CVs with ``bias_virial`` add their per-axis k-space virial
    to the state's after the engine's force call, as the reference does."""
    # an energy CV on an engine whose inner force calls skip the energy
    # (the packed engine's forces-only mode) would bias against a stale
    # potential energy: refuse it, as the reference does
    if any(getattr(cv, "needs_live_energy", False) for cv in cvs) \
            and not getattr(engine, "energy_live", True):
        raise AssertionError(
            "PotentialEnergyCV (WTE) reads state.potential_energy every "
            "bias evaluation, but this engine's inner force path skips "
            "the energy accumulation. Construct it with with_energy=True.")
    fused = (len(cvs) > 0 and hasattr(engine, "spec")
             and all(hasattr(cv, "pair_value_terms") for cv in cvs))
    # the neighbour-table path: the engine keeps a (K, Npad) slot neighbour
    # table (PackedEngine(nbr_table=...)) and the sweeps gather its pairs
    table = fused and getattr(engine, "nbr_table", None) is not None
    if table:
        r_nb, _ = engine.nbr_table
        for cv in cvs:
            rc = getattr(cv, "r_cut", None)
            if rc is None:
                raise AssertionError(
                    f"CV {cv.name}: the neighbor-table path needs an "
                    "explicit r_cut (set PackedCoordination(r_cut=...))")
            if rc + engine.spec.skin > r_nb + 1e-6:
                raise AssertionError(
                    f"CV {cv.name}: r_cut {rc} + skin {engine.spec.skin} "
                    f"exceeds the table radius {r_nb}")
        tbl_values, tbl_force = make_table_order_force(cvs, engine.spec)
    if fused and not table:
        # a slab engine gives the sweeps as islands on its extended grids
        # (parallel.spatial.make_sharded_order_parts): the same contract
        sharded = (engine.make_order_parts(list(cvs))
                   if hasattr(engine, "make_order_parts") else None)
        fused_values, fused_force = (
            sharded if sharded is not None
            else make_fused_order_force(cvs, engine.spec))
    analytic = all(hasattr(cv, "accum_bias_force") for cv in cvs)
    vir_cvs = [(i, cv) for i, cv in enumerate(cvs)
               if hasattr(cv, "bias_virial")]

    def eval_bias(state, aux, bias):
        if table:
            s, terms = tbl_values(state, aux.nbr)
            dVds = _grad_with_walls(bias, s, walls)
            return tbl_force(state, aux.nbr, terms, dVds), dVds, s
        if fused:
            s, ctx = fused_values(state)
            dVds = _grad_with_walls(bias, s, walls)
            return fused_force(state, ctx, dVds), dVds, s
        if analytic:
            s = cv_stack(cvs, state, system)
            dVds = _grad_with_walls(bias, s, walls)
            g = torch.zeros_like(engine.positions(state))
            for i, cv in enumerate(cvs):
                g = cv.accum_bias_force(state, system, dVds[..., i], g)
            return g, dVds, s
        r = engine.positions(state).detach().requires_grad_(True)
        with torch.enable_grad():
            s = cv_stack(cvs, engine.with_positions(state, r), system)
        dVds = _grad_with_walls(bias, s.detach(), walls)
        (g,) = torch.autograd.grad(s, r, grad_outputs=dVds)
        return -g, dVds, s.detach()

    def apply_force(state, aux, g, dVds):
        state = engine.force_into(state, aux, extra_force=g)
        if not vir_cvs:
            return state
        w = state.virial
        for i, cv in vir_cvs:
            w = w + cv.bias_virial(state, system, dVds[..., i])
        return state.replace(virial=w)

    return eval_bias, apply_force


def make_biased_force(engine, cvs, system: System,
                      walls: Optional[WallSpec] = None):
    """Engine force plus the metadynamics bias force (and the CV walls):
    ``force(state, aux, bias) -> state``, the bias evaluated at every
    call (:func:`make_bias_force_parts` composed)."""
    eval_bias, apply_force = make_bias_force_parts(engine, cvs, system,
                                                   walls)

    def force(state, aux, bias):
        g, dVds, _ = eval_bias(state, aux, bias)
        return apply_force(state, aux, g, dVds)

    return force


_HELD_G_ATTRS = ("held_gx", "held_gy", "held_gz")


def lag_supported(engine, cvs) -> bool:
    """True iff the lagged path accepts this combination: the slab engine's
    own islands where it has them (``make_lagged_parts``), else
    :func:`make_lagged_parts`: the sentinel-layout packed engine and order
    CVs only.  (The reference also asks for its Pallas kernels; here the
    device picks kernels or plain sweeps, and both run the lagged path.)"""
    spec = getattr(engine, "spec", None)
    if spec is not None and hasattr(engine, "make_lagged_parts"):
        return engine.make_lagged_parts(list(cvs)) is not None
    return (spec is not None and spec.sentinel and not spec.has_bonds
            and len(cvs) > 0
            and all(hasattr(cv, "pair_value_terms_flat")
                    and hasattr(cv, "pair_grad_terms") for cv in cvs)
            and not any(hasattr(cv, "bias_virial") for cv in cvs))


def make_lagged_parts(engine, cvs, system: System,
                      walls: Optional[WallSpec] = None):
    """The lagged fused multiple-time-stepping path (``MetadSampler(
    mts_lag=True)``): the trailing force call of each sub-chunk's last MD
    step runs one fused traversal that returns the LJ force, the bias
    force and fresh CV value terms.  The bias coefficients (∂V/∂s and the
    outer CV gradient) come from the previous sub-chunk's terms: a lag of
    one sub-chunk, the slowly-varying-bias approximation ``bias_every``
    already makes.

    The held bias force rides in ``state.attrs`` (``held_g*``), so slot
    repacks permute it with the particles; the terms ride in
    ``SamplerCarry.ctx``.

    Returns ``(seed_eval, fused_force)``; raises ValueError where the
    reference refuses: a packed engine without the sentinel layout, bonds,
    CVs that are not order CVs, box-coupled CVs."""
    spec = getattr(engine, "spec", None)
    if spec is None:
        raise ValueError("mts_lag needs the packed engine")
    if not spec.sentinel or spec.has_bonds:
        raise ValueError("mts_lag needs the lean sentinel layout "
                         "(uniform_sigma + uniform_eps, no bonds)")
    if not all(hasattr(cv, "pair_value_terms_flat")
               and hasattr(cv, "pair_grad_terms") for cv in cvs):
        raise ValueError("mts_lag supports the roll-sweep order CVs only")
    if any(hasattr(cv, "bias_virial") for cv in cvs):
        raise ValueError("mts_lag: box-coupled CVs unsupported")
    cvs = list(cvs)
    values_fn, force_fn = make_fused_order_force(cvs, spec)

    def seed_eval(state, bias):
        """Exact (not lagged) evaluation at the current positions: (g,
        terms), once at sampler construction to seed the lag."""
        s, ctx = values_fn(state)
        return force_fn(state, ctx, _grad_with_walls(bias, s, walls)), ctx[0]

    def fused_force(state, bias, terms):
        """(f_lj, g_new, terms_new) at the state's positions, with the bias
        coefficients from the lagged ``terms``."""
        s = torch.stack([cv.finalize_value(t) for cv, t in zip(cvs, terms)])
        dVds = _grad_with_walls(bias, s, walls)
        auxs = [cv.grad_aux(t, dVds[i])
                for i, (cv, t) in enumerate(zip(cvs, terms))]
        return fused_lj_order_force_cuda(state, spec, cvs, auxs)

    return seed_eval, fused_force


def held_g(state) -> torch.Tensor:
    """The repack-safe held bias force (3, Npad) from the state attrs."""
    return torch.stack([state.attrs[k] for k in _HELD_G_ATTRS])


def with_held_g(state, g: torch.Tensor):
    return state.replace(attrs={**state.attrs,
                                **dict(zip(_HELD_G_ATTRS, g.unbind(0)))})


def wants_bias(integrator_factory) -> bool:
    """True for a two-argument ``integrator_factory(force_fn, bias)``: a
    box-coupled integrator (NPT box-shape metadynamics, ``cv/
    aspect_ratio.box_bias_fn_for``) that reads the live bias.  Only
    parameters without defaults count, so a one-argument factory with a
    defaulted closure parameter is not handed the bias."""
    import inspect
    params = inspect.signature(integrator_factory).parameters.values()
    return sum(1 for p in params
               if p.default is inspect.Parameter.empty
               and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)) >= 2


def make_stride_chunk(
    engine,
    biased_force,
    cvs: Sequence,
    system: System,
    hills: HillSpec,
    integrator_factory: Callable,
    bias_every: int = 1,
    bias_parts=None,
    add_hills: bool = True,
    lag_parts=None,
):
    """One deposition stride: rebuild blocks × MD steps, then the energy
    refresh and a hill.  Returns ``chunk(carry) -> (carry, record,
    metrics)`` with device-tensor metrics.  ``lag_parts`` (from
    :func:`make_lagged_parts`) selects the lagged sub-chunks.  A
    two-argument ``integrator_factory`` (:func:`wants_bias`) gets the
    stride's bias too."""
    want_bias = wants_bias(integrator_factory)
    r = min(engine.rebuild_every, hills.stride)
    if hills.stride % r:
        raise ValueError(f"stride={hills.stride} must be a multiple of "
                         f"rebuild_every={r}")
    n_blocks = hills.stride // r
    if bias_every > 1:
        if want_bias:
            raise ValueError("bias_every > 1 does not take a box-coupled "
                             "(two-argument) integrator factory: the box "
                             "needs the live bias")
        if r % bias_every:
            raise ValueError(f"bias_every={bias_every} must divide "
                             f"min(rebuild_every, stride)={r}")
        if bias_parts is None:
            raise ValueError("bias_every > 1 needs bias_parts")
        eval_bias, apply_force = bias_parts

    def finish(carry, state, aux, bias, ctx):
        with phase("energy_refresh"):
            state = engine.refresh_energy(state, aux)
        new_step = carry.step + hills.stride
        with phase("cv_eval"):
            s = cv_stack(cvs, state, system)
        with phase("hill_deposit"):
            if add_hills:
                new_bias, rec = deposit(hills, bias, s, new_step)
            else:
                new_bias = bias
                rec = HillRecord(step=new_step, center=s,
                                 height=torch.zeros((), device=s.device))
        V, _ = bias_value_and_grad(new_bias, s)
        if isinstance(new_bias, HillListBias):
            # list mode has no bounds: the buffer's overflow instead
            oob = new_bias.overflowed
        else:
            spec = new_bias.grid.spec
            oob = torch.any((s < spec.lo) | (s > spec.hi))
        metrics = {
            "step": new_step,
            "cv": s,
            "bias_V": V,
            "hill_height": rec.height,
            "cv_out_of_grid": oob,
            **engine.metrics(state, aux),
        }
        return (SamplerCarry(state, new_bias, aux, carry.generator, new_step,
                             ctx=ctx), rec, metrics)

    if lag_parts is not None:
        if bias_every <= 1:
            raise ValueError("mts_lag needs bias_every > 1")
        _seed, fused_force = lag_parts

        def lag_chunk(carry: SamplerCarry):
            bias, gen = carry.bias, carry.generator
            state, aux, terms = carry.state, carry.aux, carry.ctx
            for _ in range(n_blocks):
                with phase("nlist_rebuild"):
                    state, aux = engine.rebuild(state, aux)
                with phase("md_steps"):
                    # bias_every − 1 steps with the held (repack-safe) bias
                    # force of the last fused call
                    step_fn = integrator_factory(
                        lambda s2, aux=aux: engine.force_into(
                            s2, aux, extra_force=held_g(s2)))
                    for _ in range(r // bias_every):
                        for _ in range(bias_every - 1):
                            state = step_fn(state, gen)

                        # the last step: one fused traversal → LJ force,
                        # the bias force from the lagged terms, fresh terms
                        def rich_force(s2, terms=terms):
                            f_lj, g_new, terms_new = fused_force(s2, bias,
                                                                 terms)
                            return (with_held_g(s2.replace(f=f_lj + g_new),
                                                g_new), terms_new)

                        state, terms = integrator_factory(rich_force)(
                            state, gen)
            return finish(carry, state, aux, bias, terms)

        return lag_chunk

    def chunk(carry: SamplerCarry):
        bias, gen = carry.bias, carry.generator
        state, aux = carry.state, carry.aux
        for _ in range(n_blocks):
            with phase("nlist_rebuild"):
                state, aux = engine.rebuild(state, aux)
            with phase("md_steps"):
                if bias_every > 1:
                    for _ in range(r // bias_every):
                        with phase("cv_eval"):
                            g, dVds, _ = eval_bias(state, aux, bias)
                        step_fn = integrator_factory(
                            lambda s2, aux=aux, g=g, dVds=dVds:
                            apply_force(s2, aux, g, dVds))
                        for _ in range(bias_every):
                            state = step_fn(state, gen)
                else:
                    force_fn = (lambda st, aux=aux:
                                biased_force(st, aux, bias))
                    step_fn = (integrator_factory(force_fn, bias)
                               if want_bias else integrator_factory(force_fn))
                    for _ in range(r):
                        state = step_fn(state, gen)
        return finish(carry, state, aux, bias, carry.ctx)

    return chunk


def _metrics_to_host(metrics: list) -> list:
    """Per-stride metric dicts of device tensors → numpy, in one transfer.

    Every tensor metric is widened to f64 (exact for f32, bool and the
    small ints here), packed into one (strides, width) tensor, copied once,
    and split back with its own dtype and shape."""
    first = metrics[0]
    keys = [k for k, v in first.items() if isinstance(v, torch.Tensor)]
    cols = [torch.stack([m[k] for m in metrics]).reshape(len(metrics), -1)
            .to(torch.float64) for k in keys]
    host = torch.cat(cols, dim=1).cpu().numpy()
    out = [{k: np.asarray(v) for k, v in m.items() if k not in keys}
           for m in metrics]
    col = 0
    for k in keys:
        t = first[k]
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        width = t.numel()
        for i, row in enumerate(out):
            row[k] = host[i, col:col + width].astype(dtype).reshape(t.shape)
        col += width
    return out


class MetadSampler:
    """User-facing entry point mirroring ``mode_metadynamics``.

    ``engine`` is an engine-protocol object (the packed engine, or the
    particle-order ``AllPairsEngine`` and ``NeighborEngine``) or a plain
    apply-style ``force_apply(state) -> state`` on the particle-order
    state; the sampler works on the engine's device (a callable's: the
    state's)."""

    def __init__(
        self,
        system: System,
        state,
        engine,
        cvs: Sequence,
        grid_spec: Optional[GridSpec],
        hills: HillSpec,
        integrator_factory,
        seed: int = 0,
        hill_file: Optional[str] = None,
        overwrite: bool = False,
        initial_bias: Optional[BiasState] = None,
        chunks_per_block: int = 64,
        walls: Optional[WallSpec] = None,
        hill_sigma: Optional[Sequence[float]] = None,
        hill_capacity: int = 4096,
        spill_grid: Optional[GridSpec] = None,
        bias_every: int = 1,
        add_hills: bool = True,
        mts_lag: bool = False,
    ):
        """``grid_spec=None`` selects the reference's hill-list mode: pass
        ``hill_sigma`` (one width per CV), and optionally ``hill_capacity``
        and a coarse ``spill_grid`` that takes the hills past capacity, so
        no bias is lost (without one they are dropped and the
        ``cv_out_of_grid`` metric, the buffer's ``overflowed`` flag, says
        so).  ``hill_file`` logs every hill (appending unless ``overwrite``;
        no log when ``add_hills`` is False).  ``bias_every`` > 1 holds the
        bias force for that many MD steps between CV evaluations.
        ``add_hills=False`` freezes the bias.
        ``chunks_per_block`` strides' metrics go to the host in one
        transfer.  ``mts_lag=True`` (``bias_every`` > 1, the sentinel-layout
        packed engine and order CVs) runs each sub-chunk's last force call
        as one fused traversal with the bias coefficients lagged by one
        sub-chunk (:func:`make_lagged_parts`)."""
        if grid_spec is not None:
            if len(cvs) != grid_spec.ndim:
                raise ValueError("one grid dimension per CV")
        elif hill_sigma is None or len(hill_sigma) != len(cvs):
            raise ValueError("hill-list mode (grid_spec=None) needs "
                             "hill_sigma per CV")
        if not hasattr(engine, "force_into"):
            engine = _CallableEngine(engine, system)
        self.engine = engine
        self.system = system
        self.cvs = list(cvs)
        self.hills = hills
        self.grid_spec = grid_spec
        self.walls = walls
        lag_parts = None
        if mts_lag:
            if bias_every <= 1:
                raise ValueError("mts_lag requires bias_every > 1")
            # a slab engine builds the fused kernel as islands
            if hasattr(engine, "make_lagged_parts"):
                lag_parts = engine.make_lagged_parts(list(cvs), walls)
            if lag_parts is None:
                lag_parts = make_lagged_parts(engine, cvs, system, walls)
        self._bias_parts = make_bias_force_parts(engine, cvs, system, walls)
        _eval, _apply = self._bias_parts
        self.biased_force = lambda st, aux, bias: _apply(
            st, aux, *_eval(st, aux, bias)[:2])
        if initial_bias is not None:
            bias = initial_bias
        elif grid_spec is not None:
            bias = BiasState.zeros(grid_spec)
        else:
            bias = HillListBias.create(
                hill_sigma, capacity=hill_capacity, spill_spec=spill_grid,
                device=getattr(engine, "device",
                               engine.positions(state).device))

        # prime the aux and the forces at the initial positions (two pair
        # force calls: one in init, one in the biased force)
        state, aux = engine.init(state)
        state = self.biased_force(state, aux, bias)
        ctx0 = None
        if lag_parts is not None:
            # seed the lag: the exact bias force and terms at the start
            g0, ctx0 = lag_parts[0](state, bias)
            state = with_held_g(state, g0)

        generator = torch.Generator(
            device=getattr(engine, "device", engine.positions(state).device))
        generator.manual_seed(seed)
        self.carry = SamplerCarry(state=state, bias=bias, aux=aux,
                                  generator=generator, step=0, ctx=ctx0)
        self._chunk = make_stride_chunk(
            engine, self.biased_force, cvs, system, hills, integrator_factory,
            bias_every=bias_every, bias_parts=self._bias_parts,
            add_hills=add_hills, lag_parts=lag_parts)
        self._block = chunks_per_block
        self.hill_log = (HillLog(hill_file, self, overwrite=overwrite)
                         if hill_file and add_hills else None)
        self.history: list[dict] = []

    @property
    def state(self):
        return self.carry.state

    @property
    def bias(self):
        return self.carry.bias

    def run(self, n_steps: int) -> list[dict]:
        """Run ``n_steps`` (a multiple of the stride).  Returns the
        per-stride metric dicts (numpy)."""
        stride = self.hills.stride
        if n_steps % stride:
            raise ValueError("n_steps must be a multiple of stride")
        remaining = n_steps // stride
        out = []
        while remaining > 0:
            n = min(self._block, remaining)
            block = []
            for _ in range(n):
                self.carry, _rec, metrics = self._chunk(self.carry)
                block.append(metrics)
            host = _metrics_to_host(block)
            if self.hill_log is not None:
                # the block's hill records, from the same transfer
                self.hill_log.append(HillRecord(
                    step=np.asarray([m["step"] for m in host]),
                    center=np.stack([m["cv"] for m in host]),
                    height=np.stack([m["hill_height"] for m in host])))
            out.extend(host)
            remaining -= n
        self.history.extend(out)
        return out

    def save_checkpoint(self, path: str) -> None:
        """Persist the carry atomically to ``path``."""
        save_checkpoint(path, self.carry)

    def load_checkpoint(self, path: str) -> None:
        """Restore the carry saved by :meth:`save_checkpoint` into this
        sampler (built as the saving one was)."""
        self.carry, _ = load_checkpoint(path, self.carry)

    def free_energy(self, kT: float,
                    eval_spec: Optional[GridSpec] = None) -> np.ndarray:
        """FES estimate on the bias grid.  Hill-list mode has no grid of
        its own: pass ``eval_spec``, the points the hills are summed onto
        (``bias/hill_list.evaluate_on_grid``)."""
        bias = self.carry.bias
        if isinstance(bias, HillListBias):
            if eval_spec is None:
                raise ValueError("hill-list mode: pass eval_spec for FES "
                                 "reconstruction")
            V = evaluate_on_grid(bias, eval_spec)
            bias = BiasState(grid=BiasGrid(
                spec=eval_spec, V=V,
                dV=torch.zeros((eval_spec.ndim, *eval_spec.shape),
                               device=V.device)), n_hills=0)
        return free_energy(self.hills, bias, kT).cpu().numpy()

    def grid_coords(self, d: int = 0) -> np.ndarray:
        return self.grid_spec.axis_coords(d).cpu().numpy()
