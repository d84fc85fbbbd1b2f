"""Multiple-walker metadynamics on one device (counterpart of
``metadyn_tpu/parallel/walkers.py``).

W replicas of one system share one bias grid, as the reference's MPI
partitions do: within a stride each walker runs under the same frozen
grid, each computes its well-tempered hill height against that
pre-stride grid, and the W hill fields are summed and added at once.  The
reference runs one walker per chip (``shard_map`` over a ``"walkers"``
axis, one ``psum`` of the field per stride); here all W walkers live on
one device as a walker batch (``core/batch.py``: every state tensor gains
a leading dimension W) and the ``psum`` is a sum over that dimension.

Where the engine and every CV take the batch (``walker_batch``: the
packed engine and the slab engine on the walkers x space product,
``PackedLamellar``, ``PackedMSD``, ``AspectRatio``, ``PotentialEnergyCV``),
a stride runs once for all W walkers, each in a box of its own (NPT
walkers): one pair-kernel launch per force call (per shard), one
device-to-host read per rebuild block, so the host's work per stride is
one walker's.  Any other engine or CV (the particle-order engines, a
plain force callable, the order and mesh CVs) steps the walkers one after
another through the stride, each alone on its own state and aux.

Random numbers come from one ``torch.Generator`` on the engine's device,
seeded from ``seed``: the batch draws its (W, 3, Npad) noise at once, the
one-by-one walkers draw theirs in turn.  The per-stride metrics of
``chunks_per_block`` strides reach the host in one transfer, each with a
leading walker dimension; the hill log gets one row per (stride, walker)
from them.  ``save_checkpoint`` keeps the walkers' states and auxes, the
generator's state, the bias, the step and the measurement's accumulators:
a resumed run repeats the straight one bit for bit.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..bias.grid import GridSpec, hill_field, value_and_grad
from ..bias.metad import (
    BiasState, HillRecord, HillSpec, free_energy, hill_height,
)
from ..core.batch import batch_size, stack_walkers, walkers
from ..core.state import System
from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.hill_log import HillLog
from ..sampler import (
    _CallableEngine, _metrics_to_host, cv_stack, make_bias_force_parts,
    make_biased_force, wants_bias,
)
from ..utils.profiling import phase


def _nearest_node(spec: GridSpec, s: torch.Tensor) -> tuple:
    """Per-dimension nearest-grid-node indices of CV points s (..., d)."""
    idx = []
    for d in range(spec.ndim):
        b = torch.round((s[..., d] - spec.lo[d]) / spec.spacing(d)).to(
            torch.int64)
        n = spec.shape[d]
        idx.append(torch.remainder(b, n) if spec.periodic[d]
                   else torch.clamp(b, 0, n - 1))
    return tuple(idx)


def takes_batch(engine, cvs) -> bool:
    """True when the engine and every CV step a walker batch at once."""
    return (getattr(engine, "walker_batch", False)
            and all(getattr(cv, "walker_batch", False) for cv in cvs))


def walker_groups(engine, cvs, states) -> list:
    """The walkers as the stride steps them: the whole batch as one group
    where :func:`takes_batch`, else one group per walker."""
    return [states] if takes_batch(engine, cvs) else walkers(states)


def join_groups(values: list, batched: bool) -> torch.Tensor:
    """Per-group tensors → one with a leading walker dimension."""
    return values[0] if batched else torch.stack(values)


def make_walker_chunk(
    engine,
    cvs,
    system: System,
    hills: HillSpec,
    integrator_factory: Callable,
    walls=None,
    cv_hist_spec: Optional[GridSpec] = None,
    add_hills: bool = True,
    bias_every: int = 1,
    batched: bool = False,
):
    """One stride of every walker: ``chunk(groups, auxs, generator, bias,
    measure) -> (groups, auxs, new_bias, (s, h), metrics, hist)``.

    ``groups`` are the walker groups (:func:`walker_groups`), ``batched``
    whether there is one group of all W.  Each group runs its rebuild
    blocks of MD steps under ``bias``, then the energy refresh and its CVs;
    then each walker's hill height is taken against ``bias`` (the
    pre-stride grid) and the W hill fields are summed onto it, ``n_hills``
    growing by W; ``add_hills=False`` leaves the bias as it is (heights 0).
    ``s`` (W, d) and ``h`` (W,) are the hill records, ``metrics`` device
    tensors with a leading walker dimension.

    ``bias_every`` > 1 holds each walker's bias force over that many steps
    between CV evaluations, as in ``MetadSampler``.  With ``measure`` (and
    a ``cv_hist_spec``) ``hist`` is the stride's walker-summed CV visit
    histogram: one count per (step, walker), or ``bias_every`` per
    evaluation under multiple time stepping; else None."""
    biased_force = make_biased_force(engine, cvs, system, walls)
    eval_bias, apply_force = make_bias_force_parts(engine, cvs, system,
                                                   walls)
    r = min(engine.rebuild_every, hills.stride)
    if hills.stride % r:
        raise ValueError(f"stride={hills.stride} must be a multiple of "
                         f"rebuild_every={r}")
    if bias_every > 1 and r % bias_every:
        raise ValueError(f"bias_every={bias_every} must divide "
                         f"min(rebuild_every, stride)={r}")
    n_blocks = hills.stride // r
    spec_h = cv_hist_spec
    want_bias = wants_bias(integrator_factory)
    if want_bias and bias_every > 1:
        raise ValueError("bias_every > 1 does not take a box-coupled "
                         "(two-argument) integrator factory")

    def visit(hist, s, weight: float):
        if hist is None:
            return None
        idx = _nearest_node(spec_h, s)
        flat = torch.zeros_like(idx[0])
        for d, i in enumerate(idx):
            flat = flat * spec_h.shape[d] + i
        return hist.reshape(-1).index_add(
            0, flat.reshape(-1), torch.full(flat.reshape(-1).shape, weight,
                                            device=hist.device)
        ).reshape(hist.shape)

    def group_stride(st, ax, gen, bias, hist):
        for _ in range(n_blocks):
            with phase("nlist_rebuild"):
                st, ax = engine.rebuild(st, ax)
            with phase("md_steps"):
                if bias_every > 1:
                    for _ in range(r // bias_every):
                        with phase("cv_eval"):
                            g, dVds, sv = eval_bias(st, ax, bias)
                            hist = visit(hist, sv, float(bias_every))
                        step_fn = integrator_factory(
                            lambda s2, ax=ax, g=g, dVds=dVds:
                            apply_force(s2, ax, g, dVds))
                        for _ in range(bias_every):
                            st = step_fn(st, gen)
                else:
                    force_fn = (lambda s2, ax=ax:
                                biased_force(s2, ax, bias))
                    step_fn = (integrator_factory(force_fn, bias)
                               if want_bias else integrator_factory(force_fn))
                    for _ in range(r):
                        st = step_fn(st, gen)
                        if hist is not None:
                            hist = visit(hist, cv_stack(cvs, st, system),
                                         1.0)
        with phase("energy_refresh"):
            st = engine.refresh_energy(st, ax)
        with phase("cv_eval"):
            s = cv_stack(cvs, st, system)
        return st, ax, s, engine.metrics(st, ax), hist

    def chunk(groups, auxs, gen, bias: BiasState, measure: bool = False):
        hist = None
        if measure and spec_h is not None:
            hist = torch.zeros(spec_h.shape, dtype=torch.float32,
                               device=spec_h.device)
        out_g, out_a, ss, ms = [], [], [], []
        for st, ax in zip(groups, auxs):
            st, ax, s, m, hist = group_stride(st, ax, gen, bias, hist)
            out_g.append(st)
            out_a.append(ax)
            ss.append(s)
            ms.append(m)
        s = join_groups(ss, batched)
        n_w = s.shape[0]
        with phase("hill_deposit"):
            if add_hills:
                # each walker's height against the pre-stride grid, then
                # the W fields summed (the reference's psum) and added
                h = hill_height(hills, bias, s)
                dV, ddV = hill_field(bias.grid.spec, s, h)
                new_bias = BiasState(
                    grid=bias.grid.replace(V=bias.grid.V + dV.sum(0),
                                           dV=bias.grid.dV + ddV.sum(0)),
                    n_hills=bias.n_hills + n_w)
            else:
                h = torch.zeros(n_w, dtype=torch.float32, device=s.device)
                new_bias = bias
        V_here, _ = value_and_grad(new_bias.grid, s)
        spec = bias.grid.spec
        metrics = {
            "cv": s,
            "hill_height": h,
            "bias_V": V_here,
            "cv_out_of_grid": torch.any((s < spec.lo) | (s > spec.hi),
                                        dim=-1),
            **{k: join_groups([m[k] for m in ms], batched) for k in ms[0]},
        }
        return out_g, out_a, new_bias, (s, h), metrics, hist

    return chunk


class WalkerSampler:
    """W walkers with one shared bias grid on one device: the reference's
    ``WalkerSampler``, where W is the leading dimension of ``states``
    (a walker batch, ``core/batch.stack_walkers``) instead of a mesh
    axis.  ``engine`` is an engine-protocol object or a plain apply-style
    force callable on the particle-order state."""

    def __init__(
        self,
        system: System,
        states,
        engine,
        cvs,
        grid_spec: GridSpec,
        hills: HillSpec,
        integrator_factory,
        seed: int = 0,
        initial_bias: Optional[BiasState] = None,
        walls=None,
        hill_file: Optional[str] = None,
        overwrite: bool = False,
        chunks_per_block: int = 16,
        measure_cv_hist: bool = False,
        add_hills: bool = True,
        bias_every: int = 1,
    ):
        """``measure_cv_hist=True`` lets :meth:`begin_measurement` start
        the walker-summed per-step CV visit histogram (one more CV
        evaluation per step), which :meth:`free_energy` reweights.
        ``bias_every`` > 1 is per-walker bias-force multiple time
        stepping; ``add_hills=False`` freezes the shared bias."""
        n_walkers = batch_size(states)
        if n_walkers is None:
            raise ValueError("WalkerSampler: states must be a walker batch "
                             "(core.batch.stack_walkers)")
        if not hasattr(engine, "force_into"):
            engine = _CallableEngine(engine, system)
        self.n_walkers = n_walkers
        self.engine = engine
        self.system = system
        self.cvs = list(cvs)
        if len(self.cvs) != grid_spec.ndim:
            raise ValueError("one grid dimension per CV")
        self.hills = hills
        self.grid_spec = grid_spec
        self.batched = takes_batch(engine, self.cvs)
        bias = (initial_bias if initial_bias is not None
                else BiasState.zeros(grid_spec))
        self._chunk = make_walker_chunk(
            engine, self.cvs, system, hills, integrator_factory, walls=walls,
            cv_hist_spec=grid_spec if measure_cv_hist else None,
            add_hills=add_hills, bias_every=bias_every,
            batched=self.batched)

        # each walker's aux and forces at its start (two force calls: the
        # engine's init and the first biased force)
        biased_force = make_biased_force(engine, self.cvs, system, walls)
        groups, auxs = [], []
        for st in walker_groups(engine, self.cvs, states):
            st, aux = engine.init(st)
            groups.append(biased_force(st, aux, bias))
            auxs.append(aux)
        self.groups = groups
        self.auxs = auxs
        device = getattr(engine, "device", engine.positions(groups[0]).device)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.bias = bias
        self.step = 0
        self._block = chunks_per_block
        self._measure = measure_cv_hist
        self._meas_h: Optional[np.ndarray] = None
        self._meas_V: Optional[np.ndarray] = None
        self._meas_n = 0
        self.history: list[dict] = []
        self.hill_log = (HillLog(hill_file, self, overwrite=overwrite)
                         if hill_file and add_hills else None)

    @property
    def states(self):
        """The walkers' states as one walker batch."""
        return self.groups[0] if self.batched else stack_walkers(self.groups)

    def run(self, n_steps: int) -> list[dict]:
        """Run ``n_steps`` per walker (a multiple of the stride).  Returns
        the per-stride metric dicts (numpy, a leading walker dimension)."""
        stride = self.hills.stride
        if n_steps % stride:
            raise ValueError("n_steps must be a multiple of stride")
        measure = self._meas_h is not None
        remaining = n_steps // stride
        out = []
        while remaining > 0:
            n = min(self._block, remaining)
            block, hacc, vacc = [], None, None
            for _ in range(n):
                (self.groups, self.auxs, self.bias, _hill, metrics,
                 hist) = self._chunk(self.groups, self.auxs, self.generator,
                                     self.bias, measure)
                self.step += stride
                block.append(metrics)
                if measure:
                    hacc = hist if hacc is None else hacc + hist
                    V = self.bias.grid.V
                    vacc = V if vacc is None else vacc + V
            host = _metrics_to_host(block)
            if measure:
                self._meas_h += hacc.cpu().numpy()
                self._meas_V += vacc.cpu().numpy()
                self._meas_n += n
            if self.hill_log is not None:
                self._append_hills(host, self.step - n * stride)
            out.extend(host)
            remaining -= n
        self.history.extend(out)
        return out

    def _append_hills(self, host: list, step0: int) -> None:
        """One hill-file row per (stride, walker), the reference's order:
        stride by stride, walkers in order within each."""
        stride = self.hills.stride
        w = self.n_walkers
        steps = np.repeat(step0 + stride * (1 + np.arange(len(host))), w)
        self.hill_log.append(HillRecord(
            step=steps,
            center=np.concatenate([m["cv"] for m in host]).reshape(
                -1, self.grid_spec.ndim),
            height=np.concatenate([m["hill_height"] for m in host])))

    # --- the reweighted FES estimator ---------------------------------------
    def begin_measurement(self) -> None:
        """Start (or reset) the measurement: later strides accumulate the
        walker-summed per-step CV visit histogram h and the per-stride
        average V̄ of the grid, and :meth:`free_energy` returns
        F̂(s) = −V̄(s) − kT·ln h(s).  Needs ``measure_cv_hist=True``."""
        if not self._measure:
            raise AssertionError("construct with measure_cv_hist=True")
        self._meas_h = np.zeros(self.grid_spec.shape)
        self._meas_V = np.zeros(self.grid_spec.shape)
        self._meas_n = 0

    def free_energy(self, kT: float) -> np.ndarray:
        """The FES, min-shifted to 0: reweighted while a measurement is
        active, else the (well-)tempered −V rescaling."""
        if self._meas_n and self._meas_h is not None:
            Vbar = self._meas_V / self._meas_n
            F = -Vbar - kT * np.log(np.maximum(self._meas_h, 1.0))
        else:
            F = free_energy(self.hills, self.bias, kT).cpu().numpy()
        return F - F.min()

    def grid_coords(self, d: int = 0) -> np.ndarray:
        return self.grid_spec.axis_coords(d).cpu().numpy()

    # --- persistence --------------------------------------------------------
    def dump_grid(self, path: str) -> None:
        from ..io.grid_file import dump_grid
        dump_grid(path, self.bias, mode=self.hills.mode,
                  deltaT=float(self.hills.deltaT))

    def _carry(self):
        return (self.groups, self.auxs, self.generator, self.bias, self.step)

    def save_checkpoint(self, path: str) -> None:
        """Persist the walkers, the generator, the bias, the step and the
        measurement's accumulators (losing them would change
        :meth:`free_energy` after a resume)."""
        extra = {}
        if self._meas_h is not None:
            extra.update(meas_h=self._meas_h, meas_V=self._meas_V,
                         meas_n=self._meas_n)
        save_checkpoint(path, self._carry(), extra=extra)

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint of a sampler built as this one was."""
        (self.groups, self.auxs, self.generator, self.bias,
         self.step), extras = load_checkpoint(path, self._carry())
        if "meas_h" in extras:
            self._meas_h = np.asarray(extras["meas_h"])
            self._meas_V = np.asarray(extras["meas_V"])
            self._meas_n = int(extras["meas_n"])
