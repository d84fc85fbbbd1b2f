"""State carried between the JAX reference package and this port.

An MD engine has no weights; what carries across is state.  The ``*_from``
functions take any object with the reference's field names (a
``metadyn_tpu`` object, or a namespace of numpy arrays) and read each field
with ``np.asarray``, so this module never imports jax.  The ``*_arrays``
functions go back: they return plain dicts of numpy arrays and Python
values under the reference's field names, ready for its constructors.

Covered: ``PackedState`` with its ``Box`` (``typ`` and every attr: the
bond partners ``bp*``, the CV coefficients ``lam_*``/``mesh_*``, the lagged
path's ``held_g*``), ``PackedSpec`` (every field: scale tables, bonds,
``pair_kind``), ``GridSpec``, ``BiasState`` (V, dV, n_hills), the flux
histograms ``FluxState`` (hist, flux_up, flux_down, prev_bin), the lamellar
CV's lattice vectors and phases, the packed order CVs' parameters (Q_l and
coordination) and the packed mesh CV's; and the particle-order path:
``State``, ``PairParams``, ``CellSpec``, and the CVs ``LamellarOP``,
``MeshOrderParameter`` and ``SteinhardtQl``.  Walkers: a reference state
stacked on a leading walker axis (what its ``WalkerSampler`` takes), packed
or particle-order, ↔ the port's walker batch (``walker_state_from``,
``walker_state_arrays``), each walker with its own box (NPT walkers'
boxes differ).  The box CVs: ``MSD`` (its reference positions),
``PackedMSD`` (its reference positions are the ``msd_*`` attrs of the
state, ``cv.packed.msd_reference_attrs``) and ``AspectRatio``; the slab
engine's mesh CV ``ShardedPackedMesh`` and the 2-D blocks' pencil-FFT
``ShardedPackedMesh2D`` (their coefficients are the state's
``mesh_<name>`` attr, as the single-grid ``PackedMesh``'s); the hill-list
bias ``HillListBias``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bias.flux import FluxState
from .bias.grid import BiasGrid, GridSpec
from .bias.metad import BiasState
from types import SimpleNamespace

from .core.batch import stack_walkers, walkers
from .core.box import Box
from .core.state import State
from .cv.lamellar import LamellarOP
from .cv.mesh import MeshOrderParameter
from .cv.aspect_ratio import AspectRatio
from .cv.msd import MSD
from .cv.packed import PackedLamellar, PackedMesh, PackedMSD
from .cv.packed_order import PackedCoordination, PackedSteinhardtQl
from .cv.steinhardt import SteinhardtQl
from .ops.cell_list import CellSpec
from .ops.packed import PackedSpec, PackedState
from .ops.pairs import PairParams

_STATE_TENSORS = ("r", "v", "f", "image", "ref_r", "pid", "typ", "slot_of",
                  "potential_energy", "virial")


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(x)), device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def box_from(obj, device) -> Box:
    """The box with its host floats: ``L_host`` and, for a tilted box,
    ``tilt_host`` (the kernels read the box from those)."""
    L = np.asarray(obj.L, np.float32).reshape(3)
    if obj.tilt is None:
        return Box.from_lengths(*L, device=device)
    return Box.triclinic(*L, device,
                         *np.asarray(obj.tilt, np.float32).reshape(3))


def box_arrays(box: Box) -> dict:
    return {"L": _np(box.L),
            "tilt": None if box.tilt is None else _np(box.tilt)}


def packed_state_from(obj, device) -> PackedState:
    fields = {k: _t(getattr(obj, k), device) for k in _STATE_TENSORS}
    attrs = {k: _t(v, device) for k, v in obj.attrs.items()}
    return PackedState(**fields, attrs=attrs, box=box_from(obj.box, device))


def packed_state_arrays(state: PackedState) -> dict:
    """Fields of ``state`` as numpy; ``box`` is a dict (see box_arrays)."""
    out = {k: _np(getattr(state, k)) for k in _STATE_TENSORS}
    out["attrs"] = {k: _np(v) for k, v in state.attrs.items()}
    out["box"] = box_arrays(state.box)
    return out


def packed_spec_from(obj) -> PackedSpec:
    return PackedSpec(**{f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(PackedSpec)})


def packed_spec_fields(spec: PackedSpec) -> dict:
    return {f.name: getattr(spec, f.name)
            for f in dataclasses.fields(PackedSpec)}


def grid_spec_from(obj, device) -> GridSpec:
    return GridSpec(lo=_t(obj.lo, device), hi=_t(obj.hi, device),
                    sigma=_t(obj.sigma, device), shape=tuple(obj.shape),
                    periodic=tuple(obj.periodic))


def grid_spec_arrays(spec: GridSpec) -> dict:
    return {"lo": _np(spec.lo), "hi": _np(spec.hi), "sigma": _np(spec.sigma),
            "shape": spec.shape, "periodic": spec.periodic}


def bias_state_from(obj, device) -> BiasState:
    spec = grid_spec_from(obj.grid.spec, device)
    grid = BiasGrid(spec=spec, V=_t(obj.grid.V, device),
                    dV=_t(obj.grid.dV, device))
    return BiasState(grid=grid, n_hills=int(np.asarray(obj.n_hills)))


def bias_state_arrays(bias: BiasState) -> dict:
    """``V``, ``dV``, ``n_hills`` and the grid spec's arrays."""
    return {"V": _np(bias.grid.V), "dV": _np(bias.grid.dV),
            "n_hills": np.int32(bias.n_hills),
            "spec": grid_spec_arrays(bias.grid.spec)}


def flux_state_from(obj, device) -> FluxState:
    return FluxState(hist=_t(obj.hist, device),
                     flux_up=_t(obj.flux_up, device),
                     flux_down=_t(obj.flux_down, device),
                     prev_bin=_t(np.asarray(obj.prev_bin, np.int32), device))


def flux_state_arrays(flux: FluxState) -> dict:
    return {"hist": _np(flux.hist), "flux_up": _np(flux.flux_up),
            "flux_down": _np(flux.flux_down),
            "prev_bin": np.int32(flux.prev_bin.item())}


def lamellar_from(obj, device) -> PackedLamellar:
    return PackedLamellar(np.asarray(obj.lattice_vectors), obj.n_real,
                          device, phases=np.asarray(obj.phases),
                          name=obj.name)


def lamellar_arrays(cv: PackedLamellar) -> dict:
    return {"lattice_vectors": _np(cv.lattice_vectors),
            "phases": _np(cv.phases), "n_real": cv.n_real, "name": cv.name}


def steinhardt_from(obj) -> PackedSteinhardtQl:
    return PackedSteinhardtQl(packed_spec_from(obj.spec), r_cut=obj.r_cut,
                              l=obj.l, name=obj.name)


def steinhardt_arrays(cv: PackedSteinhardtQl) -> dict:
    """``spec`` is a dict of the spec's fields (see packed_spec_fields)."""
    return {"spec": packed_spec_fields(cv.spec), "r_cut": cv.r_cut,
            "l": cv.l, "name": cv.name}


def coordination_from(obj) -> PackedCoordination:
    return PackedCoordination(packed_spec_from(obj.spec), r0=obj.r0,
                              name=obj.name, r_cut=obj.r_cut)


def coordination_arrays(cv: PackedCoordination) -> dict:
    """``spec`` is a dict of the spec's fields (see packed_spec_fields)."""
    return {"spec": packed_spec_fields(cv.spec), "r0": cv.r0,
            "name": cv.name, "r_cut": cv.r_cut}


def mesh_from(obj, device) -> PackedMesh:
    u_k = getattr(obj, "u_k", None)
    return PackedMesh(tuple(obj.mesh_shape), obj.n_real, k0=obj.k0,
                      width=obj.width,
                      u_k=None if u_k is None else np.asarray(u_k),
                      name=obj.name, assign_order=obj.assign_order,
                      device=device)


def mesh_arrays(cv: PackedMesh) -> dict:
    return {"u_k": None if cv.u_k is None else _np(cv.u_k),
            "k0": cv.k0, "width": cv.width, "mesh_shape": cv.mesh_shape,
            "n_real": cv.n_real, "name": cv.name,
            "assign_order": cv.assign_order}


def sharded_mesh_from(obj, spec: PackedSpec, devices):
    """The reference's ``ShardedPackedMesh`` on the port's slab shards
    ``devices`` (its halo kept)."""
    from .parallel.mesh import ShardedPackedMesh
    return ShardedPackedMesh(tuple(obj.mesh_shape), spec, devices,
                             obj.n_real, obj.k0, width=obj.width,
                             halo=obj.halo, name=obj.name,
                             assign_order=obj.assign_order)


def sharded_mesh_arrays(cv) -> dict:
    return {"k0": cv.k0, "width": cv.width, "mesh_shape": cv.mesh_shape,
            "n_real": cv.n_real, "halo": cv.halo, "name": cv.name,
            "assign_order": cv.assign_order}


def sharded_mesh2d_from(obj, spec: PackedSpec, devices, shape):
    """The reference's ``ShardedPackedMesh2D`` on the port's (n_x, n_y)
    blocks of ``devices`` (its per-axis halo kept; its coefficients are the
    state's ``mesh_<name>`` attr)."""
    from .parallel.mesh2d import ShardedPackedMesh2D
    return ShardedPackedMesh2D(tuple(obj.mesh_shape), spec, devices, shape,
                               obj.n_real, obj.k0, width=obj.width,
                               halo=tuple(obj.halo), name=obj.name,
                               assign_order=obj.assign_order)


def hill_list_from(obj, device):
    """The reference's ``HillListBias`` (buffer, widths, count, overflow
    flag and spill grid) on ``device``."""
    from .bias.hill_list import HillListBias
    spill = None
    if obj.spill is not None:
        spill = BiasGrid(spec=grid_spec_from(obj.spill.spec, device),
                         V=_t(obj.spill.V, device),
                         dV=_t(obj.spill.dV, device))
    return HillListBias(
        centers=_t(obj.centers, device), heights=_t(obj.heights, device),
        sigma=_t(obj.sigma, device),
        n_hills=_t(np.asarray(obj.n_hills, np.int32), device),
        overflowed=_t(np.asarray(obj.overflowed, bool), device), spill=spill)


def packed_msd_from(obj) -> PackedMSD:
    return PackedMSD(n_real=obj.n_real, name=obj.name)


def msd_from(obj, device) -> MSD:
    return MSD(ref_pos=_t(obj.ref_pos, device), name=obj.name)


def msd_arrays(cv: MSD) -> dict:
    return {"ref_pos": _np(cv.ref_pos), "name": cv.name}


def aspect_ratio_from(obj) -> AspectRatio:
    return AspectRatio(axis_a=obj.axis_a, axis_b=obj.axis_b, name=obj.name)


_PARTICLE_TENSORS = ("pos", "vel", "force", "image", "potential_energy",
                     "virial", "xi")


def state_from(obj, device) -> State:
    """The particle-order ``State`` (``image`` int32)."""
    fields = {k: _t(getattr(obj, k), device) for k in _PARTICLE_TENSORS}
    fields["image"] = fields["image"].to(torch.int32)
    return State(**fields, box=box_from(obj.box, device))


def state_arrays(state: State) -> dict:
    """Fields of ``state`` as numpy; ``box`` is a dict (see box_arrays)."""
    out = {k: _np(getattr(state, k)) for k in _PARTICLE_TENSORS}
    out["box"] = box_arrays(state.box)
    return out


def pair_params_from(obj, device) -> PairParams:
    r_on = getattr(obj, "r_on", None)
    return PairParams(epsilon=_t(obj.epsilon, device),
                      sigma=_t(obj.sigma, device),
                      r_cut=_t(obj.r_cut, device),
                      shift_const=_t(obj.shift_const, device),
                      r_on=None if r_on is None else _t(r_on, device))


def cell_spec_from(obj) -> CellSpec:
    return CellSpec(cells_per_dim=tuple(int(c) for c in obj.cells_per_dim),
                    cell_capacity=int(obj.cell_capacity),
                    max_neighbors=int(obj.max_neighbors),
                    r_cut=float(obj.r_cut), skin=float(obj.skin))


def lamellar_op_from(obj, device) -> LamellarOP:
    return LamellarOP(mode=_t(obj.mode, device),
                      lattice_vectors=_t(obj.lattice_vectors, device),
                      phases=_t(obj.phases, device), name=obj.name)


def mesh_op_from(obj, device) -> MeshOrderParameter:
    return MeshOrderParameter(
        mode=_t(obj.mode, device),
        u_k=None if obj.u_k is None else _t(obj.u_k, device),
        k0=obj.k0, width=float(obj.width),
        mesh_shape=tuple(int(x) for x in obj.mesh_shape), name=obj.name,
        assign_order=int(obj.assign_order))


def steinhardt_ql_from(obj) -> SteinhardtQl:
    return SteinhardtQl(r_cut=float(obj.r_cut), l=int(obj.l),
                        row_block=int(obj.row_block), name=obj.name)


def _walker_row(obj, w: int):
    """Walker ``w`` of a stacked reference state, as a namespace of its
    fields' rows (the attrs and the box too)."""
    names = _STATE_TENSORS if hasattr(obj, "r") else _PARTICLE_TENSORS
    row = {k: np.asarray(getattr(obj, k))[w] for k in names}
    if hasattr(obj, "attrs"):
        row["attrs"] = {k: np.asarray(v)[w] for k, v in obj.attrs.items()}
    tilt = obj.box.tilt
    row["box"] = SimpleNamespace(
        L=np.asarray(obj.box.L)[w],
        tilt=None if tilt is None else np.asarray(tilt)[w])
    return SimpleNamespace(**row)


def walker_state_from(obj, device):
    """A reference state stacked on a leading walker axis (``PackedState``
    or ``State``) → the port's walker batch on ``device``."""
    packed = hasattr(obj, "r")
    n_walkers = np.asarray(obj.r if packed else obj.pos).shape[0]
    one = packed_state_from if packed else state_from
    return stack_walkers([one(_walker_row(obj, w), device)
                          for w in range(n_walkers)])


def _stack_arrays(dicts: list):
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack_arrays([d[k] for d in dicts]) for k in first}
    return None if first is None else np.stack(dicts)


def walker_state_arrays(batch) -> dict:
    """The port's walker batch → the reference's field names, every array
    with the leading walker axis (``box`` a dict of (W, 3) arrays)."""
    one = packed_state_arrays if hasattr(batch, "r") else state_arrays
    return _stack_arrays([one(st) for st in walkers(batch)])
