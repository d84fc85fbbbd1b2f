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
``pair_kind``), ``GridSpec``, ``BiasState`` (V, dV, n_hills), the lamellar
CV's lattice vectors and phases, the packed order CVs' parameters (Q_l and
coordination) and the packed mesh CV's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bias.grid import BiasGrid, GridSpec
from .bias.metad import BiasState
from .core.box import Box
from .cv.packed import PackedLamellar, PackedMesh
from .cv.packed_order import PackedCoordination, PackedSteinhardtQl
from .ops.packed import PackedSpec, PackedState

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
