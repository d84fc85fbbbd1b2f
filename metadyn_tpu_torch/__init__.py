"""metadyn_tpu_torch — the PyTorch and CUDA port of ``metadyn_tpu``.

Same module layout and data contracts as the JAX package, which stays the
reference.  On a CUDA device the packed engine's pair force and order-CV
sweeps run as hand-written Hopper kernels (``csrc/``, built with nvcc at
first use); on the CPU everything runs as plain PyTorch.  The
particle-order engines (all-pairs, neighbour list), their integrators and
CVs are plain PyTorch on every device, as the reference runs them as XLA.  This package imports torch and
numpy, never jax.
"""

from .core.box import Box, minimum_image, unwrap
from .core.state import (
    State, System, kinetic_energy, make_state, make_system, pressure,
    temperature, thermal_velocities,
)
from .core.engine import (
    AllPairsEngine, EngineAux, NeighborEngine, run_md_blocks,
)
from .core.forcefield import ForceField
from .core.packed_engine import PackedAux, PackedEngine
from .ops.packed import (
    PackedSpec, PackedState, bond_partner_attrs, pair_scale_tables,
)
from .integrate.packed import (
    make_packed_langevin_step, make_packed_npt_scr_step, make_packed_nve_step,
)
from .integrate.npt import make_npt_scr_step
from .integrate.base import run_steps
from .integrate.langevin import make_langevin_step, make_nve_step
from .integrate.nvt import make_nvt_bdp_step, make_nvt_nh_step
from .ops.cell_list import CellSpec, build_neighbor_list
from .ops.pairs import (
    PairParams, lj_kernel, lj_tables, soft_kernel, soft_tables, wca_tables,
    xplor_tables,
)
from .cv.lamellar import LamellarOP
from .cv.mesh import MeshOrderParameter
from .cv.simple import AxisPosition, EnergyCV, PotentialEnergyCV
from .cv.steinhardt import SteinhardtQl
from .cv.packed import PackedLamellar, PackedMesh, PackedMSD
from .cv.aspect_ratio import AspectRatio, box_bias_fn_for
from .cv.msd import MSD
from .cv.packed_order import (
    PackedCoordination, PackedSteinhardtQl, make_fused_order_force,
)
from .bias.grid import BiasGrid, GridSpec
from .bias.metad import (
    FLUX_TEMPERED, STANDARD, WELL_TEMPERED, BiasState, HillSpec, WallSpec,
    free_energy,
)
from .bias.flux import (
    FLUX, VISITS, FluxState, accumulate, bin_of, round_trips, update_bias,
)
from .sampler import MetadSampler, lag_supported, make_biased_force
from .flux_sampler import FluxTemperedSampler
from .parallel.walkers import WalkerSampler
from .parallel.mesh import ShardedPackedMesh
from .parallel.spatial import SpatialPackedEngine
from .parallel.mesh2d import ShardedPackedMesh2D
from .parallel.spatial2d import SpatialPackedEngine2D
from .bias.hill_list import HillListBias
from .utils.lattice import fcc_lattice, polymer_melt, sc_lattice

__all__ = [
    "Box", "minimum_image", "unwrap", "State", "System", "kinetic_energy",
    "make_state", "make_system", "pressure", "temperature",
    "thermal_velocities",
    "AllPairsEngine", "EngineAux", "NeighborEngine", "run_md_blocks",
    "ForceField", "run_steps", "make_langevin_step", "make_nve_step",
    "make_nvt_bdp_step", "make_nvt_nh_step", "CellSpec",
    "build_neighbor_list", "PairParams", "lj_kernel", "lj_tables",
    "soft_kernel", "soft_tables", "wca_tables", "xplor_tables",
    "LamellarOP", "MeshOrderParameter", "AxisPosition", "EnergyCV",
    "PotentialEnergyCV", "SteinhardtQl",
    "PackedAux", "PackedEngine",
    "PackedSpec", "PackedState", "bond_partner_attrs", "pair_scale_tables",
    "make_packed_langevin_step", "make_packed_nve_step",
    "make_packed_npt_scr_step", "make_npt_scr_step", "PackedLamellar",
    "PackedMesh", "PackedMSD", "AspectRatio", "box_bias_fn_for", "MSD",
    "PackedCoordination",
    "PackedSteinhardtQl", "make_fused_order_force", "BiasGrid", "GridSpec",
    "FLUX_TEMPERED", "STANDARD", "WELL_TEMPERED", "BiasState", "HillSpec", "WallSpec",
    "free_energy", "FLUX", "VISITS", "FluxState", "accumulate", "bin_of",
    "round_trips", "update_bias", "MetadSampler", "lag_supported",
    "make_biased_force", "FluxTemperedSampler", "WalkerSampler",
    "ShardedPackedMesh", "SpatialPackedEngine", "ShardedPackedMesh2D",
    "SpatialPackedEngine2D", "HillListBias", "fcc_lattice",
    "polymer_melt", "sc_lattice",
]
