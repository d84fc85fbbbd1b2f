"""metadyn_tpu_torch — the PyTorch and CUDA port of ``metadyn_tpu``.

Same module layout and data contracts as the JAX package, which stays the
reference.  On a CUDA device the pair force and the order-CV sweeps run as
hand-written Hopper kernels (``csrc/``, built with nvcc at first use); on
the CPU everything runs as plain PyTorch.  This package imports torch and
numpy, never jax.
"""

from .core.box import Box
from .core.state import System, make_system
from .core.packed_engine import PackedAux, PackedEngine
from .ops.packed import (
    PackedSpec, PackedState, bond_partner_attrs, pair_scale_tables,
)
from .integrate.packed import make_packed_langevin_step, make_packed_nve_step
from .cv.packed import PackedLamellar, PackedMesh
from .cv.packed_order import (
    PackedCoordination, PackedSteinhardtQl, make_fused_order_force,
)
from .bias.grid import BiasGrid, GridSpec
from .bias.metad import (
    STANDARD, WELL_TEMPERED, BiasState, HillSpec, WallSpec, free_energy,
)
from .bias.flux import (
    FLUX, VISITS, FluxState, accumulate, bin_of, round_trips, update_bias,
)
from .sampler import MetadSampler, lag_supported
from .flux_sampler import FluxTemperedSampler
from .utils.lattice import fcc_lattice, polymer_melt, sc_lattice

__all__ = [
    "Box", "System", "make_system", "PackedAux", "PackedEngine",
    "PackedSpec", "PackedState", "bond_partner_attrs", "pair_scale_tables",
    "make_packed_langevin_step", "make_packed_nve_step", "PackedLamellar",
    "PackedMesh", "PackedCoordination",
    "PackedSteinhardtQl", "make_fused_order_force", "BiasGrid", "GridSpec",
    "STANDARD", "WELL_TEMPERED", "BiasState", "HillSpec", "WallSpec",
    "free_energy", "FLUX", "VISITS", "FluxState", "accumulate", "bin_of",
    "round_trips", "update_bias", "MetadSampler", "lag_supported",
    "FluxTemperedSampler", "fcc_lattice", "polymer_melt", "sc_lattice",
]
