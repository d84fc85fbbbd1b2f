"""metadyn_tpu_torch — the PyTorch and CUDA port of ``metadyn_tpu``.

Same module layout and data contracts as the JAX package, which stays the
reference.  On a CUDA device the pair force runs as a hand-written Hopper
kernel (``csrc/``, built with nvcc at first use); on the CPU everything runs
as plain PyTorch.  This package imports torch and numpy, never jax.
"""

from .core.box import Box
from .core.state import System, make_system
from .core.packed_engine import PackedAux, PackedEngine
from .ops.packed import PackedSpec, PackedState
from .integrate.packed import make_packed_langevin_step, make_packed_nve_step
from .cv.packed import PackedLamellar
from .bias.grid import BiasGrid, GridSpec
from .bias.metad import (
    STANDARD, WELL_TEMPERED, BiasState, HillSpec, WallSpec, free_energy,
)
from .sampler import MetadSampler

__all__ = [
    "Box", "System", "make_system", "PackedAux", "PackedEngine",
    "PackedSpec", "PackedState", "make_packed_langevin_step",
    "make_packed_nve_step", "PackedLamellar", "BiasGrid", "GridSpec",
    "STANDARD", "WELL_TEMPERED", "BiasState", "HillSpec", "WallSpec",
    "free_energy", "MetadSampler",
]
