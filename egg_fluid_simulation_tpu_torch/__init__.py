"""egg_fluid_simulation_tpu_torch — the egg-fluid XPBD simulation on PyTorch
and CUDA.

The port of ``egg_fluid_simulation_tpu`` (JAX on a TPU) to PyTorch with
kernels written by hand for NVIDIA Hopper (``csrc/``). It imports neither
JAX nor the JAX package; that package stays the reference the port's tests
hold it against.

Public surface::

    from egg_fluid_simulation_tpu_torch import (
        SimulationHandler, SolverOptions, Path,
        default_white_config, default_yolk_config, fluid_config,
    )

plus the modules ``checkpoint`` (npz save / load, the JAX package's format)
and ``demo`` (the scripted demo session and its command line).
"""

from .config import (default_white_config, default_yolk_config, fluid_config,
                     CONFIG_SCHEMA)
from .handler import SimulationHandler
from .ops.solver import SolverOptions
from .path import Path
from .state import ParticleState, StepStats, WHITE, YOLK

__version__ = "0.1.0"

__all__ = [
    "SimulationHandler", "SolverOptions", "Path",
    "default_white_config", "default_yolk_config", "fluid_config",
    "CONFIG_SCHEMA", "ParticleState", "StepStats", "WHITE", "YOLK",
]
