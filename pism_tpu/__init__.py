"""pism_tpu: an accelerator-native ice-sheet/ice-shelf modeling framework.

A ground-up JAX/XLA rebuild of the capabilities of PISM (the Parallel Ice
Sheet Model; reference fork ``juliusgarbe/pism``), run on one NVIDIA GPU or
several. See SURVEY.md at the repository root for the layer map and the
reference -> accelerator design mapping.

Double precision is enabled globally: model time spans 1e12+ seconds and
verification parity targets 1e-6 relative tolerance. Field dtype is
independently configurable (``runtime.float_dtype``; float32 for production
performance runs).
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .config.config import Config  # noqa: E402
from .grid import Grid  # noqa: E402
from .state import Geometry, ModelState, new_geometry, ensure_consistency  # noqa: E402
from .util.timecal import Time  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Config", "Grid", "Geometry", "ModelState", "Time",
    "new_geometry", "ensure_consistency",
]
