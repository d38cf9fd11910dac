"""The package's device-dependent implementation choices, in one place.

Each choice reads only what the code can observe at trace time: the
platform the computation is placed on (``jax.default_device`` when set,
else the default backend). Numbers behind each rule are in PERF.md with the
card and its power limit.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """Platform name ("cpu", "gpu", ...) of the device new computations
    are placed on."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def tridiag_method(platform: str) -> str:
    """Batched tridiagonal algorithm on ``platform``: ``"thomas"`` or
    ``"pcr"`` (``util.tridiag``). No shape enters: the GPU rule held at
    every measured shape.

    GPU: parallel cyclic reduction at every measured shape. On an H100
    (700 W) the Thomas scan launches ~3.6 kernels per sequential step
    (292 for n = 41), while PCR fuses its log2(n) rounds into 3-5 kernels:
    PCR took 269 vs 586 us at n = 41 x 168,861 columns (5 km), 20 vs 345 us
    at 41 x 10,716 (20 km) and 9.5 vs 499 us at 61 x 3,721 (EISMINT II).
    CPU: the Thomas scan (2n cheap plane sweeps, no redundant work).
    """
    return "pcr" if platform == "gpu" else "thomas"
