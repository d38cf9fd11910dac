"""Device-mesh construction and sharding helpers.

Replaces PISM's PETSc DMDA rank layout (``DMDACreate2d`` in
``src/util/Grid.cc``, ``-Nx/-Ny`` options) with a ``jax.sharding.Mesh`` over
axes ("y", "x"); fields get ``NamedSharding(P("y", "x"))`` (3D fields keep z
unsharded — columns are never decomposed, matching the reference). An
optional leading "e" (ensemble) axis shards ensemble members across groups
of devices, the analog of PISM's embarrassingly-parallel ensembles. The
mesh follows the algorithm: the devices of one host are joined all to all,
so no torus shape is needed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def best_factorization(n: int) -> tuple:
    """Split n devices into the most-square (ny, nx) layout, like PETSc's
    default DMDA processor grid."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(devices: Optional[Sequence] = None, shape: Optional[tuple] = None,
              ensemble: int = 1) -> Mesh:
    """Build a ("y", "x") mesh (optionally ("e", "y", "x"))."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if ensemble > 1:
        if n % ensemble:
            raise ValueError(f"{n} devices not divisible by ensemble={ensemble}")
        ny, nx = shape if shape else best_factorization(n // ensemble)
        arr = np.array(devices).reshape(ensemble, ny, nx)
        return Mesh(arr, ("e", "y", "x"))
    ny, nx = shape if shape else best_factorization(n)
    arr = np.array(devices).reshape(ny, nx)
    return Mesh(arr, ("y", "x"))


def sharding2d(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("y", "x"))


def shard_state(state, mesh: Mesh):
    """Place every 2D and 3D array leaf of a state pytree with (y, x)
    sharding; a 3D field's trailing z axis stays whole. The spec is written
    without a trailing ``None`` because that is the form XLA gives a
    segment's outputs: a spec differing in form only is another jit cache
    key, and every sharded run would compile its step twice."""
    s2 = sharding2d(mesh)

    def place(leaf):
        if getattr(leaf, "ndim", 0) in (2, 3):
            return jax.device_put(leaf, s2)
        return leaf

    return jax.tree_util.tree_map(place, state)
