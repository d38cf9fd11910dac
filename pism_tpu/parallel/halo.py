"""Explicit halo exchange over the device mesh.

The reference refreshes ghost regions via PETSc DMDA scatters
(``array::Array::update_ghosts()`` -> ``DMLocalToLocalBegin/End``; see
SURVEY.md §2.5). The default compute path here relies on XLA GSPMD to insert
equivalent collective-permutes automatically for shifted-array stencils; this
module provides the *manual* path — ``jax.lax.ppermute`` strip exchange
inside ``shard_map`` — for hand-scheduled kernels that need their halos
explicitly, and for validating GSPMD against an explicit implementation.

Semantics match ``ops.stencils.shift``: periodic wrap or edge-replication
ghosts at physical boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _exchange_axis(block, width: int, array_axis: int, mesh_axis: str,
                   periodic: bool):
    """Pad `block` with `width` ghost cells along `array_axis`, filling them
    with neighbor data over mesh axis `mesh_axis` (must run inside shard_map).
    """
    n = lax.axis_size(mesh_axis)
    idx = lax.axis_index(mesh_axis)

    def take(a, sl):
        index = [slice(None)] * a.ndim
        index[array_axis] = sl
        return a[tuple(index)]

    lo_strip = take(block, slice(0, width))          # my lowest rows
    hi_strip = take(block, slice(-width, None))      # my highest rows

    fwd = [((i, (i + 1) % n)) for i in range(n)]     # send towards +axis
    bwd = [((i, (i - 1) % n)) for i in range(n)]

    from_lower = lax.ppermute(hi_strip, mesh_axis, fwd)   # neighbor idx-1's top
    from_upper = lax.ppermute(lo_strip, mesh_axis, bwd)   # neighbor idx+1's bottom

    if not periodic:
        # Physical-boundary ghosts: replicate own edge value (zero-gradient),
        # matching jnp.pad(mode="edge") in the single-device path.
        edge_lo = take(block, slice(0, 1))
        edge_hi = take(block, slice(-1, None))
        reps = [1] * block.ndim
        reps[array_axis] = width
        from_lower = jnp.where(idx == 0, jnp.tile(edge_lo, reps), from_lower)
        from_upper = jnp.where(idx == n - 1, jnp.tile(edge_hi, reps), from_upper)

    return jnp.concatenate([from_lower, block, from_upper], axis=array_axis)


def halo_pad(block, width: int = 1, mesh_axes=("y", "x"),
             periodic=(False, False)):
    """Return block padded with `width` ghosts on both 2D axes.

    Call inside ``shard_map`` over a mesh with the named axes. Corner ghosts
    are filled correctly because the second exchange operates on the already
    y-padded strips (the standard two-pass trick; DMDA box stencils do the
    same with a single 8-neighbor scatter).
    """
    out = _exchange_axis(block, width, 0, mesh_axes[0], periodic[0])
    out = _exchange_axis(out, width, 1, mesh_axes[1], periodic[1])
    return out


def crop(block, width: int):
    """Strip `width` ghost cells from both 2D axes."""
    return block[width:-width, width:-width, ...]


def stencil_shard_map(fn, mesh, width: int = 1, periodic=(False, False)):
    """Wrap ``fn(padded_block) -> block``-style local stencils in shard_map.

    ``fn`` receives the halo-padded local block(s) and must return arrays of
    the *unpadded* local shape. Example::

        lap = stencil_shard_map(
            lambda a: (a[2:, 1:-1] + a[:-2, 1:-1] + a[1:-1, 2:]
                       + a[1:-1, :-2] - 4 * a[1:-1, 1:-1]),
            mesh, width=1)
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    spec = P("y", "x")

    def wrapped(*arrays):
        padded = [halo_pad(a, width, ("y", "x"), periodic) for a in arrays]
        return fn(*padded)

    return shard_map(wrapped, mesh=mesh, in_specs=spec, out_specs=spec)
