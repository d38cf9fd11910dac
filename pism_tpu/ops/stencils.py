"""Staggered-grid finite-difference building blocks.

The reference implements these as per-cell loops over DMDA-ghosted arrays
(PISM ``src/stressbalance/sia/SIAFD.cc`` surface-gradient and diffusivity
stencils, ``src/geometry/GeometryEvolution.cc`` flux divergence). Here every
stencil is a whole-array shifted expression: under ``jit`` with sharded
inputs, XLA GSPMD turns the shifts into halo exchanges between devices; on one
device they are plain fused slices.

Conventions
-----------
- arrays are ``(My, Mx)``; axis 0 is y ("j"), axis 1 is x ("i").
- staggered fields live on cell faces: ``E[j, i]`` is the face between
  ``(j, i)`` and ``(j, i+1)``; ``N[j, i]`` between ``(j, i)`` and
  ``(j+1, i)``. The last row/column of faces sits on the domain boundary.
- non-periodic boundaries use edge-replication (zero-gradient) ghosts;
  PISM likewise requires ice to stay clear of the domain boundary.
"""

from __future__ import annotations

import jax.numpy as jnp


def shift(a, jy: int, ix: int, periodic_y: bool = False, periodic_x: bool = False):
    """Return b with b[j, i] = a[j + jy, i + ix] (ghosts by wrap or clamp)."""
    if jy != 0:
        if periodic_y:
            a = jnp.roll(a, -jy, axis=0)
        else:
            if jy > 0:
                pad = [(0, jy)] + [(0, 0)] * (a.ndim - 1)
                a = jnp.pad(a, pad, mode="edge")[jy:, ...]
            else:
                pad = [(-jy, 0)] + [(0, 0)] * (a.ndim - 1)
                a = jnp.pad(a, pad, mode="edge")[:jy, ...]
    if ix != 0:
        if periodic_x:
            a = jnp.roll(a, -ix, axis=1)
        else:
            if ix > 0:
                pad = [(0, 0), (0, ix)] + [(0, 0)] * (a.ndim - 2)
                a = jnp.pad(a, pad, mode="edge")[:, ix:, ...]
            else:
                pad = [(0, 0), (-ix, 0)] + [(0, 0)] * (a.ndim - 2)
                a = jnp.pad(a, pad, mode="edge")[:, :ix, ...]
    return a


class Shifter:
    """Bind grid periodicity once: ``sh = Shifter(grid); sh(a, jy, ix)``."""

    def __init__(self, grid):
        self.py = grid.periodic_y
        self.px = grid.periodic_x

    def __call__(self, a, jy: int, ix: int):
        return shift(a, jy, ix, self.py, self.px)


# ---------------------------------------------------------------------------
# Staggered averages and gradients
# ---------------------------------------------------------------------------

def avg_to_east(a, sh):
    """Average cell values onto east faces."""
    return 0.5 * (a + sh(a, 0, 1))


def avg_to_north(a, sh):
    return 0.5 * (a + sh(a, 1, 0))


def grad_x_east(s, dx, sh):
    """d(s)/dx on east faces: forward difference."""
    return (sh(s, 0, 1) - s) / dx


def grad_y_north(s, dy, sh):
    return (sh(s, 1, 0) - s) / dy


def grad_y_east(s, dy, sh):
    """d(s)/dy on east faces (Mahaffy 4-point average).

    PISM SIAFD ``surface_gradient_mahaffy``: average of centered y-differences
    at the two cells adjacent to the face.
    """
    return (sh(s, 1, 0) + sh(s, 1, 1) - sh(s, -1, 0) - sh(s, -1, 1)) / (4.0 * dy)


def grad_x_north(s, dx, sh):
    return (sh(s, 0, 1) + sh(s, 1, 1) - sh(s, 0, -1) - sh(s, 1, -1)) / (4.0 * dx)


def centered_grad(s, dx, dy, sh):
    """Centered gradient at cell centers."""
    gx = (sh(s, 0, 1) - sh(s, 0, -1)) / (2.0 * dx)
    gy = (sh(s, 1, 0) - sh(s, -1, 0)) / (2.0 * dy)
    return gx, gy


def div_staggered(QE, QN, dx, dy, sh):
    """Divergence at cell centers of a staggered face flux (QE, QN).

    div[j,i] = (QE[j,i] - QE[j,i-1])/dx + (QN[j,i] - QN[j-1,i])/dy
    """
    return (QE - sh(QE, 0, -1)) / dx + (QN - sh(QN, -1, 0)) / dy


def upwind_flux_east(u_face, a, sh):
    """First-order upwind advective face value: a from the upwind side."""
    return jnp.where(u_face >= 0.0, a, sh(a, 0, 1)) * u_face


def upwind_flux_north(v_face, a, sh):
    return jnp.where(v_face >= 0.0, a, sh(a, 1, 0)) * v_face
