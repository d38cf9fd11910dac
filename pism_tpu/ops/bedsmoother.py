"""Schoof (2003) bed roughness parameterization ("bed smoother").

Rebuild of PISM ``src/stressbalance/sia/BedSmoother.cc`` (the reference
mount was empty at survey time; rebuilt from the PISM manual's description
of the scheme and Schoof 2003, *The effect of basal topography on ice
sheet dynamics*). The SIA is solved on a smoothed bed b_s (moving window
average of the true bed), and the diffusivity is multiplied by a roughness
factor

    theta = < (1 - b~ / H)^(-(n+2)/n) >^(-n)   in [0, 1],

where b~ = b - b_s is the residual topography and <.> the window average:
unresolved bumps thin the column locally and reduce the vertically
integrated flux. Following the reference, the window average is evaluated
through a 4th-order Taylor expansion in x = b~/H with precomputed moments
C2 = <b~^2>, C3 = <b~^3>, C4 = <b~^4> (the <b~> term vanishes by
construction), so the per-step cost is a handful of elementwise ops; the
moment fields are recomputed only when the bed changes.

Device mapping: the moving-window sums are ``lax.reduce_window`` adds (XLA
lowers them to fused window reductions), normalized by a same-shape window count so
domain edges use the shrunken window rather than padded zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SmoothedBed(NamedTuple):
    bed: jnp.ndarray      # smoothed bed b_s [m]
    maxtl: jnp.ndarray    # max of (b - b_s) over the window [m]
    C2: jnp.ndarray       # <b~^2> [m^2]
    C3: jnp.ndarray       # <b~^3> [m^3]
    C4: jnp.ndarray       # <b~^4> [m^4]


def _window_mean(a, ny: int, nx: int):
    s = jax.lax.reduce_window(a, 0.0, jax.lax.add,
                              (2 * ny + 1, 2 * nx + 1), (1, 1), "SAME")
    cnt = jax.lax.reduce_window(jnp.ones_like(a), 0.0, jax.lax.add,
                                (2 * ny + 1, 2 * nx + 1), (1, 1), "SAME")
    return s / cnt


def preprocess_bed(bed, dx: float, dy: float, smoothing_range: float
                   ) -> SmoothedBed:
    """Smooth the bed and precompute the residual-topography moments.

    smoothing_range: half-width of the averaging window [m]; <= 0 disables
    (returns the bed unchanged with zero moments).
    """
    if smoothing_range <= 0.0:
        z = jnp.zeros_like(bed)
        return SmoothedBed(bed=bed, maxtl=z, C2=z, C3=z, C4=z)
    nx = max(int(np.ceil(smoothing_range / dx)), 1)
    ny = max(int(np.ceil(smoothing_range / dy)), 1)

    b_s = _window_mean(bed, ny, nx)
    tl = bed - b_s  # residual ("topographic local") relief
    neg_inf = jnp.asarray(-1e30, bed.dtype)
    maxtl = jax.lax.reduce_window(tl, neg_inf, jax.lax.max,
                                  (2 * ny + 1, 2 * nx + 1), (1, 1), "SAME")
    maxtl = jnp.maximum(maxtl, 0.0)
    return SmoothedBed(bed=b_s, maxtl=maxtl,
                       C2=_window_mean(tl ** 2, ny, nx),
                       C3=_window_mean(tl ** 3, ny, nx),
                       C4=_window_mean(tl ** 4, ny, nx))


def theta(smooth: SmoothedBed, H, n: float = 3.0):
    """Roughness multiplier for the SIA diffusivity, in [0, 1].

    H: ice thickness relative to the smoothed bed. The Taylor expansion of
    <(1 - x)^(-p)> with p = (n+2)/n and <x> = 0 gives
        omega = 1 + p(p+1)/2 C2/H^2 + p(p+1)(p+2)/6 C3/H^3
                  + p(p+1)(p+2)(p+3)/24 C4/H^4,
    theta = omega^(-n). The expansion needs H > max(b~): below that the
    column intersects unresolved bumps and the flux is shut off smoothly.
    """
    p = (n + 2.0) / n
    lim = 2.0 * smooth.maxtl  # expansion validity limit (needs H > relief)
    # keep the expansion parameter < 1: clamp H away from the max relief
    Hs = jnp.maximum(H, lim + 1.0)
    k2 = p * (p + 1.0) / 2.0
    k3 = p * (p + 1.0) * (p + 2.0) / 6.0
    k4 = p * (p + 1.0) * (p + 2.0) * (p + 3.0) / 24.0
    omega = (1.0 + k2 * smooth.C2 / Hs ** 2 + k3 * smooth.C3 / Hs ** 3
             + k4 * smooth.C4 / Hs ** 4)
    th = jnp.clip(omega ** (-n), 0.0, 1.0)
    # no valid expansion for thin ice over tall bumps: taper to zero.
    # Where the window has no relief (lim == 0) the bed is resolved and
    # theta must be exactly 1 for any H, including sub-meter margins.
    thin = H < lim
    taper = jnp.clip(H / jnp.maximum(lim, 1e-9), 0.0, 1.0)
    return jnp.where(thin, th * taper, th).astype(H.dtype)
