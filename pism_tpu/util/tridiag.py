"""Batched tridiagonal solvers (Thomas scan + parallel cyclic reduction).

The reference solves one small tridiagonal system per (i, j) column per step
inside a C++ loop (PISM ``src/util/ColumnSystem.cc``,
``TridiagonalSystem::solve``). On an accelerator the natural layout is the
transpose: whole-(My, Mx)-plane operations over the z axis. Two algorithms:

- :func:`solve_batched_thomas` — forward sweep + back substitution as two
  ``lax.scan``s (2n sequential elementwise steps).
- :func:`solve_batched_pcr` — parallel cyclic reduction: ceil(log2 n)
  full-tensor elimination rounds with NO sequential dependence along z.
  Stable for the diagonally dominant systems the energy/age columns
  produce.

:func:`solve_batched` picks one of them at trace time from the platform
(:func:`pism_tpu.util.dispatch.tridiag_method`). The SSA line
preconditioner calls :func:`solve_batched_pcr` directly.

System per column: a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k], k = 0..n-1
(a[0] and c[n-1] ignored). Batch axes lead: coefficients are (..., n).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .dispatch import platform, tridiag_method


def solve_batched_thomas(a, b, c, d):
    """Solve batched tridiagonal systems; all inputs (..., n), z-axis last.

    Returns x of shape (..., n). Forward sweep + back substitution as two
    ``lax.scan``s over the z axis with (...)-shaped carries.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    d = jnp.asarray(d)
    # enforce the ignored corners so callers need not zero them
    a = a.at[..., 0].set(0.0)
    c = c.at[..., -1].set(0.0)

    # move z to the front for scan: (n, ...)
    am = jnp.moveaxis(a, -1, 0)
    bm = jnp.moveaxis(b, -1, 0)
    cm = jnp.moveaxis(c, -1, 0)
    dm = jnp.moveaxis(d, -1, 0)

    def fwd(carry, inputs):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = inputs
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(bm[0])
    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (zeros, zeros), (am, bm, cm, dm))

    def back(carry, inputs):
        x_next = carry
        cp, dp = inputs
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(back, zeros, (cps, dps), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def _shift_z(x, s, fill=0.0):
    """x[..., k] -> x[..., k+s] with `fill` outside (s may be negative)."""
    n = x.shape[-1]
    if s >= n or -s >= n:
        return jnp.full_like(x, fill)
    if s > 0:
        pad = jnp.full(x.shape[:-1] + (s,), fill, x.dtype)
        return jnp.concatenate([x[..., s:], pad], axis=-1)
    if s < 0:
        pad = jnp.full(x.shape[:-1] + (-s,), fill, x.dtype)
        return jnp.concatenate([pad, x[..., :s]], axis=-1)
    return x


def solve_batched_pcr(a, b, c, d, pivot_floor: float = 0.0):
    """Parallel cyclic reduction; same contract as the Thomas variant.

    Each round eliminates the sub/super-diagonals at distance s by row
    combination; after ceil(log2 n) rounds the system is diagonal. Out-of-
    range neighbors use b = 1, a = c = d = 0, which makes the eliminations
    no-ops at the column ends.

    ``pivot_floor`` > 0 clamps |pivots| away from zero (signed): needed by
    reduced-precision (bf16) preconditioner solves, where rounding can
    drive a weakly-dominant pivot through zero and poison the whole line
    with Inf/NaN. Exact solves (the default) leave it off.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    d = jnp.asarray(d)
    a = a.at[..., 0].set(0.0)
    c = c.at[..., -1].set(0.0)
    n = a.shape[-1]

    def piv(x):
        if pivot_floor <= 0.0:
            return x
        return jnp.where(jnp.abs(x) < pivot_floor,
                         jnp.where(x < 0, -pivot_floor, pivot_floor), x)

    s = 1
    rounds = math.ceil(math.log2(n)) if n > 1 else 0
    for _ in range(rounds):
        b_m = _shift_z(piv(b), -s, 1.0)   # b[k-s]
        b_p = _shift_z(piv(b), +s, 1.0)   # b[k+s]
        alpha = -a / b_m
        gamma = -c / b_p
        b = b + alpha * _shift_z(c, -s) + gamma * _shift_z(a, +s)
        d = d + alpha * _shift_z(d, -s) + gamma * _shift_z(d, +s)
        a = alpha * _shift_z(a, -s)
        c = gamma * _shift_z(c, +s)
        s *= 2
    return d / piv(b)


def solve_batched(a, b, c, d):
    """Platform-dispatched batched tridiagonal solve; inputs (..., n), z
    last (see :func:`pism_tpu.util.dispatch.tridiag_method`)."""
    if tridiag_method(platform()) == "pcr":
        return solve_batched_pcr(a, b, c, d)
    return solve_batched_thomas(a, b, c, d)
