"""Geometric multigrid V-cycle preconditioner for the SSA membrane operator.

The reference leans on PETSc's preconditioner zoo (ILU/ASM/MG via
``-ssafd_ksp_*`` options) to keep KSP iteration counts bounded on
ill-conditioned nuH fields (SURVEY.md §7 "hard parts"). The matrix-free
equivalent built here is a classical geometric V-cycle on the Picard
(frozen-coefficient) operator:

- coefficients: cell-centered viscosity restricted by 2x2 full weighting,
  re-averaged onto faces per level; drag (+ a large value on Dirichlet
  rows, which pins them) restricted the same way;
- smoother: damped Jacobi (weight 0.7), 2 pre + 2 post sweeps;
- transfer: full-weighting (2x2 mean) restriction, piecewise-constant
  prolongation;
- coarsest level (min dim <= 12): 10 damped-Jacobi sweeps.

Every level is a static shape, so the whole V-cycle traces into one XLA
program; the operator application per level is the same fused 9-point
stencil as the fine-level matvec. Used as the right preconditioner inside
BiCGStab for both Picard sweeps and Newton Jacobian solves (the Picard
operator is spectrally close to the Jacobian, which is what a
preconditioner needs).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import ssa as ssa_ops
from .stencils import shift


class _Clamped:
    """Non-periodic Shifter for coarse levels (preconditioner-only)."""

    def __call__(self, a, jy, ix):
        return shift(a, jy, ix, False, False)


def _restrict(a):
    """2x2 full-weighting restriction with edge padding for odd dims."""
    My, Mx = a.shape
    a = jnp.pad(a, ((0, My % 2), (0, Mx % 2)), mode="edge")
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2]
                   + a[0::2, 1::2] + a[1::2, 1::2])


def _prolong(a, shape):
    """Piecewise-constant prolongation (2x repeat, crop)."""
    b = jnp.repeat(jnp.repeat(a, 2, axis=0), 2, axis=1)
    return b[: shape[0], : shape[1]]


def build_levels(nuH, beta_eff, dx, dy, sh, *, min_size=12, max_levels=5):
    """Precompute per-level coefficients from the fine-level faces.

    nuH: ssa_ops.NuH fine faces; beta_eff: drag + BIG on Dirichlet rows.
    Returns a list of dicts (finest first). The fine level keeps the real
    (possibly periodic) Shifter; coarse levels use clamped shifts.
    """
    shc = _Clamped()
    nu_c = 0.25 * (nuH.e + sh(nuH.e, 0, -1) + nuH.n + sh(nuH.n, -1, 0))
    levels = [dict(nuH=nuH, beta=beta_eff, dx=dx, dy=dy, sh=sh,
                   shape=beta_eff.shape)]
    while (min(levels[-1]["shape"]) > min_size
           and len(levels) < max_levels):
        nu_c = _restrict(nu_c)
        beta_eff = _restrict(beta_eff)
        dx, dy = 2.0 * dx, 2.0 * dy
        nuH_l = ssa_ops.NuH(e=0.5 * (nu_c + shc(nu_c, 0, 1)),
                            n=0.5 * (nu_c + shc(nu_c, 1, 0)))
        levels.append(dict(nuH=nuH_l, beta=beta_eff, dx=dx, dy=dy, sh=shc,
                           shape=beta_eff.shape))
    return levels


def _line_factors(lv):
    """Equilibrated tridiagonal factors of the alternating-direction line
    operator at one level (u along x, v along y; cf.
    ``ssa.make_line_preconditioner``)."""
    nuH, beta, dx, dy, sh = lv["nuH"], lv["beta"], lv["dx"], lv["dy"], lv["sh"]
    nuH_w = sh(nuH.e, 0, -1)
    nuH_s = sh(nuH.n, -1, 0)
    du, dv = ssa_ops.operator_diagonal(nuH, beta, dx, dy, sh)
    bu = jnp.maximum(du, 1e-30)
    bv = jnp.maximum(dv, 1e-30)
    return dict(au=-4.0 * nuH_w / dx ** 2 / bu,
                cu=-4.0 * nuH.e / dx ** 2 / bu,
                av=-4.0 * nuH_s / dy ** 2 / bv,
                cv=-4.0 * nuH.n / dy ** 2 / bv,
                bu=bu, bv=bv)


def _line_smooth(lv, x, b, sweeps, omega=0.9):
    """Alternating-direction line-Jacobi smoothing: x += omega L^-1 (b-Ax),
    with L = the per-component line operator (exact along the dominant
    4 nuH / d^2 coupling, transverse+drag lumped on the diagonal). One PCR
    solve per component per sweep — a few matvec equivalents, but it
    damps the along-flow smooth modes point-Jacobi leaves behind."""
    from ..util.tridiag import solve_batched_pcr

    f = lv["line"]
    nuH, beta, dx, dy, sh = lv["nuH"], lv["beta"], lv["dx"], lv["dy"], lv["sh"]
    u, v = x
    one = jnp.ones(u.shape, u.dtype)
    sw = lambda a: jnp.swapaxes(a, -1, -2)
    for _ in range(sweeps):
        Au, Av = ssa_ops.apply_operator(u, v, nuH, beta, dx, dy, sh)
        zu = solve_batched_pcr(f["au"].astype(u.dtype), one,
                               f["cu"].astype(u.dtype),
                               (b[0] - Au) / f["bu"].astype(u.dtype))
        zv = sw(solve_batched_pcr(sw(f["av"].astype(v.dtype)), sw(one),
                                  sw(f["cv"].astype(v.dtype)),
                                  sw((b[1] - Av) / f["bv"].astype(v.dtype))))
        u = u + omega * zu
        v = v + omega * zv
    return (u, v)


def _smooth(lv, x, b, sweeps, omega=0.7):
    nuH, beta, dx, dy, sh = lv["nuH"], lv["beta"], lv["dx"], lv["dy"], lv["sh"]
    du, dv = ssa_ops.operator_diagonal(nuH, beta, dx, dy, sh)
    du = jnp.maximum(du, 1e-30)
    dv = jnp.maximum(dv, 1e-30)
    u, v = x
    for _ in range(sweeps):
        Au, Av = ssa_ops.apply_operator(u, v, nuH, beta, dx, dy, sh)
        u = u + omega * (b[0] - Au) / du
        v = v + omega * (b[1] - Av) / dv
    return (u, v)


def vcycle(levels, r, *, pre=2, post=2, coarse_sweeps=10, level=0,
           smooth=None):
    """One V(pre,post) cycle applied to the residual pair r = (ru, rv)."""
    smooth = smooth or _smooth
    lv = levels[level]
    zero = (jnp.zeros_like(r[0]), jnp.zeros_like(r[1]))
    if level == len(levels) - 1:
        return smooth(lv, zero, r, coarse_sweeps)
    x = smooth(lv, zero, r, pre)
    Au, Av = ssa_ops.apply_operator(x[0], x[1], lv["nuH"], lv["beta"],
                                    lv["dx"], lv["dy"], lv["sh"])
    res = (r[0] - Au, r[1] - Av)
    rc = (_restrict(res[0]), _restrict(res[1]))
    xc = vcycle(levels, rc, pre=pre, post=post,
                coarse_sweeps=coarse_sweeps, level=level + 1, smooth=smooth)
    x = (x[0] + _prolong(xc[0], lv["shape"]),
         x[1] + _prolong(xc[1], lv["shape"]))
    return smooth(lv, x, r, post)


def make_preconditioner(nuH, beta, bc_mask, dx, dy, sh, *,
                        big=1.0e30, smoother="jacobi", pre=2, post=2,
                        coarse_sweeps=10, **kw):
    """Right-preconditioner r -> z for BiCGStab on the SSA system.

    Dirichlet rows are pinned with a huge drag in the hierarchy (their
    V-cycle output is ~0) and then restored to the identity (z = r), which
    matches the identity rows the solvers use for bc cells.

    smoother="line" uses alternating-direction line relaxation per level
    (the ``linemg`` preconditioner option): the line solve damps the stiff
    along-flow coupling, the coarse correction supplies the global mode
    point relaxation cannot — each V(1,1) costs ~3 line applications but
    targets the slow far-field modes that cap plain line-preconditioned
    Krylov.
    """
    beta_eff = jnp.where(bc_mask, big, beta) if bc_mask is not None else beta
    levels = build_levels(nuH, beta_eff, dx, dy, sh, **kw)
    smooth = _smooth
    if smoother == "line":
        for lv in levels:
            lv["line"] = _line_factors(lv)
        smooth = _line_smooth

    def precond(r):
        z = vcycle(levels, r, pre=pre, post=post,
                   coarse_sweeps=coarse_sweeps, smooth=smooth)
        if bc_mask is not None:
            z = (jnp.where(bc_mask, r[0], z[0]),
                 jnp.where(bc_mask, r[1], z[1]))
        return z

    return precond
