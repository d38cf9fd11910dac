"""Shelfy-stream approximation (SSA): matrix-free operator and solvers.

Rebuild of PISM ``src/stressbalance/ssa/SSAFD.cc`` (``compute_nuH``,
``assemble_matrix``, ``assemble_rhs``, ``picard_iteration``) as a
*matrix-free* method: the 2x2-block 9-point stencil is applied as fused
whole-array shifted expressions (GSPMD supplies halos when sharded), the
linear solves are Jacobi-preconditioned conjugate gradients in a
``lax.while_loop`` whose dot products become psum collectives on a mesh,
and the outer nonlinear iteration is PISM's Picard loop on the effective
viscosity nuH — replacing PETSc KSP entirely.

Continuous problem (velocities u, v; vertically-integrated):
    d/dx(2 nuH (2 u_x + v_y)) + d/dy(nuH (u_y + v_x)) - beta u = rho g H s_x
    d/dy(2 nuH (2 v_y + u_x)) + d/dx(nuH (u_y + v_x)) - beta v = rho g H s_y
nu = (B/2) (eps_eff^2)^((1-n)/(2n)),
eps_eff^2 = u_x^2 + v_y^2 + u_x v_y + (1/4)(u_y + v_x)^2 + eps_reg^2.

Discretization: conservative face fluxes; nuH on staggered faces
(T_xx, T_yy on east/west faces, T_xy on north/south faces), matching the
reference's staggered scheme.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import stencils as st
from .stencils import Shifter


class NuH(NamedTuple):
    e: jnp.ndarray   # nuH on east faces [Pa s m]
    n: jnp.ndarray   # nuH on north faces


# ---------------------------------------------------------------------------
# effective viscosity
# ---------------------------------------------------------------------------

def compute_nuH(u, v, hardness_B, H, dx, dy, sh: Shifter, *, n_glen=3.0,
                eps_reg2=1e-31, extension_nuH=None, extension_mask=None) -> NuH:
    """Staggered effective viscosity times thickness.

    hardness_B, H: cell-centered vertically-averaged hardness and thickness.
    eps_reg2: Schoof regularization (strain-rate)^2 floor, in (1/s)^2.
    extension_nuH / extension_mask: where mask is true, replace by the
    strength-extension constant (PISM ``SSAStrengthExtension``).

    Internally strain rates are computed in 1/year units: SI strain-rate
    squares (~1e-27) raised to negative fractional powers overflow float32
    (and their autodiff tangents overflow harder); per-year magnitudes
    (~1e-5) keep the whole computation and its JVP in f32 range. The
    rescaling factor SPY^((n-1)/n) restores SI nuH.
    """
    from ..util.units import SEC_PER_YEAR as SPY
    rescale = SPY ** ((n_glen - 1.0) / n_glen)
    reg2_a = eps_reg2 * SPY * SPY

    def face_nuH(ux, vy, uy, vx, B_f, H_f):
        # strain rates arrive in 1/s; convert to 1/year
        ux, vy, uy, vx = (g * SPY for g in (ux, vy, uy, vx))
        eps2 = ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2 + reg2_a
        nu = 0.5 * B_f * eps2 ** ((1.0 - n_glen) / (2.0 * n_glen)) * rescale
        return nu * H_f

    # east faces
    ux_e = st.grad_x_east(u, dx, sh)
    vx_e = st.grad_x_east(v, dx, sh)
    uy_e = st.grad_y_east(u, dy, sh)
    vy_e = st.grad_y_east(v, dy, sh)
    nuH_e = face_nuH(ux_e, vy_e, uy_e, vx_e,
                     st.avg_to_east(hardness_B, sh), st.avg_to_east(H, sh))

    # north faces
    uy_n = st.grad_y_north(u, dy, sh)
    vy_n = st.grad_y_north(v, dy, sh)
    ux_n = st.grad_x_north(u, dx, sh)
    vx_n = st.grad_x_north(v, dx, sh)
    nuH_n = face_nuH(ux_n, vy_n, uy_n, vx_n,
                     st.avg_to_north(hardness_B, sh), st.avg_to_north(H, sh))

    if extension_nuH is not None:
        ext_e = st.avg_to_east(extension_mask.astype(u.dtype), sh) > 0.49
        ext_n = st.avg_to_north(extension_mask.astype(u.dtype), sh) > 0.49
        nuH_e = jnp.where(ext_e, extension_nuH, nuH_e)
        nuH_n = jnp.where(ext_n, extension_nuH, nuH_n)
    return NuH(e=nuH_e, n=nuH_n)


# ---------------------------------------------------------------------------
# linear operator (frozen nuH, beta)
# ---------------------------------------------------------------------------

def apply_operator(u, v, nuH: NuH, beta, dx, dy, sh: Shifter):
    """A(u, v) -> (Au, Av): MINUS the membrane-stress divergence plus basal
    drag (so the system A x = b with b = driving stress is SPD).

    Faces across which no stress should be transmitted (calving fronts,
    regional-mode boundaries) are handled by zeroing nuH on those faces
    before calling (see ``model.ssa.SSAFD``)."""
    # face stresses, x-equation: T_xx on east faces, T_xy on north faces
    ux_e = st.grad_x_east(u, dx, sh)
    vy_e = st.grad_y_east(v, dy, sh)
    Txx_e = 2.0 * nuH.e * (2.0 * ux_e + vy_e)

    uy_n = st.grad_y_north(u, dy, sh)
    vx_n = st.grad_x_north(v, dx, sh)
    Txy_n = nuH.n * (uy_n + vx_n)

    div_x = st.div_staggered(Txx_e, Txy_n, dx, dy, sh)

    # y-equation: T_yy on north faces, T_xy on east faces
    vy_n = st.grad_y_north(v, dy, sh)
    ux_n = st.grad_x_north(u, dx, sh)
    Tyy_n = 2.0 * nuH.n * (2.0 * vy_n + ux_n)

    uy_e = st.grad_y_east(u, dy, sh)
    vx_e = st.grad_x_east(v, dx, sh)
    Txy_e = nuH.e * (uy_e + vx_e)

    div_y = st.div_staggered(Txy_e, Tyy_n, dx, dy, sh)

    return -div_x + beta * u, -div_y + beta * v


def operator_diagonal(nuH: NuH, beta, dx, dy, sh: Shifter):
    """Diagonal (u and v own-coefficients) of the operator, for Jacobi
    preconditioning. Uses the dominant normal-stress + shear terms."""
    nuH_w = sh(nuH.e, 0, -1)
    nuH_s = sh(nuH.n, -1, 0)
    diag_u = (4.0 * (nuH.e + nuH_w) / dx ** 2
              + (nuH.n + nuH_s) / dy ** 2 + beta)
    diag_v = (4.0 * (nuH.n + nuH_s) / dy ** 2
              + (nuH.e + nuH_w) / dx ** 2 + beta)
    return diag_u, diag_v


def make_line_preconditioner(nuH, beta, bc_mask, dx, dy, sh: Shifter,
                             pcr_dtype: str = "f32", line_block: int = 0):
    """Alternating-direction line preconditioner: the u-equation is relaxed
    exactly along x-lines (its dominant ``4 nuH / dx^2`` normal-stress
    coupling) and the v-equation along y-lines, with the transverse and
    drag terms lumped on the diagonal (damped line-Jacobi). Each
    application is one batched parallel-cyclic-reduction solve per
    component — log2(n) whole-array rounds, no per-row scan — so it costs
    a few matvec equivalents while damping the stiff along-flow coupling
    point-Jacobi cannot.

    (PISM leans on PETSc's ILU/ASM zoo here; line relaxation is the
    data-parallel equivalent for this strongly 1D-anisotropic operator.)
    """
    from ..util.tridiag import solve_batched_pcr

    nuH_w = sh(nuH.e, 0, -1)
    nuH_s = sh(nuH.n, -1, 0)
    diag_u, diag_v = operator_diagonal(nuH, beta, dx, dy, sh)
    au = -4.0 * nuH_w / dx ** 2
    cu = -4.0 * nuH.e / dx ** 2
    av = -4.0 * nuH_s / dy ** 2
    cv = -4.0 * nuH.n / dy ** 2
    bu = jnp.where(bc_mask, 1.0, jnp.maximum(diag_u, 1e-12))
    bv = jnp.where(bc_mask, 1.0, jnp.maximum(diag_v, 1e-12))
    # Dirichlet rows are identities; decouple their neighbors from them
    au = jnp.where(bc_mask | sh(bc_mask, 0, -1), 0.0, au)
    cu = jnp.where(bc_mask | sh(bc_mask, 0, 1), 0.0, cu)
    av = jnp.where(bc_mask | sh(bc_mask, -1, 0), 0.0, av)
    cv = jnp.where(bc_mask | sh(bc_mask, 1, 0), 0.0, cv)

    # row-equilibrate (unit diagonal): keeps the f32 cyclic-reduction
    # eliminations well-conditioned under strong nuH contrast
    au, cu = au / bu, cu / bu
    av, cv = av / bv, cv / bv

    def _blocked(solver, a_, b_, c_, d_):
        """Solve independent line blocks of length line_block: reshape the
        system axis into (groups, B); the solver's own first/last-row
        masking decouples the blocks (a Dirichlet-style block split). Fewer
        log2 rounds -> less HBM traffic per preconditioner application, at
        slightly weaker long-range damping."""
        n = d_.shape[-1]
        B = line_block
        pad = (-n) % B
        def prep(x, fill):
            if pad:
                x = jnp.pad(x, ((0, 0), (0, pad)), constant_values=fill)
            return x.reshape(x.shape[0] * ((n + pad) // B), B)
        out = solver(prep(a_, 0.0), prep(b_, 1.0), prep(c_, 0.0),
                     prep(d_, 0.0))
        out = out.reshape(d_.shape[0], n + pad)
        return out[:, :n] if pad else out

    def _pcr(a_, b_, c_, d_):
        # stress_balance.ssa.fd.line_pcr_dtype = bf16 runs the PCR rounds
        # in bfloat16 on f32 vectors: a preconditioner only needs an
        # approximate application, the equilibrated (unit-diagonal)
        # systems are well scaled, and the result is still a FIXED linear
        # operator, so plain BiCGStab stays valid.
        if pcr_dtype == "bf16" and d_.dtype == jnp.float32:
            bf = jnp.bfloat16
            # signed pivot floor: bf16 rounding can drive weakly-dominant
            # pivots through zero (without it the first measured bf16 run
            # silently broke BiCGStab down at iteration 1 and the Newton
            # loop exited at F2/b2 ~ 4e-2). Even clamped, bf16 is NOT the
            # default: it still ground a 300-iteration breakdown sweep on
            # the warm-start system (docs/VALIDATION.md round-5 study).
            solver = lambda *args: solve_batched_pcr(
                *(x.astype(bf) for x in args),
                pivot_floor=1.0 / 64.0).astype(jnp.float32)
        else:
            solver = solve_batched_pcr
        if line_block > 1:
            return _blocked(solver, a_, b_, c_, d_)
        return solver(a_, b_, c_, d_)

    def precond(r):
        ru, rv = r
        one_u = jnp.ones(ru.shape, ru.dtype)
        zu = _pcr(au.astype(ru.dtype), one_u,
                  cu.astype(ru.dtype),
                  ru / bu.astype(ru.dtype))
        sw = lambda x: jnp.swapaxes(x, -1, -2)
        zv = sw(_pcr(sw(av.astype(rv.dtype)), sw(one_u),
                     sw(cv.astype(rv.dtype)),
                     sw(rv / bv.astype(rv.dtype))))
        return zu, zv

    return precond


# ---------------------------------------------------------------------------
# Jacobi-preconditioned CG on the frozen-coefficient system
# ---------------------------------------------------------------------------

def cg_solve(matvec, b, x0, precond, *, rtol=1e-5, atol=0.0, max_iter=300,
             dot_dtype=None):
    """Preconditioned conjugate gradients for pytree unknowns.

    matvec/precond: pytree -> pytree. Dirichlet handling is the caller's
    job (mask residuals, fix values). Runs as a lax.while_loop: on a device
    mesh the reductions lower to psum collectives (the analog of the
    allreduce in every PETSc KSP iteration; SURVEY.md §2.5).
    dot_dtype: accumulate the Krylov dot products in this dtype (same
    control as bicgstab_solve; the f32/f64 production/verification ladder
    selects it).
    """
    tm = jax.tree_util.tree_map

    def dot(a, b_):
        if dot_dtype is not None:
            leaves = tm(lambda x, y: jnp.sum(x.astype(dot_dtype)
                                             * y.astype(dot_dtype)), a, b_)
        else:
            leaves = tm(lambda x, y: jnp.sum(x * y), a, b_)
        return jax.tree_util.tree_reduce(jnp.add, leaves)

    r0 = jax.tree_util.tree_map(jnp.subtract, b, matvec(x0))
    z0 = precond(r0)
    rz0 = dot(r0, z0)
    b_norm2 = dot(b, b)
    tol2 = jnp.maximum(rtol ** 2 * b_norm2, atol ** 2)

    def cond(carry):
        x, r, z, p, rz, it = carry
        return (dot(r, r) > tol2) & (it < max_iter)

    def body(carry):
        x, r, z, p, rz, it = carry
        Ap = matvec(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-300)
        x = jax.tree_util.tree_map(lambda a, c: a + alpha * c, x, p)
        r = jax.tree_util.tree_map(lambda a, c: a - alpha * c, r, Ap)
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-300)
        p = jax.tree_util.tree_map(lambda a, c: a + beta * c, z, p)
        return (x, r, z, p, rz_new, it + 1)

    x, r, z, p, rz, iters = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, jnp.asarray(0)))
    return x, iters, dot(r, r)


def bicgstab_solve(matvec, b, x0, precond, *, rtol=1e-5, atol=0.0,
                   max_iter=300, dot_dtype=None):
    """Right-preconditioned BiCGStab for pytree unknowns.

    The discrete SSA operator is symmetric only up to boundary closure
    (edge-clamped cross-derivative stencils), so BiCGStab is the default
    inner solver; CG remains available for the periodic/SPD case.

    dot_dtype: accumulate the Krylov dot products in this dtype (pass
    float64 for mixed-precision solves with float32 vectors — the scalar
    recurrences are where f32 cancellation kills convergence).
    """
    tm = jax.tree_util.tree_map

    def dot(a, b_):
        if dot_dtype is not None:
            leaves = tm(lambda x, y: jnp.sum(x.astype(dot_dtype)
                                             * y.astype(dot_dtype)), a, b_)
        else:
            leaves = tm(lambda x, y: jnp.sum(x * y), a, b_)
        return jax.tree_util.tree_reduce(jnp.add, leaves)

    def axpy(a, x, y):  # a*x + y (scalar cast to the vector dtype)
        return tm(lambda u, w: a.astype(u.dtype) * u + w, x, y)

    r0 = tm(jnp.subtract, b, matvec(x0))
    rhat = r0
    b_norm2 = dot(b, b)
    tol2 = jnp.maximum(rtol ** 2 * b_norm2, atol ** 2)
    one = jnp.ones((), dtype=b_norm2.dtype)

    def cond(c):
        x, r, p, v, rho, alpha, omega, it = c
        return (dot(r, r) > tol2) & (it < max_iter)

    def body(c):
        x, r, p, v, rho, alpha, omega, it = c
        rho_new = dot(rhat, r)
        beta = (rho_new / jnp.where(rho == 0, 1e-300, rho)) * \
               (alpha / jnp.where(omega == 0, 1e-300, omega))
        p = axpy(beta, tm(lambda pp, vv: pp - omega.astype(pp.dtype) * vv,
                          p, v), r)
        y = precond(p)
        v = matvec(y)
        alpha = rho_new / jnp.where(dot(rhat, v) == 0, 1e-300, dot(rhat, v))
        s = axpy(-alpha, v, r)
        z = precond(s)
        t = matvec(z)
        tt = dot(t, t)
        omega = dot(t, s) / jnp.where(tt == 0, 1e-300, tt)
        x = axpy(alpha, y, axpy(omega, z, x))
        r = axpy(-omega, t, s)
        return (x, r, p, v, rho_new, alpha, omega, it + 1)

    zero = tm(jnp.zeros_like, b)
    x, r, p, v, rho, alpha, omega, iters = jax.lax.while_loop(
        cond, body, (x0, r0, zero, zero, one, one, one, jnp.asarray(0)))
    # breakdown guard: near-breakdown (rho/omega cancellation, worst in f32)
    # explodes the recurrences and the NaN residual exits the loop above —
    # never hand a diverged iterate back to the Newton/Picard caller
    rfin2 = dot(r, r)
    r02 = dot(r0, r0)
    ok = rfin2 <= r02          # False for NaN too
    x = tm(lambda xf, xi: jnp.where(ok, xf, xi), x, x0)
    rfin2 = jnp.where(ok, rfin2, r02)
    return x, iters, rfin2
