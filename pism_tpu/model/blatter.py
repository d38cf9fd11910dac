"""Blatter-Pattyn 3D first-order ("higher-order") stress balance.

Rebuild of PISM ``src/stressbalance/blatter/`` — with a different,
matrix-free data-parallel discretization. The reference uses Q1 FEM on an extruded mesh with PETSc
SNES + geometric multigrid (vertical semi-coarsening). Here the equations
are discretized in a terrain-following coordinate zeta = z_above_base / H
on the existing (My, Mx, Mz) grid and solved matrix-free:

  d/dx(4 nu u_x + 2 nu v_y) + d/dy(nu (u_y + v_x))
      + d/dz(nu u_z) = rho g s_x          (x-momentum, per unit volume)

with nu = (B/2)(eps^2 + reg)^((1-n)/(2n)),
eps^2 = u_x^2 + v_y^2 + u_x v_y + 1/4 (u_y+v_x)^2 + 1/4 u_z^2 + 1/4 v_z^2.

Sigma-coordinate metric terms: a horizontal derivative at constant z is
  d/dx|_z = d/dx|_zeta + zeta_x d/dzeta,   zeta_x = -(b_x + zeta H_x)/H
(b = ice base). The chain-rule corrections are applied both to the strain
rates (face and center evaluations) and to the stress divergence
(+ zeta_x d(T)/dzeta at centers); they vanish identically on a flat base
with uniform thickness. Vertical shear terms are exact in zeta.

Boundary conditions: stress-free surface (u_zeta = 0 at zeta=1); basal
sliding nu u_z = beta u at zeta=0 (beta from the same sliding laws as the
SSA); lateral ice-free cells are Dirichlet zero. At faces between icy and
ice-free-ocean cells the depth-varying calving-front stress condition
(``stress_balance.calving_front_stress_bc``) applies the hydrostatic
imbalance  sigma_nn(z) = rho_i g (s - z) - rho_w g max(sl - z, 0)  as the
normal resistive stress (the per-level form of the depth-integrated CFBC
in the SSA; Winkelmann et al. 2011); faces to ice-free land stay
stress-free.

Solver: Newton iterations with exact autodiff JVPs, BiCGStab, and a
vertical-line preconditioner: the dominant d/dz(nu d/dz) coupling plus the
horizontal diagonal is inverted per column with the batched Thomas kernel —
the data-parallel analog of the reference's vertical semi-coarsening
multigrid. Verified in tests/test_blatter.py against the analytic
inclined-slab (SIA-limit) and plug-flow (SSA-limit) solutions, the van der
Veen unconfined-shelf strain rate + the independently verified SSAFD CFBC
solution (calving front), and an ISMIP-HOM-B-style wavy-bed configuration
(metric terms).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import state as S
from ..ops import ssa as ssa_ops
from ..ops import stencils as st
from ..ops.stencils import Shifter
from ..physics.basal import SlidingLaw
from ..util.tridiag import solve_batched
from ..util.units import SEC_PER_YEAR


@dataclass
class BlatterSolver:
    grid: object
    config: object
    flow_law: object
    sliding_law: Optional[SlidingLaw] = None
    taud_x: Optional[jnp.ndarray] = None   # prescribed driving stress (tests)
    taud_y: Optional[jnp.ndarray] = None
    body_force_x: Optional[jnp.ndarray] = None  # 3D per-volume force [Pa/m]
    body_force_y: Optional[jnp.ndarray] = None  # (manufactured solutions —
    #   reference BlatterTestXZ role: verification vs exact solutions)
    bc_mask: Optional[jnp.ndarray] = None  # 2D: zero-velocity Dirichlet
    #   columns (stress IS transmitted across their faces, unlike ice-free
    #   cells which are stress-decoupled)

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid)
        # Blatter's Glen exponent inherits the ssa value unless explicitly
        # overridden: configs that set a non-default exponent the historical
        # way (through stress_balance.ssa.Glen_exponent) must not silently
        # run n=3 Blatter physics against an n!=3 problem.
        if cfg.is_set("stress_balance.blatter.Glen_exponent"):
            self.n_glen = cfg.get_number("stress_balance.blatter.Glen_exponent")
        else:
            self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.rho = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.ksp_rtol = cfg.get_number("stress_balance.ssa.fd.ksp_rtol")
        self.ksp_max = cfg.get_int("stress_balance.ssa.fd.ksp_max_it")
        # blatter-specific solver knobs win when explicitly set; otherwise
        # inherit the shared ssa.fd values (reference Blatter.cc reads its
        # own stress_balance.blatter.* family)
        self.newton_max = cfg.get_int("stress_balance.blatter.newton_max_iterations") \
            if cfg.is_set("stress_balance.blatter.newton_max_iterations") \
            else cfg.get_int("stress_balance.ssa.fd.newton_max_iterations")
        self.newton_rtol = cfg.get_number("stress_balance.blatter.newton_rtol") \
            if cfg.is_set("stress_balance.blatter.newton_rtol") \
            else cfg.get_number("stress_balance.ssa.fd.newton_rtol")
        svel = cfg.get_number("stress_balance.ssa.Schoof_regularizing_velocity", "m s-1")
        slen = cfg.get_number("stress_balance.ssa.Schoof_regularizing_length", "m")
        self.eps_reg2 = (svel / slen) ** 2
        self.beta_floor = cfg.get_number("stress_balance.ssa.fd.beta_floor")
        self.cfbc = cfg.get_flag("stress_balance.calving_front_stress_bc")
        self.metric_terms = cfg.get_flag("stress_balance.blatter.metric_terms")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        # flow enhancement (reference stress_balance.blatter.enhancement_
        # factor): softness scales by e, so hardness scales by e^(-1/n)
        self.e_factor = cfg.get_number(
            "stress_balance.blatter.enhancement_factor")
        # runtime.matmul_precision for the f32 column average below (on
        # GPUs XLA's default f32 product may run in TF32); passed to the
        # product itself so that no process-global JAX setting changes
        self.matmul_precision = \
            cfg.get_string("runtime.matmul_precision") or None
        if self.sliding_law is None:
            self.sliding_law = SlidingLaw.from_config(cfg)
        # normalized vertical coordinate from the ice grid levels
        z = np.asarray(self.grid.z)
        self.zeta = jnp.asarray(z / max(z[-1], 1.0))
        self.dzeta = jnp.asarray(np.diff(z / max(z[-1], 1.0)))

    # ------------------------------------------------------------------
    def solve(self, state: S.ModelState, tau_c=None, u0=None, v0=None,
              diagnostics: bool = False, full_output: bool = False):
        grid, sh = self.grid, self.sh
        geom = state.geometry
        H2 = jnp.asarray(geom.ice_thickness, jnp.float64)
        mask = geom.cell_type
        dx, dy = grid.dx, grid.dy
        Mz = grid.Mz
        zeta, dzeta = self.zeta, self.dzeta
        SPY = SEC_PER_YEAR

        icy = S.icy(mask)
        icy_e = sh(icy, 0, 1)
        icy_n = sh(icy, 1, 0)
        keep_e = (icy & icy_e).astype(jnp.float64)[..., None]
        keep_n = (icy & icy_n).astype(jnp.float64)[..., None]
        Hs = jnp.maximum(H2, 1.0)[..., None]     # (My, Mx, 1)

        # sigma-coordinate metric coefficients zeta_x, zeta_y at centers:
        # zeta_x = -(b_x + zeta H_x)/H with b the ice base. Gradients are
        # masked to fully-icy stencils (one-sided surface cliffs at margins
        # are boundary effects handled by the lateral BCs, not the metric)
        surf2 = jnp.asarray(geom.ice_surface_elevation, jnp.float64)
        base2 = surf2 - H2
        interior = (icy & sh(icy, 0, 1) & sh(icy, 0, -1)
                    & sh(icy, 1, 0) & sh(icy, -1, 0)).astype(jnp.float64)
        bxg, byg = st.centered_grad(base2, dx, dy, sh)
        Hxg, Hyg = st.centered_grad(H2, dx, dy, sh)
        zxc = -(bxg[..., None] + zeta * Hxg[..., None]) / Hs \
            * interior[..., None]
        zyc = -(byg[..., None] + zeta * Hyg[..., None]) / Hs \
            * interior[..., None]
        if not self.metric_terms:
            zxc = zyc = jnp.zeros_like(zxc)

        e_hard = self.e_factor ** (-1.0 / self.n_glen)
        # hardness per level from enthalpy (or constant)
        if state.enthalpy is None:
            B3 = self.flow_law.hardness(jnp.zeros(grid.shape3, jnp.float64),
                                        jnp.zeros(grid.shape3, jnp.float64))
        else:
            depth = jnp.maximum(H2[..., None] - jnp.asarray(grid.z), 0.0)
            p = self.flow_law.EC.pressure(depth)
            B3 = self.flow_law.hardness(jnp.asarray(state.enthalpy, jnp.float64), p)
        B3 = B3 * e_hard

        # driving stress (per unit area, multiplied by H in the residual)
        if self.taud_x is not None:
            bx2 = jnp.asarray(self.taud_x, jnp.float64)
            by2 = jnp.asarray(self.taud_y, jnp.float64)
        else:
            # one-sided surface gradients at the ice margin (as in the SSA;
            # a centered difference across the front would double-count the
            # calving-front pressure force)
            def masked_grad(shift, d):
                icy_p, icy_m = sh(icy, *shift), sh(icy, *[-a for a in shift])
                s_p = sh(surf2, *shift)
                s_m = sh(surf2, *[-a for a in shift])
                return jnp.where(icy_p & icy_m, (s_p - s_m) / (2 * d),
                                 jnp.where(icy_p, (s_p - surf2) / d,
                                           jnp.where(icy_m, (surf2 - s_m) / d,
                                                     0.0)))
            sx = masked_grad((0, 1), dx)
            sy = masked_grad((1, 0), dy)
            bx2 = -self.rho * self.g * H2 * sx
            by2 = -self.rho * self.g * H2 * sy
        # per-volume driving term: tau_d / H  [Pa/m] (Blatter is a
        # per-level balance, unlike the depth-integrated SSA)
        bx = jnp.broadcast_to((bx2[..., None] / Hs), grid.shape3)
        by = jnp.broadcast_to((by2[..., None] / Hs), grid.shape3)
        if self.body_force_x is not None:
            bx = bx + jnp.asarray(self.body_force_x, jnp.float64)
        if self.body_force_y is not None:
            by = by + jnp.asarray(self.body_force_y, jnp.float64)

        if tau_c is None:
            tau_c = jnp.zeros_like(H2)
        tau_eff = jnp.where(S.grounded_ice(mask), jnp.asarray(tau_c, jnp.float64), 0.0)

        fixed2 = ~icy if self.bc_mask is None \
            else (~icy) | jnp.asarray(self.bc_mask, bool)
        bc3 = fixed2[..., None] & jnp.ones((1, 1, Mz), bool)

        dz_l = jnp.concatenate([dzeta[:1], dzeta])      # below level k (clamped)
        dz_u = jnp.concatenate([dzeta, dzeta[-1:]])     # above level k (clamped)
        # finite-volume cell heights: half cells at the bed and surface so
        # the column weights sum to exactly 1 (the discrete column balance
        # must equate basal traction with the integrated driving stress)
        dz0 = jnp.concatenate([jnp.zeros(1), dzeta])
        dz1 = jnp.concatenate([dzeta, jnp.zeros(1)])
        dz_c = 0.5 * (dz0 + dz1)

        def free(x):
            return (jnp.where(bc3, 0.0, x[0]), jnp.where(bc3, 0.0, x[1]))

        def ddzeta(a):
            """Centered d/dzeta (one-sided at the ends)."""
            d_int = (a[..., 2:] - a[..., :-2]) / (dz_l[1:-1] + dz_u[1:-1])
            d_lo = (a[..., 1:2] - a[..., 0:1]) / dzeta[0]
            d_hi = (a[..., -1:] - a[..., -2:-1]) / dzeta[-1]
            return jnp.concatenate([d_lo, d_int, d_hi], axis=-1)

        def center_grads(u_a, v_a):
            """Horizontal strain-rate ingredients at constant z via the
            sigma-coordinate chain rule (cell centers, per level)."""
            u_zeta, v_zeta = ddzeta(u_a), ddzeta(v_a)
            ux = (sh(u_a, 0, 1) - sh(u_a, 0, -1)) / (2 * dx) + zxc * u_zeta
            vy = (sh(v_a, 1, 0) - sh(v_a, -1, 0)) / (2 * dy) + zyc * v_zeta
            uy = (sh(u_a, 1, 0) - sh(u_a, -1, 0)) / (2 * dy) + zyc * u_zeta
            vx = (sh(v_a, 0, 1) - sh(v_a, 0, -1)) / (2 * dx) + zxc * v_zeta
            return ux, uy, vx, vy, u_zeta, v_zeta

        def strain_nu_eps(u, v):
            """Effective viscosity [Pa s] and squared effective strain rate
            [1/s^2] at cell centers/levels (1/year units internally for
            f32-safe powers; rescaled to SI)."""
            u_a, v_a = u * SPY, v * SPY
            ux, uy, vx, vy, u_zeta, v_zeta = center_grads(u_a, v_a)
            uz = u_zeta / Hs
            vz = v_zeta / Hs
            reg_a = self.eps_reg2 * SPY * SPY
            eps2 = (ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2
                    + 0.25 * uz ** 2 + 0.25 * vz ** 2 + reg_a)
            nu = 0.5 * B3 * eps2 ** ((1.0 - self.n_glen) / (2.0 * self.n_glen)) \
                * SPY ** ((self.n_glen - 1.0) / self.n_glen)
            return nu, eps2 / (SPY * SPY)

        def strain_and_nu(u, v):
            return strain_nu_eps(u, v)[0]

        # depth-varying calving-front pressure imbalance per level of each
        # icy cell: rho_i g (s - z) - rho_w g max(sl - z, 0)
        if self.cfbc:
            ocn = mask == S.MASK_ICE_FREE_OCEAN
            z_abs = base2[..., None] + zeta * H2[..., None]
            sl2 = jnp.asarray(geom.sea_level, jnp.float64)
            p_diff = (self.rho * self.g * H2[..., None] * (1.0 - zeta)
                      - self.rho_w * self.g
                      * jnp.maximum(sl2[..., None] - z_abs, 0.0))
            p_diff = jnp.where(icy[..., None], p_diff, 0.0)
            # east-face field stored at i (face between i and i+1); same for
            # north faces: traction evaluated at the icy side's levels
            front_xx = (jnp.where((icy & sh(ocn, 0, 1))[..., None], p_diff, 0.0)
                        + jnp.where((ocn & icy_e)[..., None],
                                    sh(p_diff, 0, 1), 0.0))
            front_yy = (jnp.where((icy & sh(ocn, 1, 0))[..., None], p_diff, 0.0)
                        + jnp.where((ocn & icy_n)[..., None],
                                    sh(p_diff, 1, 0), 0.0))
        else:
            front_xx = front_yy = 0.0

        def residual(uv):
            u, v = free(uv)
            nu = strain_and_nu(u, v)

            # --- membrane terms per level (per-volume: nu on faces) -------
            nuH_e = 0.5 * (nu + sh(nu, 0, 1)) * keep_e
            nuH_n = 0.5 * (nu + sh(nu, 1, 0)) * keep_n

            # metric coefficients and vertical derivatives at faces
            u_zeta, v_zeta = ddzeta(u), ddzeta(v)
            zx_e = 0.5 * (zxc + sh(zxc, 0, 1))
            zy_e = 0.5 * (zyc + sh(zyc, 0, 1))
            zx_n = 0.5 * (zxc + sh(zxc, 1, 0))
            zy_n = 0.5 * (zyc + sh(zyc, 1, 0))
            uz_e = 0.5 * (u_zeta + sh(u_zeta, 0, 1))
            vz_e = 0.5 * (v_zeta + sh(v_zeta, 0, 1))
            uz_n = 0.5 * (u_zeta + sh(u_zeta, 1, 0))
            vz_n = 0.5 * (v_zeta + sh(v_zeta, 1, 0))

            ux_e = (sh(u, 0, 1) - u) / dx + zx_e * uz_e
            vy_e = (sh(v, 1, 0) + sh(v, 1, 1) - sh(v, -1, 0) - sh(v, -1, 1)) \
                / (4 * dy) + zy_e * vz_e
            Txx_e = nuH_e * (4.0 * ux_e + 2.0 * vy_e) + front_xx

            uy_n = (sh(u, 1, 0) - u) / dy + zy_n * uz_n
            vx_n = (sh(v, 0, 1) + sh(v, 1, 1) - sh(v, 0, -1) - sh(v, 1, -1)) \
                / (4 * dx) + zx_n * vz_n
            Txy_n = nuH_n * (uy_n + vx_n)

            div_x = ((Txx_e - sh(Txx_e, 0, -1)) / dx
                     + (Txy_n - sh(Txy_n, -1, 0)) / dy)

            vy_n = (sh(v, 1, 0) - v) / dy + zy_n * vz_n
            ux_n = (sh(u, 0, 1) + sh(u, 1, 1) - sh(u, 0, -1) - sh(u, 1, -1)) \
                / (4 * dx) + zx_n * uz_n
            Tyy_n = nuH_n * (4.0 * vy_n + 2.0 * ux_n) + front_yy

            uy_e = (sh(u, 1, 0) + sh(u, 1, 1) - sh(u, -1, 0) - sh(u, -1, 1)) \
                / (4 * dy) + zy_e * uz_e
            vx_e = (sh(v, 0, 1) - v) / dx + zx_e * vz_e
            Txy_e = nuH_e * (uy_e + vx_e)

            div_y = ((Txy_e - sh(Txy_e, 0, -1)) / dx
                     + (Tyy_n - sh(Tyy_n, -1, 0)) / dy)

            # --- metric correction of the divergence itself ----------------
            # d/dx|_z T = d/dx|_zeta T + zeta_x dT/dzeta: the staggered
            # differences above supply the constant-zeta part; add the
            # chain-rule part from center-evaluated stresses
            ux_c, uy_c, vx_c, vy_c, _, _ = center_grads(u, v)
            keep_c = (keep_e * sh(keep_e, 0, -1) * keep_n * sh(keep_n, -1, 0))
            Txx_c = nu * (4.0 * ux_c + 2.0 * vy_c) * keep_c
            Tyy_c = nu * (4.0 * vy_c + 2.0 * ux_c) * keep_c
            Txy_c = nu * (uy_c + vx_c) * keep_c
            div_x = div_x + zxc * ddzeta(Txx_c) + zyc * ddzeta(Txy_c)
            div_y = div_y + zxc * ddzeta(Txy_c) + zyc * ddzeta(Tyy_c)

            # --- vertical shear term: (1/H) d/dzeta(nu u_zeta / H) --------
            nu_mid = 0.5 * (nu[..., 1:] + nu[..., :-1])

            def vert(a):
                flux = nu_mid * (a[..., 1:] - a[..., :-1]) / dzeta / Hs
                # surface: stress-free (flux 0); base handled via beta below
                lo = jnp.zeros_like(flux[..., :1])
                fz = jnp.concatenate([lo, flux, jnp.zeros_like(flux[..., :1])],
                                     axis=-1)
                return (fz[..., 1:] - fz[..., :-1]) / dz_c / Hs

            Vu = vert(u)
            Vv = vert(v)

            # --- basal sliding at the bottom level ------------------------
            beta = jax.lax.stop_gradient(
                self.sliding_law.beta(tau_eff, u[..., 0], v[..., 0])
                + self.beta_floor)
            drag_u = jnp.zeros(grid.shape3).at[..., 0].set(
                beta * u[..., 0] / (dz_c[0] * Hs[..., 0]))
            drag_v = jnp.zeros(grid.shape3).at[..., 0].set(
                beta * v[..., 0] / (dz_c[0] * Hs[..., 0]))

            Fx = -(div_x + Vu - drag_u) - bx
            Fy = -(div_y + Vv - drag_v) - by
            return free((Fx, Fy))

        # ------------------------------------------------------------------
        def dot(a, b_):
            return jnp.sum(a[0] * b_[0]) + jnp.sum(a[1] * b_[1])

        def make_precond(uv):
            """Vertical-line preconditioner: invert (diag_h + d/dz nu d/dz)
            per column with the batched Thomas kernel."""
            u, v = free(uv)
            nu = strain_and_nu(u, v)
            nuH_e = 0.5 * (nu + sh(nu, 0, 1)) * keep_e
            nuH_n = 0.5 * (nu + sh(nu, 1, 0)) * keep_n
            diag_h = (4.0 * (nuH_e + sh(nuH_e, 0, -1)) / dx ** 2
                      + (nuH_n + sh(nuH_n, -1, 0)) / dy ** 2)
            nu_mid = 0.5 * (nu[..., 1:] + nu[..., :-1])
            w = nu_mid / dzeta / (Hs ** 2)            # interface weights
            lo = jnp.concatenate([jnp.zeros_like(w[..., :1]), w], axis=-1)
            hi = jnp.concatenate([w, jnp.zeros_like(w[..., :1])], axis=-1)
            beta = self.sliding_law.beta(tau_eff, u[..., 0], v[..., 0]) \
                + self.beta_floor
            a = -lo / dz_c
            c = -hi / dz_c
            b = diag_h + (lo + hi) / dz_c
            b = b.at[..., 0].add(beta / (dz_c[0] * Hs[..., 0]))
            b = jnp.where(bc3, 1.0, jnp.maximum(b, 1e-12))
            a = jnp.where(bc3, 0.0, a)
            c = jnp.where(bc3, 0.0, c)

            def precond(r):
                return (solve_batched(a, b, c, r[0]),
                        solve_batched(a, b, c, r[1]))

            return precond

        zero3 = jnp.zeros(grid.shape3, jnp.float64)
        u_init = zero3 if u0 is None else jnp.asarray(u0, jnp.float64)
        v_init = zero3 if v0 is None else jnp.asarray(v0, jnp.float64)
        uv = free((u_init, v_init))

        b_norm2 = dot(free((bx, by)), free((bx, by)))
        tol2 = jnp.maximum(self.newton_rtol ** 2 * b_norm2, 1e-300)
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625, 0.01])

        def newton_body(carry):
            uv, F, F2, chg2, it = carry

            # linearize once per sweep (jax.jvp would recompute the primal
            # residual at every Krylov iteration)
            _, jvp_lin = jax.linearize(residual, uv)

            def jmv(d):
                Jd = jvp_lin(free(d))
                return (Jd[0] + jnp.where(bc3, d[0], 0.0),
                        Jd[1] + jnp.where(bc3, d[1], 0.0))

            precond = make_precond(uv)
            negF = (-F[0], -F[1])
            zero = (jnp.zeros_like(F[0]), jnp.zeros_like(F[1]))
            d, _, _ = ssa_ops.bicgstab_solve(
                jmv, negF, zero, precond, rtol=self.ksp_rtol,
                max_iter=self.ksp_max)
            d = free(d)

            def trial(alpha):
                cand = (uv[0] + alpha * d[0], uv[1] + alpha * d[1])
                Fc = residual(cand)
                return dot(Fc, Fc)

            norms = jax.vmap(trial)(alphas)
            k = jnp.argmin(norms)
            uv_new = (uv[0] + alphas[k] * d[0], uv[1] + alphas[k] * d[1])
            F2_new = norms[k]
            worse = F2_new >= F2
            uv_new = (jnp.where(worse, uv[0], uv_new[0]),
                      jnp.where(worse, uv[1], uv_new[1]))
            F_new = residual(uv_new)
            F2_new = jnp.where(worse, F2, F2_new)
            dchg = (uv_new[0] - uv[0], uv_new[1] - uv[1])
            chg2 = dot(dchg, dchg) / jnp.maximum(dot(uv_new, uv_new), 1e-300)
            return (uv_new, F_new, F2_new, chg2, it + 1)

        def newton_cond(carry):
            _, _, F2, chg2, it = carry
            return (F2 > tol2) & (chg2 > 1e-16) & (it < self.newton_max)

        F0 = residual(uv)
        uv, F, F2, chg2, iters = jax.lax.while_loop(
            newton_cond, newton_body,
            (uv, F0, dot(F0, F0), jnp.asarray(1.0), jnp.asarray(0)))

        u, v = free(uv)
        if full_output:
            # volumetric first-order dissipation Phi = 4 nu eps^2 [W/m^3]
            # on the zeta grid (the role of BlatterMod's Sigma)
            nu_f, eps2_f = strain_nu_eps(u, v)
            Phi = jnp.where(icy[..., None], 4.0 * nu_f * eps2_f, 0.0)
            return u, v, Phi, iters
        if diagnostics:
            return u, v, {"newton_iters": iters, "F2_final": F2,
                          "tol2": tol2, "b_norm2": b_norm2,
                          "residual_fn": residual}
        return u, v

    # -- composite-model helpers ----------------------------------------------
    def vertical_average(self, f3):
        """Column average over zeta (equals the z-average for any H)."""
        z = np.asarray(self.grid.z)
        zeta = z / max(z[-1], 1.0)
        dz = np.diff(zeta)
        w = np.concatenate([dz[:1] * 0.5, 0.5 * (dz[1:] + dz[:-1]),
                            dz[-1:] * 0.5])
        return jnp.tensordot(f3, jnp.asarray(w, f3.dtype), axes=([-1], [0]),
                             precision=self.matmul_precision)

    def regrid_to_z(self, f3, H):
        """Interpolate a zeta-grid column field onto the model's fixed
        z levels (height above base); zero above the local ice surface
        (matching the SIA 3D reconstruction convention)."""
        z = jnp.asarray(self.grid.z, f3.dtype)
        zeta = jnp.asarray(self.zeta, f3.dtype)
        Hc = jnp.maximum(H, 1.0)[..., None]
        zt = jnp.clip(z / Hc, 0.0, 1.0)                    # (My, Mx, Mz)
        idx = jnp.clip(jnp.searchsorted(zeta, zt, side="right") - 1,
                       0, zeta.shape[0] - 2)
        z0 = jnp.take(zeta, idx)
        dz = jnp.take(zeta, idx + 1) - z0
        wgt = jnp.clip((zt - z0) / jnp.maximum(dz, 1e-12), 0.0, 1.0)
        f0 = jnp.take_along_axis(f3, idx, axis=-1)
        f1 = jnp.take_along_axis(f3, idx + 1, axis=-1)
        out = f0 * (1.0 - wgt) + f1 * wgt
        in_ice = (z <= H[..., None]) | (jnp.arange(z.shape[0]) == 0)
        return jnp.where(in_ice, out, 0.0)
