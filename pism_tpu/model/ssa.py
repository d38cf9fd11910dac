"""SSA stress-balance solver: Newton-Krylov with Picard warmup.

Rebuild of PISM ``src/stressbalance/ssa/SSAFD.cc`` — and an upgrade of its
numerics. The reference runs a Picard iteration on the effective viscosity
nuH, assembling a PETSc matrix and calling KSPSolve each iteration; Picard
converges slowly for shelf-dominated problems. Here the nonlinear residual
is a pure JAX function, so the exact Jacobian-vector product comes from
``jax.jvp`` (autodiff through viscosity AND sliding-law drag), enabling a
matrix-free **Newton-Krylov** method: a few Picard warmup sweeps to enter
the basin, then Newton steps with backtracking line search, each solving
J d = -F by Jacobi-preconditioned BiCGStab in a ``lax.while_loop``. The
whole nonlinear solve stays on device inside jit; Krylov dot products lower
to collectives on a mesh (the allreduce in every PETSc KSP iteration;
SURVEY.md §2.5).

Front treatment (PISM's calving-front stress boundary condition,
``stress_balance.calving_front_stress_bc``; Winkelmann et al. 2011):
ice-free cells become Dirichlet u = 0 rows decoupled from the ice, no
membrane stress is transmitted across icy<->ice-free faces, and the
depth-integrated pressure imbalance

    T_front = 1/2 g (rho_i H^2 - rho_w d^2),   d = min(max(sl-b, 0), mu H)

(mu = rho_i/rho_w; d = submerged front depth) enters the right-hand side of
frontal cells. The driving stress uses one-sided surface gradients at the
ice margin. Thin icy cells get PISM's strength extension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from .. import state as S
from ..ops import ssa as ssa_ops
from ..ops.stencils import Shifter
from ..physics.basal import SlidingLaw


@dataclass
class SSAFD:
    grid: object
    config: object
    flow_law: object
    sliding_law: Optional[SlidingLaw] = None
    # optional static Dirichlet BC: where bc_mask, velocity fixed
    bc_mask: Optional[jnp.ndarray] = None
    bc_u: Optional[jnp.ndarray] = None
    bc_v: Optional[jnp.ndarray] = None
    # optional prescribed driving stress (verification test cases override
    # the geometric driving stress, like PISM's SSATestCase subclasses)
    taud_x: Optional[jnp.ndarray] = None
    taud_y: Optional[jnp.ndarray] = None
    # regional mode (reference SSAFD_Regional::compute_driving_stress):
    # inside the no-model strip the driving stress is recomputed from the
    # *stored* surface and thickness (usurfstore/thkstore) with
    # differences confined to the strip — or zeroed with
    # regional.zero_gradient
    no_model_mask: Optional[jnp.ndarray] = None
    stored_surface: Optional[jnp.ndarray] = None
    stored_thickness: Optional[jnp.ndarray] = None

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid)
        self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.e_ssa = cfg.get_number("stress_balance.ssa.enhancement_factor")
        self.rho = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.picard_warmup = cfg.get_int("stress_balance.ssa.fd.picard_warmup")
        self.drag_jacobian = cfg.get_string("stress_balance.ssa.fd.drag_jacobian")
        # reference stress_balance.ssa.fd.max_iterations (the Picard/outer
        # iteration cap) wins over the rebuild's newton_max_iterations name
        # when explicitly set
        if cfg.is_set("stress_balance.ssa.fd.max_iterations"):
            self.newton_max_override = cfg.get_int(
                "stress_balance.ssa.fd.max_iterations")
        else:
            self.newton_max_override = None
        self.newton_rtol = cfg.get_number("stress_balance.ssa.fd.newton_rtol")
        self.newton_max = cfg.get_int("stress_balance.ssa.fd.newton_max_iterations")
        if self.newton_max_override is not None:
            self.newton_max = self.newton_max_override
        self.ksp_rtol = cfg.get_number("stress_balance.ssa.fd.ksp_rtol")
        self.near_ksp_cap = cfg.get_int("stress_balance.ssa.fd.near_ksp_cap")
        self.safeguard_ksp_cap = cfg.get_int(
            "stress_balance.ssa.fd.safeguard_ksp_cap")
        self.f32_production_rtol = cfg.get_number(
            "stress_balance.ssa.fd.f32_production_rtol")
        self.mixed_production_rtol = cfg.get_number(
            "stress_balance.ssa.fd.mixed_production_rtol")
        self.ksp_rtol_max = cfg.get_number("stress_balance.ssa.fd.ksp_rtol_max")
        self.warmup_ksp_rtol = cfg.get_number("stress_balance.ssa.fd.warmup_ksp_rtol")
        self.warmup_skip_rtol = cfg.get_number("stress_balance.ssa.fd.warmup_skip_rtol")
        self.eta_endgame_range = cfg.get_number(
            "stress_balance.ssa.fd.eta_endgame_range")
        self.ksp_max = cfg.get_int("stress_balance.ssa.fd.ksp_max_it")
        # inner Krylov method (reference -ssafd_ksp_type): BiCGStab default
        # (the CFBC/Dirichlet closure breaks symmetry), CG for symmetric
        # interior/verification problems
        _km = cfg.get_string("stress_balance.ssa.fd.krylov_method")
        if _km not in ("bicgstab", "cg"):
            raise ValueError(
                f"stress_balance.ssa.fd.krylov_method = {_km!r}: "
                "expected bicgstab | cg")
        if _km == "cg":
            self._krylov = ssa_ops.cg_solve
        else:
            self._krylov = ssa_ops.bicgstab_solve
        self.epsilon = cfg.get_number("stress_balance.ssa.epsilon")  # Pa s m
        ext_nu = cfg.get_number("stress_balance.ssa.strength_extension.constant_nu")
        ext_H = cfg.get_number("stress_balance.ssa.strength_extension.min_thickness")
        self.extension_nuH = ext_nu * ext_H
        self.extension_Hmin = ext_H
        svel = cfg.get_number("stress_balance.ssa.Schoof_regularizing_velocity", "m s-1")
        slen = cfg.get_number("stress_balance.ssa.Schoof_regularizing_length", "m")
        self.eps_reg2 = (svel / slen) ** 2
        # tiny drag on every icy cell: keeps rows of isolated floating cells
        # (not yet removed by the iceberg remover) non-singular
        self.beta_floor = cfg.get_number("stress_balance.ssa.fd.beta_floor")
        # lateral drag along ice-free-bedrock walls (PIK fjord-wall drag):
        # nuH-style viscosity converted to an equivalent basal-drag density
        # nu H / dx^2, plus an optional direct beta addition
        self.lateral_drag = cfg.get_flag(
            "stress_balance.ssa.fd.lateral_drag.enabled")
        self.lateral_nu = cfg.get_number(
            "stress_balance.ssa.fd.lateral_drag.viscosity")
        self.beta_lateral = cfg.get_number(
            "basal_resistance.beta_lateral_margin")
        self.max_speed = cfg.get_number("stress_balance.ssa.fd.max_speed", "m s-1")
        self.subgl_drag = cfg.get_flag("geometry.grounded_cell_fraction")
        self.solve_dtype = cfg.get_string("stress_balance.ssa.fd.solve_dtype")
        if self.solve_dtype == "auto":
            # production runs (velocity-change stop active) never resolve
            # residuals below the f32 noise floor, and the per-sweep f64
            # residual leaves the iteration history bit-for-bit identical
            # (examples/ssa_eta_study.py), so it is pure cost.
            # Full-convergence runs (stop disabled: verification, inverse)
            # keep the f64-carry mixed path, which reaches ~1e-6 relative
            # residuals.
            chg = cfg.get_number("stress_balance.ssa.fd.velocity_change_rtol")
            self.solve_dtype = "float32" if chg > 0.0 else "mixed"
        self.precond_kind = cfg.get_string("stress_balance.ssa.fd.preconditioner")
        self.line_pcr_dtype = cfg.get_string(
            "stress_balance.ssa.fd.line_pcr_dtype")
        self.line_block = cfg.get_int("stress_balance.ssa.fd.line_block")
        # fracture-induced softening (Albrecht & Levermann 2012): the
        # reference applies it inside SSAFD::compute_nuH when
        # fracture_density.softening_lower_limit < 1
        self.frac_soft_min = cfg.get_number(
            "fracture_density.softening_lower_limit")
        self.regional_zero_gradient = cfg.get_flag("regional.zero_gradient")
        if self.sliding_law is None:
            self.sliding_law = SlidingLaw.from_config(cfg)

    # ------------------------------------------------------------------
    def driving_stress(self, geometry, icy):
        """tau_d = -rho g H grad(s); one-sided at ice margins (PISM
        ``SSA::compute_driving_stress`` margin treatment under CFBC)."""
        sh = self.sh
        s = geometry.ice_surface_elevation
        H = geometry.ice_thickness
        dx, dy = self.grid.dx, self.grid.dy

        def masked_grad(axis_shift, d):
            icy_p = sh(icy, *axis_shift)
            icy_m = sh(icy, *[-a for a in axis_shift])
            s_p = sh(s, *axis_shift)
            s_m = sh(s, *[-a for a in axis_shift])
            centered = (s_p - s_m) / (2.0 * d)
            one_p = (s_p - s) / d      # only + neighbor icy
            one_m = (s - s_m) / d      # only - neighbor icy
            return jnp.where(icy_p & icy_m, centered,
                             jnp.where(icy_p, one_p,
                                       jnp.where(icy_m, one_m, 0.0)))

        sx = masked_grad((0, 1), dx)
        sy = masked_grad((1, 0), dy)
        f = -self.rho * self.g * H
        return f * sx, f * sy

    def _hardness(self, state: S.ModelState):
        H = state.geometry.ice_thickness
        if state.enthalpy is None:
            B = self.flow_law.hardness(jnp.zeros_like(H), jnp.zeros_like(H))
        else:
            B = self.flow_law.averaged_hardness(H, state.enthalpy,
                                                jnp.asarray(self.grid.z, H.dtype))
        # SSA enhancement factor scales softness: B -> B * e^(-1/n)
        B = B * self.e_ssa ** (-1.0 / self.n_glen)
        # fracture-induced softening (reference: SSAFD::compute_nuH when
        # fracture_density.softening_lower_limit = eps < 1): softness
        # A -> A * (1 - (1-eps) phi)^(-n), i.e. hardness
        # B -> B * (1 - (1-eps) phi), bounded below by eps at phi = 1
        phi = state.fracture_density
        if phi is not None and self.frac_soft_min != 1.0:
            eps = self.frac_soft_min
            B = B * jnp.maximum(
                1.0 - (1.0 - eps) * jnp.asarray(phi, B.dtype), eps)
        return B

    def _front_stress(self, geometry, water_column_pressure=None):
        """T_front = H (P_ice_avg - P_water_avg) per cell [Pa m]; with the
        hydrostatic default this is 1/2 g (rho_i H^2 - rho_w d^2). An
        ocean-model ``water_column_pressure`` (melange back-pressure
        modifiers, reference ``ocean::Frac_MBP``/``Delta_MBP``) raises the
        water-side average and weakens the calving-front spreading."""
        H = geometry.ice_thickness
        if water_column_pressure is not None:
            Pw = jnp.asarray(water_column_pressure, H.dtype)
            return H * (0.5 * self.g * self.rho * H - Pw)
        b = geometry.bed_elevation
        sl = geometry.sea_level
        mu = self.rho / self.rho_w
        d = jnp.minimum(jnp.maximum(sl - b, 0.0), mu * H)
        return 0.5 * self.g * (self.rho * H ** 2 - self.rho_w * d ** 2)

    # ------------------------------------------------------------------
    def build_problem(self, state: S.ModelState, tau_c=None,
                      differentiable_beta: bool = False,
                      hardness=None,
                      water_column_pressure=None) -> dict:
        """Assemble the discrete SSA problem: masks, RHS (driving stress +
        calving-front terms), and the nonlinear residual closure. Used by
        :meth:`solve` and by the inverse toolkit (which differentiates the
        residual with respect to tau_c via the implicit function theorem).

        ``hardness``: optional override of the vertically-averaged hardness
        field (the design variable of the reference's
        ``IP_SSAHardavForwardProblem`` hardness inversion).

        ``differentiable_beta``: by default the sliding-law drag coefficient
        is wrapped in stop_gradient inside the residual — beta ~
        tau_c |u|^(q-1) is near-singular at u -> 0 and the exact Newton
        direction through it is wild (per-cell steps of 1e4 m/a that defeat
        any line search); freezing beta in the linearization (drag handled
        Picard-style, viscosity Newton-style) is the reference's effective
        scheme and ISSM's 'incomplete Jacobian'. The residual VALUE is
        unchanged either way. The inverse toolkit sets True: adjoints need
        d(beta u)/du and d(beta u)/d tau_c.
        """
        grid, sh = self.grid, self.sh
        geom = state.geometry
        H = geom.ice_thickness
        mask = geom.cell_type
        dtype = H.dtype
        dx, dy = grid.dx, grid.dy

        icy = S.icy(mask)

        B = self._hardness(state) if hardness is None \
            else jnp.asarray(hardness, dtype)
        if self.taud_x is not None:
            bx = jnp.asarray(self.taud_x, dtype)
            by = jnp.asarray(self.taud_y, dtype)
        else:
            bx, by = self.driving_stress(geom, icy)

        # calving-front pressure-imbalance terms on front faces
        Tf = self._front_stress(geom, water_column_pressure)
        icy_e = sh(icy, 0, 1)
        icy_w = sh(icy, 0, -1)
        icy_n = sh(icy, 1, 0)
        icy_s = sh(icy, -1, 0)
        bx = bx + jnp.where(icy & ~icy_e, Tf / dx, 0.0) \
                - jnp.where(icy & ~icy_w, Tf / dx, 0.0)
        by = by + jnp.where(icy & ~icy_n, Tf / dy, 0.0) \
                - jnp.where(icy & ~icy_s, Tf / dy, 0.0)
        if self.no_model_mask is not None:
            # reference SSAFD_Regional::compute_driving_stress: in the
            # strip, tau_d = -rho g thkstore grad(usurfstore) with
            # differences using only neighbors that are ALSO in the strip
            # (usurfstore is only meaningful there); zero if isolated or
            # with regional.zero_gradient
            nmm = jnp.asarray(self.no_model_mask, bool)
            if self.regional_zero_gradient or self.stored_surface is None:
                bx = jnp.where(nmm, 0.0, bx)
                by = jnp.where(nmm, 0.0, by)
            else:
                hst = jnp.asarray(self.stored_surface, dtype)
                Hst = jnp.asarray(self.stored_thickness, dtype)

                def strip_grad(axis_shift, d):
                    in_p = sh(nmm, *axis_shift)
                    in_m = sh(nmm, *[-a for a in axis_shift])
                    h_p = sh(hst, *axis_shift)
                    h_m = sh(hst, *[-a for a in axis_shift])
                    return jnp.where(
                        in_p & in_m, (h_p - h_m) / (2.0 * d),
                        jnp.where(in_p, (h_p - hst) / d,
                                  jnp.where(in_m, (hst - h_m) / d, 0.0)))

                P = self.rho * self.g * jnp.maximum(Hst, 0.0)
                bx = jnp.where(nmm, -P * strip_grad((0, 1), dx), bx)
                by = jnp.where(nmm, -P * strip_grad((1, 0), dy), by)

        # stress transmitted only across icy-icy faces
        keep_e = (icy & icy_e).astype(dtype)
        keep_n = (icy & icy_n).astype(dtype)

        extension_mask = icy & (H < self.extension_Hmin)

        if tau_c is None:
            tau_c = jnp.zeros_like(H)
        grounded_ice_mask = S.grounded_ice(mask)
        # sub-grid grounding line: scale basal drag by the grounded cell
        # fraction (PISM ``geometry.grounded_cell_fraction``; Feldmann et
        # al. 2014) — essential against coarse-grid GL over-advance
        gf = geom.cell_grounded_fraction if self.subgl_drag else None

        # Dirichlet rows: ice-free cells (decoupled) + static BC
        if self.bc_mask is not None:
            bc_mask = jnp.asarray(self.bc_mask, bool) | ~icy
            bc_u = jnp.where(jnp.asarray(self.bc_mask, bool),
                             jnp.asarray(self.bc_u, dtype), 0.0)
            bc_v = jnp.where(jnp.asarray(self.bc_mask, bool),
                             jnp.asarray(self.bc_v, dtype), 0.0)
        else:
            bc_mask = ~icy
            bc_u = jnp.zeros_like(H)
            bc_v = jnp.zeros_like(H)

        def free(x):
            return (jnp.where(bc_mask, 0.0, x[0]), jnp.where(bc_mask, 0.0, x[1]))

        def full(x):
            return (jnp.where(bc_mask, bc_u, x[0]), jnp.where(bc_mask, bc_v, x[1]))

        def make_nuH(u, v):
            nuH = ssa_ops.compute_nuH(
                u, v, B, H, dx, dy, sh, n_glen=self.n_glen,
                eps_reg2=self.eps_reg2, extension_nuH=self.extension_nuH,
                extension_mask=extension_mask)
            return ssa_ops.NuH((nuH.e + self.epsilon) * keep_e,
                               (nuH.n + self.epsilon) * keep_n)

        beta_extra = self.beta_floor
        if self.lateral_drag or self.beta_lateral > 0.0:
            bedrock = mask == S.MASK_ICE_FREE_BEDROCK
            wall = icy & (sh(bedrock, 0, 1) | sh(bedrock, 0, -1)
                          | sh(bedrock, 1, 0) | sh(bedrock, -1, 0))
            lat = self.beta_lateral
            if self.lateral_drag:
                lat = lat + self.lateral_nu * H / dx ** 2
            beta_extra = beta_extra + jnp.where(wall, lat, 0.0)

        def beta_fn(u, v, tc=tau_c, reg=None):
            if gf is not None:
                tc_eff = tc * jnp.where(icy, gf, 0.0)
            else:
                tc_eff = jnp.where(grounded_ice_mask, tc, 0.0)
            return self.sliding_law.beta(tc_eff, u, v, reg=reg) + beta_extra

        def apply_op(u, v, nuH, beta):
            return ssa_ops.apply_operator(u, v, nuH, beta, dx, dy, sh)

        def residual(uv, tc=tau_c):
            """Nonlinear residual on the free rows (full fields in the
            stencil, so nonzero Dirichlet values need no RHS correction)."""
            u, v = full(uv)
            nuH = make_nuH(u, v)
            beta = beta_fn(u, v, tc)
            if not differentiable_beta:
                beta = jax.lax.stop_gradient(beta)
            Au, Av = apply_op(u, v, nuH, beta)
            return free((Au - bx, Av - by))

        return dict(residual=residual, free=free, full=full,
                    make_nuH=make_nuH, beta_fn=beta_fn, apply=apply_op,
                    bc_mask=bc_mask, bc_u=bc_u, bc_v=bc_v, bx=bx, by=by,
                    icy=icy, tau_c=tau_c)

    def solve(self, state: S.ModelState, tau_c=None, u0=None, v0=None,
              diagnostics: bool = False, hardness=None,
              water_column_pressure=None):
        """Solve for (u, v); fully traced (usable inside jitted step).

        With diagnostics=True also returns a dict with the Newton iteration
        count and final/initial residual norms (PISM logs the same from its
        Picard loop).

        Precision: with ``stress_balance.ssa.fd.solve_dtype = "float64"``
        (default) the nonlinear solve runs in a float64 island regardless of
        the model field dtype — nuH spans ~1e13..1e19 Pa s m and pure-f32
        Krylov iterations stagnate. ``"mixed"`` keeps the vectors (and all
        stencil work) in float32 but accumulates every Krylov/Newton dot
        product in float64 — the scalar recurrences are where f32
        cancellation kills convergence — and halves the bytes every
        stencil pass moves.
        """
        out_dtype = state.geometry.ice_thickness.dtype
        if out_dtype != jnp.float64 and self.solve_dtype == "float64":
            f64 = lambda a: None if a is None else jnp.asarray(a, jnp.float64)
            geom64 = state.geometry.replace(
                ice_thickness=f64(state.geometry.ice_thickness),
                bed_elevation=f64(state.geometry.bed_elevation),
                sea_level=f64(state.geometry.sea_level),
                ice_surface_elevation=f64(state.geometry.ice_surface_elevation),
            )
            state = state.replace(
                geometry=geom64,
                enthalpy=f64(state.enthalpy),
                u_ssa=f64(state.u_ssa), v_ssa=f64(state.v_ssa))
            tau_c = f64(tau_c)
            u0, v0 = f64(u0), f64(v0)
            res = self.solve(state, tau_c, u0, v0, diagnostics, f64(hardness))
            if diagnostics:
                u, v, info = res
                return u.astype(out_dtype), v.astype(out_dtype), info
            u, v = res
            return u.astype(out_dtype), v.astype(out_dtype)

        grid, sh = self.grid, self.sh
        geom = state.geometry
        H = geom.ice_thickness
        mask = geom.cell_type
        dtype = H.dtype
        dx, dy = grid.dx, grid.dy

        P = self.build_problem(state, tau_c, hardness=hardness,
                               differentiable_beta=(self.drag_jacobian
                                                    == "exact"),
                               water_column_pressure=water_column_pressure)
        apply_op = P["apply"]
        free, full = P["free"], P["full"]
        residual = P["residual"]
        make_nuH, beta_fn = P["make_nuH"], P["beta_fn"]
        bc_mask, bc_u, bc_v = P["bc_mask"], P["bc_u"], P["bc_v"]
        bx, by = P["bx"], P["by"]

        chg_rtol_cfg_early = self.config.get_number(
            "stress_balance.ssa.fd.velocity_change_rtol")
        # mixed precision: accumulate the Krylov/Newton dot products in f64
        # under f32 vectors: the scalar recurrences are where f32
        # cancellation kills convergence.
        # auto: f32 dots on the pure-f32 production path (target 3e-4 sits
        # far above the f32 dot noise; unchanged iteration counts at 5 km),
        # f64 dots wherever convergence
        # semantics are tight (mixed / float64 / full-convergence solves).
        kdd = self.config.get_string("stress_balance.ssa.fd.krylov_dot_dtype")
        if kdd == "auto":
            kdd = ("float32"
                   if (chg_rtol_cfg_early > 0.0
                       and self.solve_dtype == "float32")
                   else "float64")
        ddt = (jnp.float64 if dtype == jnp.float32 and kdd == "float64"
               else None)

        # mixed = iterative refinement: the ITERATE and the outer residual
        # evaluations live in float64 (one f64 stencil apply per Newton
        # sweep — the f32 operator apply has a cancellation noise floor of
        # ~1e-4 relative, which is exactly where a pure-f32 Newton stalls),
        # while every Krylov iteration (the ~100x more numerous stencil
        # applies) runs in float32, so ~97% of the stencil passes move
        # half the bytes of an f64 solve.
        mixed = dtype == jnp.float32 and self.solve_dtype == "mixed"
        if mixed:
            f64c = lambda a: None if a is None else jnp.asarray(a, jnp.float64)
            geom64 = state.geometry.replace(
                ice_thickness=f64c(H),
                bed_elevation=f64c(geom.bed_elevation),
                sea_level=f64c(geom.sea_level),
                ice_surface_elevation=f64c(geom.ice_surface_elevation))
            state64 = state.replace(
                geometry=geom64, enthalpy=f64c(state.enthalpy),
                u_ssa=f64c(state.u_ssa), v_ssa=f64c(state.v_ssa))
            P_hi = self.build_problem(
                state64, f64c(P["tau_c"]), hardness=f64c(hardness),
                water_column_pressure=f64c(water_column_pressure)
                if water_column_pressure is not None else None)
            residual_hi, free_hi = P_hi["residual"], P_hi["free"]
            bx_hi, by_hi = P_hi["bx"], P_hi["by"]
            cdt = jnp.float64
        else:
            residual_hi, free_hi = residual, free
            bx_hi, by_hi = bx, by
            cdt = dtype

        def make_precond(nuH, beta):
            """Inner-Krylov preconditioner from the current (frozen)
            coefficients: geometric multigrid V-cycle (default) or point
            Jacobi."""
            if self.precond_kind == "mg":
                from ..ops import mg
                return mg.make_preconditioner(nuH, beta, bc_mask, dx, dy, sh)
            if self.precond_kind == "linemg":
                from ..ops import mg
                return mg.make_preconditioner(nuH, beta, bc_mask, dx, dy, sh,
                                              smoother="line", pre=1, post=1,
                                              coarse_sweeps=4)
            if self.precond_kind == "line":
                return ssa_ops.make_line_preconditioner(
                    nuH, beta, bc_mask, dx, dy, sh,
                    pcr_dtype=self.line_pcr_dtype,
                    line_block=self.line_block)
            diag_u, diag_v = ssa_ops.operator_diagonal(nuH, beta, dx, dy, sh)
            diag_u = jnp.where(bc_mask, 1.0, jnp.maximum(diag_u, 1e-12))
            diag_v = jnp.where(bc_mask, 1.0, jnp.maximum(diag_v, 1e-12))
            return lambda r: (r[0] / diag_u, r[1] / diag_v)

        def lo(x):   # outer iterate -> f32 working precision
            return (x[0].astype(dtype), x[1].astype(dtype))

        def hi(x):   # f32 -> outer (carry) precision
            return (x[0].astype(cdt), x[1].astype(cdt))

        def dot(a, b_):
            if ddt is not None:
                return jnp.sum(a[0].astype(ddt) * b_[0].astype(ddt)) \
                    + jnp.sum(a[1].astype(ddt) * b_[1].astype(ddt))
            return jnp.sum(a[0] * b_[0]) + jnp.sum(a[1] * b_[1])

        u_init = u0 if u0 is not None else (
            state.u_ssa if state.u_ssa is not None else jnp.zeros_like(H))
        v_init = v0 if v0 is not None else (
            state.v_ssa if state.v_ssa is not None else jnp.zeros_like(H))
        uv = free((u_init, v_init))

        b_norm2 = dot(free_hi((bx_hi, by_hi)), free_hi((bx_hi, by_hi)))
        # pure f32 cannot resolve residuals much below ~1e-5 relative;
        # mixed reaches ~1e-6 but only through the f64 polish sweeps below —
        # the f32 Krylov DIRECTIONS have a ~3e-5 noise floor, so when the
        # run stops on velocity change (production; polish disabled) a
        # tighter target is unreachable and the Newton loop would always
        # run to stagnation, burning ksp_max-iteration breakdown sweeps
        # (measured: 600 of 1109 Krylov iterations wasted per 5 km solve)
        chg_rtol_cfg = self.config.get_number(
            "stress_balance.ssa.fd.velocity_change_rtol")
        # production (velocity-change stop on): target 1e-4 relative — the
        # trajectory noise this adds sits below the model's own chaotic
        # front-flicker floor (25 a at 5 km: volume differs by 2e-4
        # relative vs a 3e-5-target solve, mean |dH| 2.3 m, all pointwise
        # differences at flickering margin cells — the same magnitude the
        # f32-vs-f64 comparison produces), and it is tighter than the
        # reference's converged Picard states (ssafd_picard_rtol = 1e-4 on
        # nuH change)
        if dtype == jnp.float64:
            rtol = self.newton_rtol
        elif mixed:
            rtol = max(self.newton_rtol,
                       self.mixed_production_rtol if chg_rtol_cfg > 0.0
                       else 1.0e-6)
        else:
            # pure f32 carry: production target 3e-4 when the velocity-
            # change stop governs. The f32 residual floor is state-
            # dependent (~1-2e-4 relative on hard margin-flicker states),
            # so a 1e-4 target makes the endgame grind noise: traced at
            # 5 km, sweeps 12-18 spent ~100 Krylov iterations (60% of the
            # solve) pushing |F| from 5.7e-4 to 1.25e-4 with junk
            # directions re-perturbing the iterate so the velocity-change
            # stop could not fire. 3e-4 exits before the floor: solve
            # 44 -> 23 ms, 25-a trajectory differs by 2.2e-4 relative
            # volume = the front-flicker noise floor (docs/VALIDATION.md).
            # Convergence semantics are carried by the hard velocity-
            # change stop (the reference's ssafd_picard_rtol analog).
            rtol = max(self.newton_rtol,
                       self.f32_production_rtol if chg_rtol_cfg > 0.0
                       else 3.0e-5)
        newton_tol2 = jnp.maximum(
            rtol ** 2 * b_norm2,
            jnp.asarray(1e-300, cdt if mixed else dtype))
        # The near-tolerance heuristics below (Krylov cap, newton_or_keep
        # replacing the Picard safeguard) compensate for the f32 residual
        # noise floor; they only apply on the pure-f32 production path.
        # Full-convergence solves (velocity-change stop off: verification,
        # inverse) and the float64 island / mixed carry have a well-posed
        # Newton system near tolerance and keep the full safeguard.
        noisy_floor = (chg_rtol_cfg > 0.0 and not mixed
                       and dtype != jnp.float64)

        # ---- Picard warmup with drag-regularization continuation --------
        # The regularized-plastic beta(u -> 0) ~ tau_c/u_reg is so stiff that
        # Picard from a cold start crawls (u grows by a modest factor per
        # sweep). Continuation fixes the scale immediately: the first sweep
        # uses nearly-linear drag (u_reg ~ 1000 m/a), each following sweep
        # tightens u_reg geometrically down to the configured value.
        reg0 = 1000.0 / 3.15569259747e7   # m/s
        reg_final = self.sliding_law.plastic_reg
        nwarm = max(self.picard_warmup, 1)
        decay = (reg_final / reg0) ** (1.0 / nwarm)

        def picard_iter(i, uv, reg=None, rtol=None, max_iter=None):
            u, v = full(uv)
            nuH = make_nuH(u, v)
            if reg is None:
                reg = reg0 * decay ** (i + 1.0)
                reg = jnp.maximum(reg, reg_final)
            beta = beta_fn(u, v, reg=reg)

            def matvec(x):
                xu, xv = free(x)
                Au, Av = apply_op(xu, xv, nuH, beta)
                out = free((Au, Av))
                return (out[0] + jnp.where(bc_mask, x[0], 0.0),
                        out[1] + jnp.where(bc_mask, x[1], 0.0))

            # RHS correction for nonzero Dirichlet neighbors
            Aub, Avb = apply_op(jnp.where(bc_mask, bc_u, 0.0),
                                jnp.where(bc_mask, bc_v, 0.0),
                                nuH, beta)
            rhs = free((bx - Aub, by - Avb))
            # fixed-point sweeps do not need tight inner solves: the sweep
            # error is dominated by the frozen-coefficient linearization
            sol, _, _ = self._krylov(
                matvec, rhs, free(uv), make_precond(nuH, beta),
                rtol=self.warmup_ksp_rtol if rtol is None else rtol,
                max_iter=self.ksp_max if max_iter is None else max_iter,
                dot_dtype=ddt)
            return free(sol)

        # adaptive warmup: within the time-stepping loop the previous
        # velocity is an excellent initial guess, and additional continuation
        # sweeps (each a full Krylov solve) change it by well under a
        # percent — stop the warmup once a sweep moves the velocity by less
        # than 3% relative. Cold starts keep the full continuation schedule
        # (their early sweeps change the iterate by orders of magnitude).
        def warm_cond(carry):
            i, _, chg2 = carry
            return (i < self.picard_warmup) & (chg2 > 0.03 ** 2)

        def warm_body(carry):
            i, uv, _ = carry
            uv_new = picard_iter(i, uv)
            d_ = (uv_new[0] - uv[0], uv_new[1] - uv[1])
            chg2 = dot(d_, d_) / jnp.maximum(dot(uv_new, uv_new), 1e-300)
            return i + 1, uv_new, chg2

        # warm-start detection: the continuation's first sweeps solve a
        # DIFFERENT (nearly-linear-drag) problem, so starting them from a
        # converged previous-step velocity MOVES the iterate away from the
        # solution (measured at 5 km: the initial relative residual jumps
        # from well inside Newton's basin to |F|~5|b| and Newton spends
        # ~12 extra sweeps recovering). Skip the warmup entirely whenever
        # the initial true residual is already below warmup_skip_rtol*|b|;
        # a zero cold start sits exactly at |F| = |b| (beta(0)*0 = 0,
        # membrane(0) = 0), so cold starts keep the full continuation.
        F0_pre = residual_hi(free_hi(hi(uv)))
        F20_pre = dot(F0_pre, F0_pre)
        skip_warmup = F20_pre < jnp.asarray(self.warmup_skip_rtol ** 2,
                                            F20_pre.dtype) * b_norm2

        def _run_warmup(uv0):
            _, uvw, _ = jax.lax.while_loop(
                warm_cond, warm_body,
                (jnp.asarray(0), uv0,
                 jnp.asarray(jnp.inf, jnp.float64 if ddt else dtype)))
            return uvw

        uv = jax.lax.cond(skip_warmup, lambda x: x, _run_warmup, uv)
        uv = free_hi(hi(uv))   # promote the iterate to the carry precision

        # ---- safeguarded Newton-Picard ----------------------------------
        # Each iteration evaluates Newton line-search candidates AND a
        # Picard step and takes whichever decreases |F|^2 most. Newton
        # supplies the fast local convergence; Picard (which reliably
        # decreases the residual for this problem, as in the reference)
        # guarantees global progress when the Newton direction overshoots
        # through the near-singular viscosity/drag nonlinearities.
        alphas = jnp.asarray([1.0, 0.5, 0.25, 0.0625, 0.01], dtype)

        def newton_body(carry):
            uv, F, F2, _chg2, F2prev_c, eta_c, it, ktot, hist = carry
            uv32 = lo(uv)
            u, v = full(uv32)
            nuH = make_nuH(u, v)
            beta = beta_fn(u, v)
            precond = make_precond(nuH, beta)

            # linearize once per sweep: the primal residual evaluation is
            # hoisted out of the Krylov loop (jax.jvp would recompute it
            # at every inner iteration — measured ~2x on the solve)
            _, jvp_lin = jax.linearize(residual, uv32)

            def jmv(d):
                Jd = jvp_lin(free(d))
                return (Jd[0] + jnp.where(bc_mask, d[0], 0.0),
                        Jd[1] + jnp.where(bc_mask, d[1], 0.0))

            # Eisenstat-Walker (choice 2) forcing: solve the Newton system
            # only as accurately as the outer convergence rate warrants —
            # eta_k = gamma (|F_k|/|F_{k-1}|)^alpha, clamped to
            # [ksp_rtol, ksp_rtol_max]. Far from the solution (and on the
            # first sweep, F2prev = inf -> eta_max) a loose direction is as
            # good as an exact one at a fraction of the Krylov work. When
            # the last sweep stagnated, the loose direction is the prime
            # suspect: tighten 30x instead (the loop only gives up on
            # stagnation once eta has reached the ksp_rtol floor).
            ratio2 = F2 / jnp.where(jnp.isfinite(F2prev_c), F2prev_c, F2)
            eta = 0.9 * ratio2 ** 0.809   # (F/Fprev)^1.618 via squared norms
            eta = jnp.where(jnp.isfinite(F2prev_c), eta, self.ksp_rtol_max)
            progressed = F2 < stag * F2prev_c
            eta = jnp.where(progressed, eta, eta_c / 30.0)
            eta = jnp.clip(eta, self.ksp_rtol, self.ksp_rtol_max)
            if self.eta_endgame_range > 0.0:
                # endgame tightening: the per-sweep FIXED cost (linearize,
                # high-precision residual, preconditioner build) dominates
                # the per-Krylov-iteration cost, so once the target is
                # within reach (|F| <= range * tol) solve the Newton system
                # tight enough to land at ~tol/2 in one step instead of
                # contracting by eta_max per sweep for many more sweeps
                eta_finish = 0.5 * jnp.sqrt(
                    newton_tol2 / jnp.maximum(F2, 1e-300))
                near = F2 < self.eta_endgame_range ** 2 * newton_tol2
                eta = jnp.where(
                    near,
                    jnp.clip(eta_finish, self.ksp_rtol, self.ksp_rtol_max),
                    eta)

            negF = lo((-F[0], -F[1]))
            zero = (jnp.zeros_like(negF[0]), jnp.zeros_like(negF[1]))
            # near-tolerance Krylov cap: at the working-precision noise
            # floor the Newton system is noise and BiCGStab grinds to
            # ksp_max without converging (traced at 5 km: one
            # 300-iteration sweep = 72% of the warm solve's Krylov work,
            # zero residual change); a productive direction this close to
            # tolerance needs only a handful of iterations
            if noisy_floor:
                # |F| within 32x of target: the f32 floor region in
                # practice (round-5 production trace: a sweep at
                # F2 = 31 x tol2 fell OUTSIDE the previous 16x window and
                # ground 300 iterations with zero progress = 96% of that
                # solve's Krylov work); with Eisenstat forcing the needed
                # inner accuracy there is >= 0.5/32, reachable within the
                # cap
                kmax = jnp.where(F2 < 1024.0 * newton_tol2,
                                 min(self.near_ksp_cap, self.ksp_max),
                                 self.ksp_max)
            else:
                kmax = self.ksp_max
            d, kit, _ = self._krylov(
                jmv, negF, zero, precond,
                rtol=eta, max_iter=kmax, dot_dtype=ddt)
            d = hi(free(d))

            # line search: the candidate COMPARISON runs in working (f32)
            # precision — picking the best alpha only needs norms that
            # differ by factors, far above the f32 noise floor — and only
            # the chosen candidate gets the one high-precision residual
            # evaluation per sweep (in mixed mode the f64 stencil applies
            # move twice the bytes of the f32 ones)
            d32 = lo(d)

            def trial_norm(alpha):
                cand = (uv32[0] + alpha * d32[0], uv32[1] + alpha * d32[1])
                Fc = residual(cand)
                return dot(Fc, Fc)

            # full step first; backtracking candidates are only evaluated
            # (lax.cond) when alpha=1 fails sufficient decrease — in the
            # common warm-started regime this saves 4 residual evaluations
            # per sweep. The backtracking candidates are unrolled, one
            # residual evaluation each.
            n1 = trial_norm(alphas[0])

            def full_step(_):
                return alphas[0]

            def backtrack(_):
                norms = jnp.stack([n1] + [trial_norm(alphas[i])
                                          for i in range(1, alphas.shape[0])])
                return alphas[jnp.argmin(norms)]

            ak = jax.lax.cond(n1 < 0.5 * F2, full_step, backtrack,
                              None).astype(cdt)
            newton_uv = (uv[0] + ak * d[0], uv[1] + ak * d[1])
            F_newton = residual_hi(newton_uv)
            newton_F2 = dot(F_newton, F_newton)

            # Newton only when it both improves on the current iterate and
            # beats the Picard candidate; otherwise take the Picard step
            # unconditionally (a fixed-point sweep need not decrease |F|
            # monotonically, but it is what converges globally — as in the
            # reference, whose solver is pure Picard). The Picard candidate
            # costs a second Krylov solve, so it is only evaluated (lax.cond
            # runs one branch) when the Newton step failed sufficient
            # decrease — in the usual regime where Newton converges this
            # halves the per-sweep cost.
            def newton_only(_):
                return newton_uv, F_newton, newton_F2

            def with_picard(_):
                # safeguard sweeps solve a frozen-coefficient system to the
                # loose warmup tolerance; if the line-preconditioned
                # BiCGStab cannot get there in 48 iterations the system is
                # ill-posed noise and more iterations only burn wall time.
                # The bound is a static Python int: the traced
                # jnp.minimum(48, kmax) form shipped in round 3 crashed the
                # device runtime on 5/10 km multi-step segments (bisected).
                picard_uv = free_hi(hi(picard_iter(
                    0, uv32, reg=reg_final,
                    max_iter=(min(self.safeguard_ksp_cap, self.ksp_max)
                              if noisy_floor else self.ksp_max))))
                picard_F = residual_hi(picard_uv)
                picard_F2 = dot(picard_F, picard_F)
                take_newton = (newton_F2 < picard_F2) & (newton_F2 < F2)
                # fixed-point sweeps need not decrease |F| monotonically,
                # but a sweep built on a broken-down inner solve can blow
                # the iterate up to the speed cap and poison the
                # trajectory: allow moderate increases only
                picard_ok = picard_F2 < 1e2 * F2
                cand_u = jnp.where(picard_ok, picard_uv[0], uv[0])
                cand_v = jnp.where(picard_ok, picard_uv[1], uv[1])
                cand_F = (jnp.where(picard_ok, picard_F[0], F[0]),
                          jnp.where(picard_ok, picard_F[1], F[1]))
                cand_F2 = jnp.where(picard_ok, picard_F2, F2)
                cand = (jnp.where(take_newton, newton_uv[0], cand_u),
                        jnp.where(take_newton, newton_uv[1], cand_v))
                Fc = (jnp.where(take_newton, F_newton[0], cand_F[0]),
                      jnp.where(take_newton, F_newton[1], cand_F[1]))
                return cand, Fc, jnp.where(take_newton, newton_F2, cand_F2)

            # near tolerance the Picard safeguard only injects noise: a
            # rejected Newton step there means the residual is at the
            # precision floor, and a Picard sweep moves flickering margin
            # cells by whole percents (traced: the velocity-change stop
            # never fires because each safeguard sweep re-perturbs the
            # iterate). Accept any improving Newton step instead, or keep
            # the iterate unchanged - which cleanly triggers the
            # stagnation/velocity-change stop on the next test.
            def newton_or_keep(_):
                take = newton_F2 < F2
                cand = (jnp.where(take, newton_uv[0], uv[0]),
                        jnp.where(take, newton_uv[1], uv[1]))
                Fc = (jnp.where(take, F_newton[0], F[0]),
                      jnp.where(take, F_newton[1], F[1]))
                return cand, Fc, jnp.where(take, newton_F2, F2)

            sufficient = newton_F2 < 0.5 * F2
            if noisy_floor:
                near = F2 < 16.0 * newton_tol2
                fallback = lambda _: jax.lax.cond(
                    near, newton_or_keep, with_picard, None)
            else:
                fallback = with_picard
            uv_new, F_new, F2_new = jax.lax.cond(
                sufficient, newton_only, fallback, None)
            # stagnation measure: relative velocity change of this sweep
            dchg = (uv_new[0] - uv[0], uv_new[1] - uv[1])
            chg2 = dot(dchg, dchg) / jnp.maximum(dot(uv_new, uv_new), 1e-300)
            # per-sweep trace (diagnostics; the PISM Picard-log analog)
            hist = jax.tree_util.tree_map(lambda h, x: h.at[it].set(x), hist,
                                          (F2_new / jnp.maximum(b_norm2, 1e-300),
                                           chg2, eta,
                                           kit.astype(hist[3].dtype),
                                           ak.astype(hist[4].dtype),
                                           sufficient.astype(hist[5].dtype)))
            return (uv_new, F_new, F2_new, chg2, F2, eta, it + 1, ktot + kit,
                    hist)

        if dtype == jnp.float64:
            chg_tol = 1e-8
        elif mixed:
            chg_tol = 1e-6   # f64 iterate: stagnation resolvable below f32
        else:
            chg_tol = 1e-4
        # configurable velocity-change stop (reference: Picard stops at
        # ssafd_picard_rtol = 1e-4 relative change in nuH; polishing far
        # below that buys nothing for the time-stepping trajectory but
        # costs Newton sweeps of ~100 Krylov iterations each)
        if chg_rtol_cfg > 0.0:
            chg_tol = max(chg_tol, chg_rtol_cfg)
        chg_tol2 = jnp.asarray(chg_tol ** 2,
                               jnp.float64 if ddt is not None else dtype)

        # residual-stagnation stop: slow (few-%/sweep) Picard convergence is
        # legitimate, so only stop when the residual is essentially flat.
        # In mixed precision the f32 stencil noise floor sits above any
        # fixed F tolerance, so the effective stop is velocity stagnation
        # (chg_tol below, loosened to 1e-4 relative per sweep).
        stag = 0.999

        def newton_cond(carry):
            _, _, F2, chg2, F2prev, eta_c, it, _ktot, _hist = carry
            improving = (F2 < stag * F2prev) & (chg2 > chg_tol2)
            # a stagnated sweep that used a loose inner tolerance gets
            # retried with a tighter one before the loop gives up — but
            # only while the residual is far (>100x) above tolerance;
            # near-tolerance stagnation is the precision noise floor and
            # tightening the inner solve cannot fix it
            retry = (eta_c > self.ksp_rtol * 1.01) & (F2 > 1e4 * newton_tol2)
            if chg_rtol_cfg > 0.0:
                # configured velocity-change stop is HARD (the reference's
                # ssafd_picard_rtol semantics): once a sweep moves the
                # velocity less than this, further polishing (including
                # tighten-and-retry) buys nothing for the trajectory
                retry = retry & (chg2 > chg_tol2)
            return (F2 > newton_tol2) & (improving | retry) \
                & (it < self.newton_max)

        F0, F20 = jax.lax.cond(
            skip_warmup,
            lambda _: (F0_pre, F20_pre),
            lambda _: (lambda F: (F, dot(F, F)))(residual_hi(uv)),
            None)
        hdt = F20.dtype
        hist0 = (jnp.full((self.newton_max,), jnp.nan, hdt),  # F2/b2
                 jnp.full((self.newton_max,), jnp.nan, hdt),  # chg2
                 jnp.full((self.newton_max,), jnp.nan, hdt),  # eta
                 jnp.zeros((self.newton_max,), jnp.int32),    # krylov its
                 jnp.full((self.newton_max,), jnp.nan, dtype),  # alpha
                 jnp.zeros((self.newton_max,), jnp.int32))    # newton taken
        uv, F, F2, chg2, F2prev, eta_f, iters, ktot, hist = jax.lax.while_loop(
            newton_cond, newton_body,
            (uv, F0, F20, jnp.ones((), F20.dtype),
             jnp.full((), jnp.inf, F20.dtype),
             jnp.asarray(self.ksp_rtol_max, F20.dtype), jnp.asarray(0),
             jnp.asarray(0), hist0))

        if mixed and chg_rtol_cfg == 0.0:
            # Only when full Newton-tolerance convergence was requested
            # (velocity-change stop off; production runs stop on velocity
            # change and must not pay for this): the f32 Krylov directions
            # have a cancellation noise floor, and under extreme nuH
            # contrast the Newton loop can stagnate a few percent ABOVE the
            # requested tolerance. Polish with full-f64 Newton sweeps
            # (compiled but executed only when needed) so ``mixed`` reaches
            # the float64-island tolerance.
            make_nuH_hi, beta_fn_hi = P_hi["make_nuH"], P_hi["beta_fn"]
            full_hi = P_hi["full"]

            def polish_body(carry):
                uv_, F_, F2_, it_ = carry
                u_, v_ = full_hi(uv_)
                nuH64 = make_nuH_hi(u_, v_)
                beta64 = beta_fn_hi(u_, v_)
                du64, dv64 = ssa_ops.operator_diagonal(nuH64, beta64, dx, dy,
                                                       sh)
                du64 = jnp.where(bc_mask, 1.0, jnp.maximum(du64, 1e-12))
                dv64 = jnp.where(bc_mask, 1.0, jnp.maximum(dv64, 1e-12))
                _, jvp64 = jax.linearize(residual_hi, uv_)

                def jmv64(d):
                    Jd = jvp64(free_hi(d))
                    return (Jd[0] + jnp.where(bc_mask, d[0], 0.0),
                            Jd[1] + jnp.where(bc_mask, d[1], 0.0))

                negF = (-F_[0], -F_[1])
                zero = (jnp.zeros_like(negF[0]), jnp.zeros_like(negF[1]))
                d, _, _ = self._krylov(
                    jmv64, negF, zero,
                    lambda r: (r[0] / du64, r[1] / dv64),
                    rtol=1e-4, max_iter=self.ksp_max)
                d = free_hi(d)

                def trial(alpha):
                    cand = (uv_[0] + alpha * d[0], uv_[1] + alpha * d[1])
                    Fc = residual_hi(cand)
                    return dot(Fc, Fc)

                norms = jax.vmap(trial)(alphas.astype(jnp.float64))
                k = jnp.argmin(norms)
                ak = alphas[k].astype(jnp.float64)
                take = norms[k] < F2_
                uv_n = (jnp.where(take, uv_[0] + ak * d[0], uv_[0]),
                        jnp.where(take, uv_[1] + ak * d[1], uv_[1]))
                return (uv_n, residual_hi(uv_n),
                        jnp.where(take, norms[k], F2_), it_ + 1)

            def polish_cond(carry):
                _, _, F2_, it_ = carry
                return (F2_ > newton_tol2) & (it_ < 4)

            uv, F, F2, _ = jax.lax.while_loop(
                polish_cond, polish_body, (uv, F, F2, jnp.asarray(0)))

        u, v = full(lo(uv))
        u = jnp.clip(u, -self.max_speed, self.max_speed)
        v = jnp.clip(v, -self.max_speed, self.max_speed)
        if diagnostics:
            info = {"newton_iters": iters, "F2_initial": F20, "F2_final": F2,
                    "F2_warmstart": F20_pre, "warmup_skipped": skip_warmup,
                    "b_norm2": b_norm2, "tol2": newton_tol2,
                    "krylov_iters": ktot,
                    "trace": {"F2_rel": hist[0], "chg2": hist[1],
                              "eta": hist[2], "krylov": hist[3],
                              "alpha": hist[4], "newton_taken": hist[5]}}
            return u, v, info
        return u, v
