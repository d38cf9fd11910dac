"""Composite stress balance.

Rebuild of PISM ``src/stressbalance/StressBalance.cc``: combines a 2D
membrane ("shallow") stress balance (SSA; or none) with the SIA shear
modifier, producing the staggered diffusive flux, the vertically-averaged
advective (sliding) velocity, the adaptive-dt inputs, and (when the energy
model needs them) the 3D velocities and volumetric strain heating.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..ops import sia as sia_ops
from ..ops import sia3d
from ..ops.stencils import Shifter
from ..ops import stencils as st
from .. import state as S
from . import geometry_evolution as ge


class StressBalanceResult(NamedTuple):
    # staggered diffusive (SIA) flux [m^2/s]
    qe: jnp.ndarray
    qn: jnp.ndarray
    # face-normal advective (sliding) velocity [m/s]
    u_face_e: jnp.ndarray
    v_face_n: jnp.ndarray
    # cell-centered sliding velocity (diagnostics/calving/friction heating)
    u_base: jnp.ndarray
    v_base: jnp.ndarray
    max_diffusivity: jnp.ndarray
    # updated SSA velocity state (carried between steps as warm start)
    u_ssa: Optional[jnp.ndarray]
    v_ssa: Optional[jnp.ndarray]
    # 3D outputs for the energy/age models (None unless requested)
    sia3: Optional[sia3d.SIA3D]
    basal_frictional_heating: Optional[jnp.ndarray]


@dataclass
class StressBalance:
    """Configured stress balance; ``update`` is pure and trace-safe."""

    grid: object
    config: object
    sia_flow_law: object = None
    ssa: object = None           # SSA solver object (model/ssa), or None
    blatter: object = None       # BlatterSolver (model = "blatter")
    model: str = "sia"           # none | sia | ssa | ssa+sia | blatter |
    #                              weertman_sliding[+sia] | prescribed_sliding[+sia]
    compute_3d: bool = False
    # prescribed sliding fields (model = "prescribed_sliding[+sia]")
    prescribed_u: object = None
    prescribed_v: object = None
    # regional mode (reference SIAFD_Regional::compute_surface_gradient):
    # faces touching the no-model strip see the gradient of the *stored*
    # surface (usurfstore) — or zero with regional.zero_gradient — so the
    # strip is a stationary Dirichlet frame that still exchanges flux
    no_model_mask: object = None
    stored_surface: object = None   # usurfstore (set by IceModel)
    # spatially-varying linear sliding coefficient mu(x,y) [m s^-1 Pa^-1]
    # for the Weertman path: u_b = -mu tau_d (EISMINT II experiment E's
    # sector-limited sliding patch; reference IceEISModel sliding map)
    sliding_mu: object = None

    def __post_init__(self):
        self.sh = Shifter(self.grid)
        self.has_sia = "sia" in self.model.split("+")
        cfg = self.config
        self.n_sia = cfg.get_number("stress_balance.sia.Glen_exponent")
        self.e_sia = cfg.get_number("stress_balance.sia.enhancement_factor")
        self.rho = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.gradient_method = cfg.get_string("stress_balance.sia.surface_gradient_method")
        self.theta_min = cfg.get_number(
            "stress_balance.sia.bed_smoother.theta_min")
        self.w_approx = cfg.get_string(
            "stress_balance.vertical_velocity_approximation")
        # reference stress_balance.ice_free_thickness_standard: thickness
        # below which cells do not restrict the 3D advection CFL
        self.icy_thresh = cfg.get_number(
            "stress_balance.ice_free_thickness_standard")
        # PIK experimental speed-up (reference -brutal_sliding): scale the
        # SSA sliding speeds by a constant factor
        self.brutal_scale = cfg.get_number(
            "stress_balance.ssa.fd.brutal_sliding_scale") \
            if cfg.get_flag("stress_balance.ssa.fd.brutal_sliding") else None
        if self.w_approx not in ("centered", "upstream"):
            raise ValueError(
                "stress_balance.vertical_velocity_approximation = "
                f"{self.w_approx!r}: expected centered | upstream")
        self.bed_smoother_range = cfg.get_number(
            "stress_balance.sia.bed_smoother.range")
        self.regional_zero_gradient = cfg.get_flag("regional.zero_gradient")
        # PISM limit_diffusivity: cap the SIA diffusivity (and the 3D shear
        # velocities' column flux) at max_diffusivity instead of letting
        # margin cliffs collapse the adaptive dt
        self.d_limit = (cfg.get_number("stress_balance.sia.max_diffusivity")
                        if cfg.get_flag("stress_balance.sia.limit_diffusivity")
                        else None)
        # age-coupled interglacial enhancement (reference
        # stress_balance.sia.e_age_coupling; EDC/EemianGreenland runs):
        # ice deposited during the Eemian or after the Holocene onset
        # flows with enhancement_factor_interglacial instead of e_sia
        self.e_age_coupling = cfg.get_flag("stress_balance.sia.e_age_coupling")
        if self.e_age_coupling and not cfg.get_flag("age.enabled"):
            # the reference errors when the age model is missing; a silent
            # fall-back to the scalar e_sia would be wrong physics
            raise ValueError(
                "stress_balance.sia.e_age_coupling requires age.enabled")
        self.e_sia_interglacial = cfg.get_number(
            "stress_balance.sia.enhancement_factor_interglacial")
        self.eemian_start = cfg.get_number("time.eemian_start", "seconds")
        self.eemian_end = cfg.get_number("time.eemian_end", "seconds")
        self.holocene_start = cfg.get_number("time.holocene_start", "seconds")


    def _weertman(self, state: S.ModelState):
        """Weertman (1957)-type hard-bed sliding (PISM ``WeertmanSliding``):
        u_b = -k |tau_d|^(m-1) tau_d / N^(m-1), with N = rho g H the
        overburden effective pressure. [coefficient form re-derived; the
        reference mount was empty at survey time]

        With m = 1 and k = B this is the EISMINT II experiment G linear
        sliding law u_b = -B tau_b (Payne et al. 2000 eq. 4,
        B = 1e-3 m a^-1 Pa^-1); ``melt_only`` restricts sliding to
        temperate-based cells (experiment H)."""
        cfg = self.config
        k = cfg.get_number("stress_balance.weertman_sliding.k")
        m = cfg.get_number("stress_balance.weertman_sliding.exponent")
        melt_only = cfg.get_flag("stress_balance.weertman_sliding.melt_only")
        g = state.geometry
        sx, sy = st.centered_grad(g.ice_surface_elevation, self.grid.dx,
                                  self.grid.dy, self.sh)
        N = jnp.maximum(self.rho * self.g * g.ice_thickness, 1.0)
        tdx = -self.rho * self.g * g.ice_thickness * sx
        tdy = -self.rho * self.g * g.ice_thickness * sy
        mag = jnp.sqrt(tdx ** 2 + tdy ** 2)
        if self.sliding_mu is not None:
            # prescribed per-cell linear coefficient: u_b = -mu tau_d
            # (EISMINT II experiment E sliding patch)
            fac = jnp.asarray(self.sliding_mu, g.ice_thickness.dtype)
        else:
            fac = k * (mag / N) ** (m - 1.0)
        sliding = S.grounded_ice(g.cell_type)
        if melt_only and state.enthalpy is not None:
            EC = self.sia_flow_law.EC
            p_base = EC.pressure(g.ice_thickness)
            E_base = state.enthalpy[..., 0]
            temperate = E_base >= EC.enthalpy_cts(p_base)
            sliding = sliding & temperate
        u = jnp.where(sliding, fac * tdx, 0.0)
        v = jnp.where(sliding, fac * tdy, 0.0)
        return u, v

    def _apply_bed_smoother(self, geometry):
        """Schoof (2003) roughness parameterization (PISM ``BedSmoother``,
        applied from ``SIAFD::update``): grounded SIA columns see the
        thickness relative to the *smoothed* bed, and the diffusivity is
        scaled by the theta factor on the faces. Floating/ice-free cells
        are untouched. Returns (geometry_for_sia, theta_e, theta_n)."""
        from dataclasses import replace
        from ..ops import bedsmoother as bsm

        if self.bed_smoother_range <= 0.0:
            return geometry, None, None
        grid = self.grid
        smooth = bsm.preprocess_bed(geometry.bed_elevation, grid.dx, grid.dy,
                                    self.bed_smoother_range)
        grounded = S.grounded_ice(geometry.cell_type)
        H_rel = jnp.maximum(geometry.ice_surface_elevation - smooth.bed, 0.0)
        H_sia = jnp.where(grounded, H_rel, geometry.ice_thickness)
        th = jnp.where(grounded, bsm.theta(smooth, H_rel, self.n_sia), 1.0)
        # reference stress_balance.sia.bed_smoother.theta_min: floor on the
        # roughness multiplier (theta -> 0 shuts the flux off entirely)
        th = jnp.maximum(th, self.theta_min)
        th = th.astype(geometry.ice_thickness.dtype)
        geom = replace(geometry, ice_thickness=H_sia)
        return (geom, st.avg_to_east(th, self.sh),
                st.avg_to_north(th, self.sh))

    def _blatter_update(self, state: S.ModelState, yield_stress):
        """Blatter 3D first-order balance as the full stress balance
        (reference ``-stress_balance blatter``: Blatter + BlatterMod).
        The 3D solve supplies everything: vertically-averaged velocity
        drives mass transport (all-advective, no SIA diffusive flux), the
        z-regridded 3D field + incompressibility w + dissipation feed the
        energy/age models."""
        grid, sh = self.grid, self.sh
        geom = state.geometry
        H = geom.ice_thickness
        dtype = H.dtype
        # warm start: previous vertical mean, broadcast over depth
        u0 = v0 = None
        if state.u_ssa is not None:
            Mz = grid.Mz
            u0 = jnp.broadcast_to(state.u_ssa[..., None], H.shape + (Mz,))
            v0 = jnp.broadcast_to(state.v_ssa[..., None], H.shape + (Mz,))
        u3z_, v3z_, Phi_z_, _ = self.blatter.solve(
            state, yield_stress, u0=u0, v0=v0, full_output=True)
        ubar = self.blatter.vertical_average(u3z_).astype(dtype)
        vbar = self.blatter.vertical_average(v3z_).astype(dtype)
        u_b = u3z_[..., 0].astype(dtype)
        v_b = v3z_[..., 0].astype(dtype)

        sia3 = None
        friction = None
        if self.compute_3d:
            u3 = self.blatter.regrid_to_z(u3z_, H).astype(dtype)
            v3 = self.blatter.regrid_to_z(v3z_, H).astype(dtype)
            Phi = self.blatter.regrid_to_z(Phi_z_, H).astype(dtype)
            z = jnp.asarray(grid.z, dtype)
            u_x = (sh(u3, 0, 1) - sh(u3, 0, -1)) / (2.0 * grid.dx)
            v_y = (sh(v3, 1, 0) - sh(v3, -1, 0)) / (2.0 * grid.dy)
            b_x, b_y = st.centered_grad(geom.bed_elevation, grid.dx,
                                        grid.dy, sh)
            w_base = u_b * b_x + v_b * b_y
            if state.basal_melt_rate is not None:
                w_base = w_base - state.basal_melt_rate
            w = w_base[..., None] - sia3d._cumtrapz_z(u_x + v_y, z)
            in_ice = (z <= H[..., None]) | (jnp.arange(z.shape[0]) == 0)
            w = jnp.where(in_ice, w, 0.0).astype(dtype)
            sia3 = sia3d.SIA3D(u=u3, v=v3, w=w, strain_heating=Phi,
                               max_u=jnp.max(jnp.abs(u3)),
                               max_v=jnp.max(jnp.abs(v3)))
            if yield_stress is not None:
                beta = self.blatter.sliding_law.beta(yield_stress, u_b, v_b)
                friction = jnp.where(S.grounded_ice(geom.cell_type),
                                     beta * (u_b ** 2 + v_b ** 2), 0.0)

        u_e, v_n = ge.face_velocities(ubar, vbar, sh)
        zeros = jnp.zeros(grid.shape2, dtype)
        return StressBalanceResult(
            qe=zeros, qn=zeros, u_face_e=u_e, v_face_n=v_n,
            u_base=u_b, v_base=v_b, max_diffusivity=jnp.zeros(()),
            u_ssa=ubar, v_ssa=vbar, sia3=sia3,
            basal_frictional_heating=friction)

    def update(self, state: S.ModelState, yield_stress=None,
               water_column_pressure=None, t=None) -> StressBalanceResult:
        grid, sh = self.grid, self.sh
        zeros = jnp.zeros(grid.shape2, state.geometry.ice_thickness.dtype)

        if self.model == "blatter" and self.blatter is not None:
            return self._blatter_update(state, yield_stress)

        u_ssa, v_ssa = state.u_ssa, state.v_ssa
        if self.model in ("ssa", "ssa+sia") and self.ssa is not None:
            u_ssa, v_ssa = self.ssa.solve(
                state, yield_stress,
                water_column_pressure=water_column_pressure)
            if self.brutal_scale is not None:
                u_ssa = u_ssa * self.brutal_scale
                v_ssa = v_ssa * self.brutal_scale
        elif self.model.startswith("weertman_sliding"):
            u_ssa, v_ssa = self._weertman(state)
        elif self.model.startswith("prescribed_sliding"):
            u_ssa = jnp.asarray(self.prescribed_u)
            v_ssa = jnp.asarray(self.prescribed_v)

        e_sia = self.e_sia
        if self.e_age_coupling and state.age is not None and t is not None:
            # depositional age of each parcel; interglacial ice is softer
            depo = t - state.age
            interglacial = (((depo >= self.eemian_start)
                             & (depo <= self.eemian_end))
                            | (depo >= self.holocene_start))
            e_sia = jnp.where(interglacial, self.e_sia_interglacial,
                              self.e_sia).astype(
                                  state.geometry.ice_thickness.dtype)

        if self.has_sia:
            geom, th_e, th_n = self._apply_bed_smoother(state.geometry)
            flux = sia_ops.diffusivity(
                self.sia_flow_law, geom, state.enthalpy, grid, sh,
                n=self.n_sia, enhancement=e_sia, rho=self.rho, g=self.g,
                gradient_method=self.gradient_method,
                theta_e=th_e, theta_n=th_n, d_limit=self.d_limit,
                no_model_mask=self.no_model_mask,
                stored_surface=self.stored_surface,
                regional_zero_gradient=self.regional_zero_gradient)
            qe, qn, max_D = flux.qe, flux.qn, flux.max_D
        else:
            qe, qn, max_D = zeros, zeros, jnp.zeros(())

        if u_ssa is not None:
            u_e, v_n = ge.face_velocities(u_ssa, v_ssa, sh)
            u_b, v_b = u_ssa, v_ssa
        else:
            u_e, v_n, u_b, v_b = zeros, zeros, zeros, zeros

        sia3 = None
        friction = None
        if self.compute_3d:
            if self.has_sia:
                sia3 = sia3d.sia_3d(
                    self.sia_flow_law, state.geometry, state.enthalpy, grid, sh,
                    n=self.n_sia, enhancement=e_sia, rho=self.rho, g=self.g,
                    u_base=u_b if u_ssa is not None else None,
                    v_base=v_b if u_ssa is not None else None,
                    basal_melt_rate=state.basal_melt_rate,
                    max_diffusivity=self.d_limit,
                    w_approximation=self.w_approx,
                    icy_threshold=self.icy_thresh)
            if u_ssa is not None and yield_stress is not None and self.ssa is not None:
                # tau_b . u_b = beta(|u|) |u|^2  [W/m^2]
                beta = self.ssa.sliding_law.beta(yield_stress, u_b, v_b)
                friction = beta * (u_b ** 2 + v_b ** 2)
                friction = jnp.where(S.grounded_ice(state.geometry.cell_type),
                                     friction, 0.0)

        return StressBalanceResult(
            qe=qe, qn=qn, u_face_e=u_e, v_face_n=v_n,
            u_base=u_b, v_base=v_b, max_diffusivity=max_D,
            u_ssa=u_ssa, v_ssa=v_ssa,
            sia3=sia3, basal_frictional_heating=friction,
        )
