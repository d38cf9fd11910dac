"""Shallow-ice approximation (SIA) diffusivity and flux.

Rebuild of PISM ``src/stressbalance/sia/SIAFD.cc``: staggered-grid surface
gradients (Mahaffy / eta-transform / Haseloff schemes), the flow-law vertical
integral giving the diffusivity D on cell faces, and the diffusive flux
q = -D grad(s). In the reference this is a per-cell C++ loop over ghosted
arrays; here it is a fused whole-array expression (the z-integral is a single
reduction over the contiguous trailing axis) that XLA fuses into a few loop
and reduction kernels; GSPMD supplies halos when the arrays are sharded.

D on a face: D = 2 e (rho g)^n |grad s|^(n-1) * K,
K = integral_0^H A(E(z), p(H - z)) (H - z)^(n+1) dz   (z above base),
reducing to Gamma H^(n+2) |grad s|^(n-1) / (n+2) * ... for isothermal A.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from . import stencils as st
from .stencils import Shifter


class StaggeredGrad(NamedTuple):
    """Surface gradient on east and north faces."""
    sx_e: jnp.ndarray  # ds/dx on east faces
    sy_e: jnp.ndarray  # ds/dy on east faces
    sx_n: jnp.ndarray
    sy_n: jnp.ndarray


class SIAFlux(NamedTuple):
    De: jnp.ndarray   # diffusivity on east faces [m^2/s]
    Dn: jnp.ndarray
    qe: jnp.ndarray   # diffusive flux (vertically integrated) [m^2/s]
    qn: jnp.ndarray
    max_D: jnp.ndarray  # scalar, for adaptive dt


def surface_gradient_mahaffy(surface, grid, sh: Shifter) -> StaggeredGrad:
    """Mahaffy (1976) scheme: one-sided across the face, 4-point average
    along it (PISM ``SIAFD::surface_gradient_mahaffy``)."""
    dx, dy = grid.dx, grid.dy
    return StaggeredGrad(
        sx_e=st.grad_x_east(surface, dx, sh),
        sy_e=st.grad_y_east(surface, dy, sh),
        sx_n=st.grad_x_north(surface, dx, sh),
        sy_n=st.grad_y_north(surface, dy, sh),
    )


def surface_gradient_eta(thickness, bed, grid, sh: Shifter, n: float = 3.0) -> StaggeredGrad:
    """Eta-transform scheme (PISM ``SIAFD::surface_gradient_eta``):
    eta = H^((2n+2)/n) is smooth at margins; grad H recovered via the chain
    rule, then grad s = grad H + grad b."""
    etapow = (2.0 * n + 2.0) / n
    eta = thickness ** etapow
    factor = 1.0 / etapow
    dx, dy = grid.dx, grid.dy

    def dH(eta_face_grad, eta_face):
        # dH = (1/etapow) * eta^(1/etapow - 1) * deta
        safe = jnp.maximum(eta_face, 1e-30)
        return factor * safe ** (1.0 / etapow - 1.0) * jnp.where(eta_face > 0, eta_face_grad, 0.0)

    eta_e = st.avg_to_east(eta, sh)
    eta_n = st.avg_to_north(eta, sh)

    sx_e = dH(st.grad_x_east(eta, dx, sh), eta_e) + st.grad_x_east(bed, dx, sh)
    sy_e = dH(st.grad_y_east(eta, dy, sh), eta_e) + st.grad_y_east(bed, dy, sh)
    sx_n = dH(st.grad_x_north(eta, dx, sh), eta_n) + st.grad_x_north(bed, dx, sh)
    sy_n = dH(st.grad_y_north(eta, dy, sh), eta_n) + st.grad_y_north(bed, dy, sh)
    return StaggeredGrad(sx_e, sy_e, sx_n, sy_n)


def surface_gradient_haseloff(geometry, grid, sh: Shifter) -> StaggeredGrad:
    """Mahaffy gradients with margin treatment (PISM
    ``SIAFD::surface_gradient_haseloff``, M. Haseloff's fix): at ice margins
    the raw surface difference toward an ice-free cell can point *uphill*
    onto bedrock (nunataks, fjord walls) or use meaningless ice-free surface
    values. Faces between an icy cell and an ice-free cell whose surface is
    higher get zero across-face gradient (no flow into a wall); the 4-point
    along-face averages ignore ice-free contributions by falling back to the
    icy side's one-sided difference."""
    from .. import state as S

    s = geometry.ice_surface_elevation
    icy = S.icy(geometry.cell_type)
    g = surface_gradient_mahaffy(s, grid, sh)
    dx, dy = grid.dx, grid.dy

    icy_e = sh(icy, 0, 1)
    icy_n = sh(icy, 1, 0)
    s_e = sh(s, 0, 1)
    s_n = sh(s, 1, 0)

    # across-face components: zero where the ice-free neighbor is higher
    # (ice cannot be pushed up onto ice-free ground), one-sided otherwise
    wall_e = (icy & ~icy_e & (s_e > s)) | (~icy & icy_e & (s > s_e))
    wall_n = (icy & ~icy_n & (s_n > s)) | (~icy & icy_n & (s > s_n))
    sx_e = jnp.where(wall_e, 0.0, g.sx_e)
    sy_n = jnp.where(wall_n, 0.0, g.sy_n)

    return StaggeredGrad(sx_e=sx_e, sy_e=g.sy_e, sx_n=g.sx_n, sy_n=sy_n)


def surface_gradient(geometry, grid, sh: Shifter, method: str = "mahaffy",
                     n: float = 3.0) -> StaggeredGrad:
    if method == "eta":
        return surface_gradient_eta(geometry.ice_thickness, geometry.bed_elevation,
                                    grid, sh, n)
    if method == "haseloff":
        return surface_gradient_haseloff(geometry, grid, sh)
    return surface_gradient_mahaffy(geometry.ice_surface_elevation, grid, sh)


def _softness_integral(flow_law, E3, H_face, z, n: float, enhancement: float):
    """K = int_0^H A(E(z), p) (H-z)^(n+1) dz on one set of faces.

    E3: (My, Mx, Mz) enthalpy already averaged onto the faces;
    H_face: (My, Mx). Trapezoid on levels clipped to H.
    """
    zr = jnp.asarray(z, H_face.dtype)  # (Mz,)
    H = H_face[..., None]
    depth = jnp.maximum(H - zr, 0.0)
    p = flow_law.EC.pressure(depth)
    A = flow_law.softness(E3, p)
    # enhancement may be a (My, Mx, Mz) field (age-coupled interglacial
    # softening, stress_balance.sia.e_age_coupling) — fold it into the
    # integrand; identical to the scalar post-multiply when 0-d
    f = jnp.asarray(enhancement, H_face.dtype) * A * depth ** (n + 1.0)
    z_c = jnp.minimum(zr, H)  # clip levels to the ice column
    w = jnp.diff(z_c, axis=-1)
    return jnp.sum(0.5 * (f[..., 1:] + f[..., :-1]) * w, axis=-1)


def _flow_integral(flow_law, E3, H_face, z, slope_face, rho, g, enhancement):
    """Generalized diffusivity integral for non-Glen laws (reference
    ``SIAFD::compute_diffusivity`` full-flow-law form):

        D = 2 rho g  int_0^H  F(sigma(z), E, p) (H-z)^2 dz,
        sigma(z) = rho g (H - z) |grad s|,

    where F is ``FlowLaw.flow`` (eps = F sigma). For Glen laws this reduces
    to the closed-form ``_softness_integral`` route; Goldsby-Kohlstedt needs
    the explicit stress dependence."""
    zr = jnp.asarray(z, H_face.dtype)
    H = H_face[..., None]
    depth = jnp.maximum(H - zr, 0.0)
    p = flow_law.EC.pressure(depth)
    sigma = rho * g * depth * slope_face[..., None]
    F = flow_law.flow(sigma, E3, p)
    f = jnp.asarray(enhancement, H_face.dtype) * F * depth ** 2
    z_c = jnp.minimum(zr, H)
    w = jnp.diff(z_c, axis=-1)
    K = jnp.sum(0.5 * (f[..., 1:] + f[..., :-1]) * w, axis=-1)
    return 2.0 * rho * g * K


def diffusivity(flow_law, geometry, enthalpy: Optional[jnp.ndarray], grid,
                sh: Shifter, *, n: float = 3.0, enhancement: float = 1.0,
                rho: float = 910.0, g: float = 9.81,
                gradient_method: str = "mahaffy",
                theta_e: Optional[jnp.ndarray] = None,
                theta_n: Optional[jnp.ndarray] = None,
                d_limit: Optional[float] = None,
                no_model_mask: Optional[jnp.ndarray] = None,
                stored_surface: Optional[jnp.ndarray] = None,
                regional_zero_gradient: bool = False) -> SIAFlux:
    """Staggered diffusivity and diffusive flux.

    theta_e/theta_n: Schoof bed-smoother multipliers in [0, 1] on the faces
    (1 = no roughness correction).
    d_limit: cap the staggered diffusivity at this value (PISM
    ``stress_balance.sia.limit_diffusivity`` + ``max_diffusivity``); the
    flux uses the capped D, so margin cliffs stop collapsing the adaptive
    dt to seconds (see docs/VALIDATION.md dt study).
    no_model_mask / stored_surface: regional mode (reference
    ``SIAFD_Regional::compute_surface_gradient``): on staggered faces
    touching the no-model strip the surface gradient is replaced by the
    gradient of the *stored* surface (``usurfstore``), so the strip acts
    as a stationary Dirichlet frame that still exchanges diffusive flux
    with the modeled interior; with ``regional_zero_gradient`` the
    replaced gradient is zero instead (PISM ``regional.zero_gradient``).
    """
    H = geometry.ice_thickness
    grad = surface_gradient(geometry, grid, sh, gradient_method, n)

    if no_model_mask is not None:
        # regional mode: faces with either cell inside the strip see the
        # stored-surface gradient (or zero), not the evolving surface
        nmm = jnp.asarray(no_model_mask, bool)
        touch_e = nmm | sh(nmm, 0, 1)
        touch_n = nmm | sh(nmm, 1, 0)
        if regional_zero_gradient or stored_surface is None:
            gs = StaggeredGrad(*(jnp.zeros_like(H) for _ in range(4)))
        else:
            gs = surface_gradient_mahaffy(
                jnp.asarray(stored_surface, H.dtype), grid, sh)
        grad = StaggeredGrad(
            sx_e=jnp.where(touch_e, gs.sx_e, grad.sx_e),
            sy_e=jnp.where(touch_e, gs.sy_e, grad.sy_e),
            sx_n=jnp.where(touch_n, gs.sx_n, grad.sx_n),
            sy_n=jnp.where(touch_n, gs.sy_n, grad.sy_n))

    H_e = st.avg_to_east(H, sh)
    H_n = st.avg_to_north(H, sh)

    slope2_e = grad.sx_e ** 2 + grad.sy_e ** 2
    slope2_n = grad.sx_n ** 2 + grad.sy_n ** 2

    C = 2.0 * (rho * g) ** n

    if jnp.ndim(enhancement) > 0:
        enh_e = st.avg_to_east(enhancement, sh)
        enh_n = st.avg_to_north(enhancement, sh)
    else:
        enh_e = enh_n = enhancement

    if getattr(flow_law, "generalized", False):
        if enthalpy is None:
            raise ValueError("generalized (Goldsby-Kohlstedt) SIA "
                             "diffusivity needs an enthalpy field")
        E_e = st.avg_to_east(enthalpy, sh)
        E_n = st.avg_to_north(enthalpy, sh)
        De = _flow_integral(flow_law, E_e, H_e, grid.z,
                            jnp.sqrt(slope2_e), rho, g, enh_e)
        Dn = _flow_integral(flow_law, E_n, H_n, grid.z,
                            jnp.sqrt(slope2_n), rho, g, enh_n)
        if theta_e is not None:
            De = De * theta_e
        if theta_n is not None:
            Dn = Dn * theta_n
        if d_limit is not None:
            De = jnp.minimum(De, d_limit)
            Dn = jnp.minimum(Dn, d_limit)
        qe = -De * grad.sx_e
        qn = -Dn * grad.sy_n
        max_D = jnp.maximum(jnp.max(De), jnp.max(Dn))
        return SIAFlux(De=De, Dn=Dn, qe=qe, qn=qn, max_D=max_D)

    if enthalpy is None:
        if jnp.ndim(enhancement) > 0:
            raise ValueError("age-coupled (3D) enhancement needs the "
                             "thermal (enthalpy) SIA path")
        # isothermal closed form: K = e * A * H^(n+2) / (n+2)
        A = flow_law.softness(jnp.zeros((), H.dtype), jnp.zeros((), H.dtype))
        Ke = enhancement * A * H_e ** (n + 2.0) / (n + 2.0)
        Kn = enhancement * A * H_n ** (n + 2.0) / (n + 2.0)
    else:
        E_e = st.avg_to_east(enthalpy, sh)
        E_n = st.avg_to_north(enthalpy, sh)
        Ke = _softness_integral(flow_law, E_e, H_e, grid.z, n, enh_e)
        Kn = _softness_integral(flow_law, E_n, H_n, grid.z, n, enh_n)

    De = C * slope2_e ** ((n - 1.0) / 2.0) * Ke
    Dn = C * slope2_n ** ((n - 1.0) / 2.0) * Kn

    if theta_e is not None:
        De = De * theta_e
    if theta_n is not None:
        Dn = Dn * theta_n
    if d_limit is not None:
        # PISM limit_diffusivity: cap D (and with it the diffusive flux
        # and the stability limit). SIA is invalid at margin cliffs anyway;
        # uncapped cliff diffusivities (1e6 m^2/s observed on flickering
        # 5-10 km fronts) only collapse dt, they don't add accuracy.
        De = jnp.minimum(De, d_limit)
        Dn = jnp.minimum(Dn, d_limit)

    qe = -De * grad.sx_e
    qn = -Dn * grad.sy_n

    max_D = jnp.maximum(jnp.max(De), jnp.max(Dn))
    return SIAFlux(De=De, Dn=Dn, qe=qe, qn=qn, max_D=max_D)


def max_timestep_diffusivity(max_D, dx: float, dy: float,
                             adaptive_ratio: float = 0.12):
    """Explicit-diffusion stability limit (PISM
    ``max_timestep_diffusivity``): dt = 2 R / (D (1/dx^2 + 1/dy^2))."""
    denom = jnp.maximum(max_D, 1e-30) * (1.0 / dx ** 2 + 1.0 / dy ** 2)
    return 2.0 * adaptive_ratio / denom
