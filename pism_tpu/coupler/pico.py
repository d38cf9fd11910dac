"""PICO: Potsdam Ice-shelf Cavity mOdel (Reese et al. 2018, TC 12).

Rebuild of PISM ``src/coupler/ocean/Pico*`` (``PicoGeometry.cc``,
``PicoPhysics.cc``): ice shelves are partitioned into boxes following the
overturning circulation from the grounding line to the calving front; water
properties cascade through the boxes, giving the sub-shelf melt pattern
(strong at deep grounding lines, weak at the front).

Where the reference labels boxes with serial connected-component passes, the
box geometry here is computed by all-device flood-fill distance propagation
(`lax.while_loop` over masked dilations, SURVEY.md §2.5): d_GL = hop distance
from the grounding line, d_IF = hop distance from the ice front; the relative
position r = d_GL/(d_GL+d_IF) maps to boxes via Reese et al. eq. (9):
cell in box k iff 1 - sqrt((n-k+1)/n) <= r <= 1 - sqrt((n-k)/n).

Physics constants follow Reese et al. (2018) / PISM's config defaults
[re-derived from the publication; reference mount empty at survey time].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import state as S
from ..ops.stencils import Shifter
from .ocean import OceanInputs, OceanModel

# liquidus T_f = a S + b + c p  (Reese et al. 2018, Table 1)
A_LIQ = -0.0572        # K / (g/kg)
B_LIQ = 0.0788 + 273.15  # K
C_LIQ = 7.77e-8        # K / Pa
ALPHA_RHO = 7.5e-5     # 1/K      thermal expansion
BETA_RHO = 7.7e-4      # 1/(g/kg) haline contraction
RHO_STAR = 1033.0      # kg/m^3
C_P_OCEAN = 3974.0     # J/(kg K)
LATENT = 3.34e5        # J/kg


def _propagate_distance(seed_mask, region_mask, sh: Shifter, max_iters):
    """Hop distance from seed cells through region cells (inf outside)."""
    big = jnp.asarray(1e9)
    d0 = jnp.where(seed_mask, 0.0, big)

    def body(carry):
        d, changed, it = carry
        nbr = jnp.minimum(
            jnp.minimum(sh(d, 0, 1), sh(d, 0, -1)),
            jnp.minimum(sh(d, 1, 0), sh(d, -1, 0))) + 1.0
        d_new = jnp.where(region_mask, jnp.minimum(d, nbr), d)
        return d_new, jnp.any(d_new != d), it + 1

    def cond(carry):
        _, changed, it = carry
        return changed & (it < max_iters)

    d, _, _ = jax.lax.while_loop(cond, body, (d0, jnp.asarray(True),
                                              jnp.asarray(0)))
    return d


class PicoGeometry(NamedTuple):
    box: jnp.ndarray        # int32 box index, 0 = not a shelf cell
    d_gl: jnp.ndarray
    d_if: jnp.ndarray


class PicoFields(NamedTuple):
    """Full PICO solution for diagnostics (PISM ``Pico::diagnostics()``:
    pico_box_mask, pico_temperature_box, pico_salinity_box,
    pico_overturning, pico_contshelf_mask roles)."""
    melt: jnp.ndarray            # m/s ice equivalent, shelf cells
    T_basal: jnp.ndarray         # K, shelf-base (liquidus) temperature
    box: jnp.ndarray             # int32 box index (0 outside shelves)
    d_gl: jnp.ndarray            # hop distance from the grounding line
    d_if: jnp.ndarray            # hop distance from the ice front
    temperature: jnp.ndarray     # K, ocean box water temperature per cell
    salinity: jnp.ndarray        # g/kg, ocean box water salinity per cell
    overturning: jnp.ndarray     # m3/s, basin overturning flux per cell
    contshelf: jnp.ndarray       # bool, continental-shelf averaging domain


@dataclass
class Pico(OceanModel):
    """PICO box model. Ambient (T0, S0) are per-cell fields, typically
    constant per drainage basin (PISM averages input fields over the
    continental shelf of each basin; pass per-basin values directly)."""

    temperature_ocean: jnp.ndarray   # T0 [K] ambient (2D or (Nt,My,Mx))
    salinity_ocean: jnp.ndarray      # S0 [g/kg]
    config: object = None
    basin_mask: Optional[jnp.ndarray] = None  # int basins (optional)
    grid: object = None
    times: Optional[jnp.ndarray] = None   # (Nt,) [s] for forcing stacks
    period: float = 0.0                   # ocean.pico.periodic

    def __post_init__(self):
        cfg = self.config
        self.n_boxes = cfg.get_int("ocean.pico.number_of_boxes")
        self.gamma_T = cfg.get_number("ocean.pico.heat_exchange_coefficent")
        self.C_over = cfg.get_number("ocean.pico.overturning_coefficent")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.g = cfg.get_number("constants.standard_gravity")
        # fallbacks for basins without continental-shelf data (reference
        # PicoPhysics: T_dummy/S_dummy ambient + Beckmann-Goosse melt with
        # meltFactor on the affected shelves)
        self.T_dummy = cfg.get_number("ocean.pico.T_dummy", "K")
        self.S_dummy = cfg.get_number("ocean.pico.S_dummy")
        self.melt_factor = cfg.get_number("ocean.pico.meltFactor")
        self.exclude_rises = cfg.get_flag("ocean.pico.exclude_ice_rises")
        self.max_gl_dist = cfg.get_flag(
            "ocean.pico.maximize_grounding_line_distance")
        self.c_w = cfg.get_number("constants.sea_water.specific_heat_capacity")
        self.L_fus = cfg.get_number(
            "constants.fresh_water.latent_heat_of_fusion")
        self.sh = Shifter(self.grid)
        self.nu = self.rho_i / self.rho_w
        self.lam = LATENT / C_P_OCEAN

    def _slice(self, field, t, dtype):
        """Piecewise-constant time slice of a forcing stack
        (ocean.pico.file with a time axis; ocean.pico.periodic cycles)."""
        f = jnp.asarray(field, dtype)
        if self.times is None or f.ndim == 2:
            return f
        times = jnp.asarray(self.times)
        if self.period > 0.0:
            t = times[0] + jnp.mod(t - times[0], self.period)
        k = jnp.clip(jnp.searchsorted(times, t, side="right") - 1,
                     0, times.shape[0] - 1)
        return f[k]

    # ------------------------------------------------------------------
    def boxes(self, geometry) -> PicoGeometry:
        mask = geometry.cell_type
        sh = self.sh
        shelf = S.floating_ice(mask)
        grounded = S.grounded_ice(mask)
        ocean_free = mask == S.MASK_ICE_FREE_OCEAN
        max_it = mask.shape[0] + mask.shape[1]

        nbr = lambda m: (sh(m, 0, 1) | sh(m, 0, -1) | sh(m, 1, 0) | sh(m, -1, 0))
        gl_grounded = grounded
        if self.exclude_rises:
            # reference PicoGeometry ice rises: grounded patches not part of
            # the main grounded body do not seed the grounding-line distance.
            # on-device reconstruction: the main body is the grounded
            # connected component holding the thickest grounded ice (device
            # flood fill, no gather-to-host).
            H = geometry.ice_thickness
            Hg = jnp.where(grounded, H, -1.0)
            seed = Hg >= jnp.max(Hg)          # argmax cell(s)

            def grow(carry):
                m, changed, it = carry
                g = m | (grounded & nbr(m))
                return g, jnp.any(g != m), it + 1

            def growing(carry):
                _, changed, it = carry
                return changed & (it < max_it)

            gl_grounded, _, _ = jax.lax.while_loop(
                growing, grow, (seed & grounded, jnp.asarray(True),
                                jnp.asarray(0)))
        gl_seed = shelf & nbr(gl_grounded)    # shelf cells at the GL
        if_seed = shelf & nbr(ocean_free)     # shelf cells at the front

        d_gl = _propagate_distance(gl_seed, shelf, sh, max_it)
        d_if = _propagate_distance(if_seed, shelf, sh, max_it)

        n = float(self.n_boxes)
        if self.max_gl_dist and self.basin_mask is not None:
            # reference ocean.pico.maximize_grounding_line_distance: box
            # extents from the distance to the GL relative to the basin-wide
            # maximum GL distance, instead of the local d_gl/(d_gl+d_if)
            seg = jnp.asarray(self.basin_mask, jnp.int32).ravel()
            nb = int(np.max(np.asarray(self.basin_mask))) + 1
            dmax = jax.ops.segment_max(
                jnp.where(shelf & (d_gl < 1e8), d_gl, 0.0).ravel(), seg,
                num_segments=nb)
            dmax_f = jnp.maximum(dmax[seg].reshape(d_gl.shape), 1.0)
            r = jnp.clip(d_gl / dmax_f, 0.0, 1.0)
        else:
            r = d_gl / jnp.maximum(d_gl + d_if, 1.0)
        k = jnp.arange(1, self.n_boxes + 1, dtype=r.dtype)
        lo = 1.0 - jnp.sqrt((n - (k - 1.0)) / n)   # box k lower bound
        hi = 1.0 - jnp.sqrt((n - k) / n)
        in_box = (r[..., None] >= lo) & (r[..., None] <= hi + 1e-9)
        box = jnp.argmax(in_box, axis=-1) + 1
        box = jnp.where(shelf & (d_gl < 1e8) & (d_if < 1e8), box, 0)
        # shelf cells unreachable from GL or front: treat as box n (weak melt)
        box = jnp.where(shelf & (box == 0), self.n_boxes, box)
        return PicoGeometry(box.astype(jnp.int32), d_gl, d_if)

    def _per_basin_mean(self, field, where, fallback=None):
        """Mean of `field` over `where` cells per basin, scattered back to
        cells (segment_sum over the static basin labels). Basins with no
        `where` cells get `fallback` (reference T_dummy/S_dummy); with
        fallback=None they get 0. Returns (mean_field, no_data_mask)."""
        nb = int(np.max(np.asarray(self.basin_mask))) + 1
        seg = jnp.asarray(self.basin_mask, jnp.int32).ravel()
        w = where.astype(field.dtype).ravel()
        s = jax.ops.segment_sum(field.ravel() * w, seg, num_segments=nb)
        n = jax.ops.segment_sum(w, seg, num_segments=nb)
        mean = s / jnp.maximum(n, 1.0)
        if fallback is not None:
            mean = jnp.where(n > 0, mean, fallback)
        no_data = (n <= 0)[seg].reshape(field.shape)
        return mean[seg].reshape(field.shape), no_data

    def _per_basin_area(self, member_mask):
        nb = int(np.max(np.asarray(self.basin_mask))) + 1
        seg = jnp.asarray(self.basin_mask, jnp.int32).ravel()
        w = member_mask.astype(jnp.float64).ravel()
        area = jax.ops.segment_sum(w, seg, num_segments=nb) \
            * self.grid.dx * self.grid.dy
        return area[seg].reshape(member_mask.shape)

    # ------------------------------------------------------------------
    def inputs(self, geometry, t) -> OceanInputs:
        pf = self.solve(geometry, t)
        return OceanInputs(pf.melt, pf.T_basal)

    def solve(self, geometry, t) -> PicoFields:
        pg = self.boxes(geometry)
        shelf = S.floating_ice(geometry.cell_type)
        H = geometry.ice_thickness
        dtype = H.dtype
        # pressure at the shelf base (ice overburden)
        p = self.rho_i * self.g * H

        T0 = self._slice(self.temperature_ocean, t, dtype)
        S0 = self._slice(self.salinity_ocean, t, dtype)
        cont = jnp.zeros(H.shape, bool)
        no_data = jnp.zeros(H.shape, bool)
        if self.basin_mask is not None:
            # PISM averages the ambient water properties over each basin's
            # continental shelf (ocean cells above the shelf-depth cutoff)
            shelf_depth = self.config.get_number("ocean.pico.continental_shelf_depth")
            cont = (geometry.cell_type == S.MASK_ICE_FREE_OCEAN) & \
                (geometry.bed_elevation >= shelf_depth)
            cont = cont | shelf  # fall back to cavity cells if no shelf cells
            T0, no_data = self._per_basin_mean(T0, cont,
                                               fallback=self.T_dummy)
            S0, _ = self._per_basin_mean(S0, cont, fallback=self.S_dummy)

        area_cell = self.grid.dx * self.grid.dy
        melt = jnp.zeros_like(H)
        T_basal = jnp.full_like(H, B_LIQ)

        # --- box 1 (quadratic; Reese et al. 2018 eq. A6) -------------------
        box1 = pg.box == 1
        if self.basin_mask is not None:
            A1 = jnp.maximum(self._per_basin_area(box1), area_cell)
        else:
            A1 = jnp.maximum(jnp.sum(jnp.where(box1, 1.0, 0.0)) * area_cell,
                             area_cell)
        g1 = A1 * self.gamma_T
        s1 = S0 / (self.nu * self.lam)
        Tf0 = A_LIQ * S0 + B_LIQ + C_LIQ * p
        Tstar1 = Tf0 - T0                       # <= 0 for warm water
        denom = self.C_over * RHO_STAR * (BETA_RHO * s1 - ALPHA_RHO)
        eta = g1 / jnp.maximum(denom, 1e-30)
        x = -0.5 * eta + jnp.sqrt(jnp.maximum(0.25 * eta ** 2 - eta * Tstar1, 0.0))
        T1 = T0 - x
        S1 = S0 - S0 * x / (self.nu * self.lam)
        q = self.C_over * RHO_STAR * (BETA_RHO * (S0 - S1) - ALPHA_RHO * (T0 - T1))

        def box_melt(Tk, Sk, pk):
            Tf = A_LIQ * Sk + B_LIQ + C_LIQ * pk
            return -self.gamma_T / (self.nu * self.lam) * (Tf - Tk)

        m1 = box_melt(T1, S1, p)
        melt = jnp.where(box1, m1, melt)
        T_basal = jnp.where(box1, A_LIQ * S1 + B_LIQ + C_LIQ * p, T_basal)
        T_field = jnp.where(box1, T1, jnp.broadcast_to(T0, H.shape))
        S_field = jnp.where(box1, S1, jnp.broadcast_to(S0, H.shape))

        # --- boxes k >= 2 (sequential cascade; eq. A11-A12) ----------------
        Tk, Sk = T1, S1
        for kk in range(2, self.n_boxes + 1):
            in_k = pg.box == kk
            if self.basin_mask is not None:
                Ak = jnp.maximum(self._per_basin_area(in_k), area_cell)
            else:
                Ak = jnp.maximum(jnp.sum(jnp.where(in_k, 1.0, 0.0)) * area_cell,
                                 area_cell)
            gk = Ak * self.gamma_T
            Tfk = A_LIQ * Sk + B_LIQ + C_LIQ * p
            Tstark = Tfk - Tk
            xk = -gk * Tstark / jnp.maximum(
                q + gk - gk * A_LIQ * Sk / (self.nu * self.lam), 1e-30)
            Tk_new = Tk - xk
            Sk_new = Sk - Sk * xk / (self.nu * self.lam)
            mk = box_melt(Tk_new, Sk_new, p)
            melt = jnp.where(in_k, mk, melt)
            T_basal = jnp.where(in_k, A_LIQ * Sk_new + B_LIQ + C_LIQ * p, T_basal)
            T_field = jnp.where(in_k, Tk_new, T_field)
            S_field = jnp.where(in_k, Sk_new, S_field)
            Tk, Sk = Tk_new, Sk_new

        if self.basin_mask is not None:
            # shelves in basins with no ambient data: Beckmann-Goosse melt
            # with ocean.pico.meltFactor on the T_dummy/S_dummy ambient
            # (reference PicoPhysics fallback)
            Tf_bg = A_LIQ * S0 + B_LIQ + C_LIQ * p
            gamma_bg = 1e-4   # Beckmann & Goosse (2003) exchange velocity
            m_bg = (self.melt_factor * self.rho_w * self.c_w * gamma_bg
                    / (self.rho_i * self.L_fus)) \
                * jnp.maximum(T0 - Tf_bg, 0.0)
            melt = jnp.where(no_data, m_bg, melt)
            T_basal = jnp.where(no_data, Tf_bg, T_basal)
        melt = jnp.where(shelf, melt, 0.0)
        q_field = jnp.where(shelf, jnp.broadcast_to(q, H.shape), 0.0)
        return PicoFields(melt.astype(dtype), T_basal.astype(dtype),
                          pg.box, pg.d_gl, pg.d_if,
                          jnp.where(shelf, T_field, 0.0).astype(dtype),
                          jnp.where(shelf, S_field, 0.0).astype(dtype),
                          q_field.astype(dtype), cont)
