"""Bed deformation (glacial isostatic adjustment).

Rebuild of PISM ``src/earth/`` (``bed::PointwiseIsostasy``,
``bed::LingleClark`` / ``BedDeformLC``): the Lingle & Clark (1985) model of
a viscous half-space mantle under an elastic lithosphere plate, solved
spectrally. Where the reference uses FFTW on an extended grid, this uses
``jnp.fft`` (XLA FFT) on a 2x zero-padded grid; the per-mode Crank-Nicolson
update for the viscous displacement u(k) of

    2 eta |k| du/dt = -(rho_r g + D k^4) u - q,     q = rho_i g (H - H_ref)

is unconditionally stable, so it can be applied every step. The elastic
part uses the equilibrium flexural-plate spectral response
u_e(k) = -q(k) / (rho_r g + D k^4) (the reference instead convolves a
spherical-Earth Green's function; the plate response is the flat-Earth
equivalent).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .. import state as S


@dataclass
class PointwiseIsostasy:
    """db = -(rho_i / rho_r) (H - H_ref) (PISM ``bed::PointwiseIsostasy``)."""

    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        self.f = cfg.get_number("constants.ice.density") / \
            cfg.get_number("bed_deformation.lithosphere_density")

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        g = state.geometry
        bed_ref = state.bed_reference
        load_ref = state.bed_load_reference  # reference thickness (see initialize)
        bed = bed_ref - self.f * (g.ice_thickness - load_ref)
        return state.replace(geometry=g.replace(bed_elevation=bed))

    def initialize(self, state: S.ModelState) -> S.ModelState:
        return state.replace(
            bed_reference=state.geometry.bed_elevation,
            bed_load_reference=state.geometry.ice_thickness)


@dataclass
class LingleClark:
    grid: object
    config: object
    include_elastic: Optional[bool] = None

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_r = cfg.get_number("bed_deformation.mantle_density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.D = cfg.get_number("bed_deformation.lithosphere_flexural_rigidity")
        self.eta = cfg.get_number("bed_deformation.mantle_viscosity")
        if self.include_elastic is None:
            self.include_elastic = cfg.get_flag("bed_deformation.lc.elastic_model")
        # reference bed_deformation.update_interval (BedDef.cc): solve the
        # spectral step only every interval; between solves the bed is
        # frozen and the load anomaly keeps accumulating (dload is computed
        # from the CURRENT thickness each solve, so nothing is lost)
        self.update_interval = cfg.get_number("bed_deformation.update_interval",
                                              "seconds")
        fac = cfg.get_int("bed_deformation.lc.grid_size_factor")
        grid = self.grid
        self.Ny = fac * grid.My
        self.Nx = fac * grid.Mx
        ky = np.fft.fftfreq(self.Ny, grid.dy) * 2.0 * np.pi
        kx = np.fft.rfftfreq(self.Nx, grid.dx) * 2.0 * np.pi
        KY, KX = np.meshgrid(ky, kx, indexing="ij")
        self.k = jnp.asarray(np.sqrt(KX ** 2 + KY ** 2))
        self.k4 = self.k ** 4

    def _pad(self, a):
        out = jnp.zeros((self.Ny, self.Nx), a.dtype)
        return out.at[:self.grid.My, :self.grid.Mx].set(a)

    def _crop(self, a):
        return a[:self.grid.My, :self.grid.Mx]

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        T = self.update_interval
        if t is not None and T > 0.0:
            # solve only when the step crosses an update-interval boundary,
            # with the effective dt of one interval (t is the step END time)
            import jax
            crossed = jnp.floor(t / T) > jnp.floor((t - dt) / T)
            dt_eff = jnp.maximum(jnp.asarray(T, jnp.float64),
                                 jnp.asarray(dt, jnp.float64))
            return jax.lax.cond(
                crossed,
                lambda s: self._solve(s, dt_eff),
                lambda s: s, state)
        return self._solve(state, dt)

    def _solve(self, state: S.ModelState, dt) -> S.ModelState:
        g = state.geometry
        H_ref = state.bed_load_reference          # reference load thickness
        bed_ref = state.bed_reference      # undeformed bed
        U = state.bed_uplift               # viscous displacement field

        dload = g.ice_thickness - H_ref
        q = self.rho_i * self.g * self._pad(dload)
        q_hat = jnp.fft.rfft2(q)

        U_hat = jnp.fft.rfft2(self._pad(U).astype(q.dtype))
        # keep the spectral coefficients in the field precision: mixing the
        # f64 wavenumber tables into c64 spectra would promote an f32 run's
        # FFTs to complex128 (twice the bytes, and a different result)
        rdt = q.dtype
        alpha = (self.rho_r * self.g + self.D * self.k4).astype(rdt)
        two_eta_k = (2.0 * self.eta
                     * jnp.maximum(self.k, 1e-12)).astype(rdt)
        # dt arrives as an f64 scalar from the interval gate; dividing the
        # f32 spectra by it would promote the whole spectral update to f64
        a_coef = two_eta_k / jnp.asarray(dt).astype(rdt)
        U_hat_new = ((a_coef - 0.5 * alpha) * U_hat - q_hat) / (a_coef + 0.5 * alpha)
        # k = 0 mode: immediate local isostatic equilibrium has no meaning on
        # the mean; keep the mean displacement at its relaxed value
        U_hat_new = U_hat_new.at[0, 0].set(-q_hat[0, 0] / (self.rho_r * self.g))
        U_new = self._crop(jnp.fft.irfft2(U_hat_new, s=(self.Ny, self.Nx)))

        bed = bed_ref + U_new
        if self.include_elastic:
            Ue_hat = -q_hat / alpha
            Ue = self._crop(jnp.fft.irfft2(Ue_hat, s=(self.Ny, self.Nx)))
            bed = bed + Ue
            state = state.replace(bed_load_reference=H_ref)  # unchanged reference

        geom = g.replace(bed_elevation=bed.astype(g.bed_elevation.dtype))
        return state.replace(geometry=geom,
                             bed_uplift=U_new.astype(U.dtype))

    def initialize(self, state: S.ModelState,
                   uplift_rate=None) -> S.ModelState:
        """Record the reference (assumed-equilibrium) bed and load.

        ``uplift_rate`` [m/s] (or the file named by
        ``bed_deformation.bed_uplift_file``; variable ``dbdt``; reference
        ``-uplift_file``) bootstraps the viscous plate displacement so the
        model's initial d(bed)/dt matches the observed uplift: with zero
        load anomaly the spectral evolution is dU/dt = -alpha U /(2 eta k),
        inverted per mode for U0. The undeformed reference bed becomes
        bed - U0 so the current bed is reproduced exactly."""
        g = state.geometry
        if uplift_rate is None:
            path = self.config.get_string("bed_deformation.bed_uplift_file")
            if path:
                from ..io.bootstrap import read_and_regrid
                import numpy as _np
                flds = read_and_regrid(path, self.grid,
                                       variables=["dbdt", "uplift"])
                u = flds.get("dbdt", flds.get("uplift"))
                if u is None:
                    raise ValueError(
                        f"{path!r} has no dbdt/uplift variable")
                uplift_rate = jnp.asarray(_np.nan_to_num(
                    u, nan=self.config.get_number(
                        "bootstrapping.defaults.uplift")))
        U0 = jnp.zeros_like(g.bed_elevation)
        bed_ref = g.bed_elevation
        if uplift_rate is not None:
            up = self._pad(jnp.asarray(uplift_rate,
                                       g.bed_elevation.dtype))
            up_hat = jnp.fft.rfft2(up)
            rdt = up.dtype
            alpha = (self.rho_r * self.g + self.D * self.k4).astype(rdt)
            two_eta_k = (2.0 * self.eta
                         * jnp.maximum(self.k, 1e-12)).astype(rdt)
            U0_hat = -(two_eta_k * up_hat) / alpha
            U0_hat = U0_hat.at[0, 0].set(0.0)   # mean displacement free
            U0 = self._crop(jnp.fft.irfft2(U0_hat, s=(self.Ny, self.Nx)))
            # the step pins the PADDED-domain k=0 mode to its relaxed value
            # (0 at zero load anomaly); after crop + re-pad that mode equals
            # the cropped-region sum, so remove the cropped mean or the
            # first step snaps it away as a spurious uniform jump
            U0 = U0 - jnp.mean(U0)
            U0 = U0.astype(g.bed_elevation.dtype)
            bed_ref = g.bed_elevation - U0
        return state.replace(
            bed_reference=bed_ref,
            bed_load_reference=g.ice_thickness,
            bed_uplift=U0)


@dataclass
class GivenBed:
    """Prescribed bed deformation (PISM ``bed::Given``, ``-bed_def given``):
    bed(t) = topg_reference + topg_delta(t), with ``topg_delta`` a
    time-dependent field stack read from ``bed_deformation.given.file``
    (linear interpolation in time, end values held outside the record) and
    the reference bed from ``bed_deformation.given.reference_file``
    (variable ``topg``; defaults to the bed at initialization)."""

    grid: object
    config: object
    topg_delta: object = None     # (Nt, My, Mx) or (My, Mx)
    times: object = None          # (Nt,) model seconds

    def __post_init__(self):
        cfg = self.config
        if self.topg_delta is None:
            # the reference name is bed_deformation.bed_topography_delta_file
            # (-topg_delta_file); bed_deformation.given.file is the rebuild's
            # legacy spelling
            path = cfg.get_string("bed_deformation.bed_topography_delta_file") \
                or cfg.get_string("bed_deformation.given.file")
            if not path:
                raise ValueError(
                    "-bed_def given needs "
                    "bed_deformation.bed_topography_delta_file")
            from ..io.bootstrap import read_forcing_fields
            fields, times = read_forcing_fields(path, self.grid,
                                                ["topg_delta"])
            if "topg_delta" not in fields:
                raise ValueError(
                    f"no variable topg_delta in {path!r}")
            d = np.asarray(fields["topg_delta"])
            if np.isnan(d).any():
                raise ValueError(
                    f"topg_delta from {path!r} does not cover the model grid")
            self.topg_delta = jnp.asarray(d)
            self.times = None if times is None else jnp.asarray(times)
        self._ref_file = cfg.get_string(
            "bed_deformation.given.reference_file")

    def _delta_at(self, t):
        d = self.topg_delta
        if d.ndim == 2 or self.times is None or self.times.shape[0] == 1:
            return d if d.ndim == 2 else d[0]
        tt = self.times
        t = jnp.clip(t, tt[0], tt[-1])
        i = jnp.clip(jnp.searchsorted(tt, t, side="right") - 1,
                     0, tt.shape[0] - 2)
        w = (t - tt[i]) / jnp.maximum(tt[i + 1] - tt[i], 1e-30)
        return (1.0 - w) * d[i] + w * d[i + 1]

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        g = state.geometry
        if t is None:
            t = self.times[0] if self.times is not None else 0.0
        bed = state.bed_reference + self._delta_at(t)
        geom = g.replace(bed_elevation=bed.astype(g.bed_elevation.dtype))
        return state.replace(geometry=geom)

    def initialize(self, state: S.ModelState) -> S.ModelState:
        bed_ref = state.geometry.bed_elevation
        if self._ref_file:
            from ..io.bootstrap import read_forcing_fields
            fields, _ = read_forcing_fields(self._ref_file, self.grid,
                                            ["topg"])
            if "topg" in fields:
                r = np.asarray(fields["topg"])
                r = r[-1] if r.ndim == 3 else r
                if np.isnan(r).any():
                    raise ValueError(
                        f"topg from {self._ref_file!r} does not cover the "
                        "model grid")
                bed_ref = jnp.asarray(r).astype(bed_ref.dtype)
        return state.replace(
            bed_reference=bed_ref,
            bed_load_reference=state.geometry.ice_thickness)


def bed_deformation_from_config(grid, config):
    name = config.get_string("bed_deformation.model")
    if name in ("none", ""):
        return None
    if name == "iso":
        return PointwiseIsostasy(grid=grid, config=config)
    if name == "lc":
        return LingleClark(grid=grid, config=config)
    if name == "given":
        return GivenBed(grid=grid, config=config)
    raise ValueError(f"unknown bed deformation model {name!r}")
