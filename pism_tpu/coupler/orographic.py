"""Orographic precipitation: Smith & Barstad (2004) linear theory.

Rebuild of PISM ``atmosphere::OrographicPrecipitation`` (the LTOP model,
FFT-based in the reference via FFTW; here ``jnp.fft``): precipitation from
forced uplift of moist air over the evolving ice surface,

    P_hat(k, l) = Cw i sigma h_hat /
        ((1 - i m H_w)(1 + i sigma tau_c)(1 + i sigma tau_f)),

sigma = U k + V l (intrinsic frequency), m the vertical wavenumber from
moist stability N_m. P = max(P_background + ifft(P_hat), 0). Because the
surface evolves, precipitation responds to ice-sheet growth — the feedback
PISM uses this model for.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..util.units import SEC_PER_YEAR
from .atmosphere import AtmosphereInputs, AtmosphereModel


@dataclass
class OrographicPrecipitation(AtmosphereModel):
    grid: object
    wind_u: float = 10.0        # m/s eastward
    wind_v: float = 0.0
    tau_c: float = 1000.0       # cloud conversion time [s]
    tau_f: float = 1000.0       # fallout time [s]
    Hw: float = 2500.0          # water vapor scale height [m]
    Nm: float = 0.005           # moist stability frequency [1/s]
    Cw: float = 0.001           # uplift sensitivity [kg m^-3]
    background_precip: float = 0.3 / SEC_PER_YEAR  # m/s ice equivalent
    temperature: float = 263.15
    temperature_july: float = 268.15
    rho_water: float = 1000.0
    #: Coriolis parameter [1/s] from the reference's
    #: atmosphere.orographic_precipitation.coriolis_latitude (enters the
    #: intrinsic-frequency denominator of the vertical wavenumber)
    f_cor: float = 0.0
    #: multiplier on the orographic perturbation (reference scale_factor)
    scale_factor: float = 1.0
    #: clamp negative total precipitation (reference truncate)
    truncate: bool = True
    #: pad the FFT domain by this factor against periodic wrap-around
    #: (reference grid_size_factor)
    pad_factor: int = 1

    def __post_init__(self):
        g = self.grid
        self.Ny = max(int(self.pad_factor), 1) * g.My
        self.Nx = max(int(self.pad_factor), 1) * g.Mx
        kx = np.fft.rfftfreq(self.Nx, g.dx) * 2.0 * np.pi
        ky = np.fft.fftfreq(self.Ny, g.dy) * 2.0 * np.pi
        KY, KX = np.meshgrid(ky, kx, indexing="ij")
        self._kx = jnp.asarray(KX)
        self._ky = jnp.asarray(KY)

    def precipitation_field(self, surface):
        # spectra stay in the field precision (complex64 under float32), so
        # an f32 run does not silently promote to complex128
        h2 = jnp.asarray(surface)
        g = self.grid
        h = h2 - jnp.mean(h2)
        if self.pad_factor > 1:
            hp = jnp.zeros((self.Ny, self.Nx), h.dtype)
            h = hp.at[:g.My, :g.Mx].set(h)
        cdt = jnp.complex64 if h.dtype == jnp.float32 else jnp.complex128
        h_hat = jnp.fft.rfft2(h)
        kx = self._kx.astype(h.dtype)
        ky = self._ky.astype(h.dtype)
        sigma = self.wind_u * kx + self.wind_v * ky
        k2 = kx ** 2 + ky ** 2
        # vertical wavenumber (moist, hydrostatic limit with regularization;
        # with rotation the denominator is sigma^2 - f^2)
        sigma_reg = jnp.where(jnp.abs(sigma) < 1e-10,
                              jnp.sign(sigma) * 1e-10 + (sigma == 0) * 1e-10,
                              sigma)
        denom_sig = sigma_reg ** 2 - self.f_cor ** 2
        denom_sig = jnp.where(jnp.abs(denom_sig) < 1e-18,
                              jnp.sign(denom_sig) * 1e-18
                              + (denom_sig == 0) * 1e-18, denom_sig)
        m2 = (self.Nm ** 2 - sigma_reg ** 2) / denom_sig * k2
        m = jnp.where(m2 >= 0,
                      jnp.sqrt(jnp.abs(m2)) * jnp.sign(sigma_reg),
                      1j * jnp.sqrt(jnp.abs(m2))).astype(cdt)
        denom = ((1.0 - 1j * m * self.Hw)
                 * (1.0 + 1j * sigma * self.tau_c)
                 * (1.0 + 1j * sigma * self.tau_f))
        P_hat = self.Cw * 1j * sigma * h_hat / denom
        P = jnp.fft.irfft2(P_hat, s=h.shape)   # kg m^-2 s^-1
        if self.pad_factor > 1:
            P = P[:g.My, :g.Mx]
        P = self.scale_factor * P / self.rho_water   # m/s water equivalent
        total = self.background_precip + P
        return jnp.maximum(total, 0.0) if self.truncate else total

    def __call__(self, geometry, t) -> AtmosphereInputs:
        s = geometry.ice_surface_elevation
        P = self.precipitation_field(s).astype(s.dtype)
        shp = s.shape
        return AtmosphereInputs(
            jnp.full(shp, self.temperature, s.dtype),
            jnp.full(shp, self.temperature_july, s.dtype),
            P)


@dataclass
class OrographicModifier(AtmosphereModel):
    """Atmosphere modifier (PISM ``-atmosphere ...,orographic_precipitation``):
    temperature passes through from the inner model; precipitation is
    replaced by the Smith-Barstad LTOP field over the evolving surface."""

    inner: AtmosphereModel
    ltop: OrographicPrecipitation

    def __call__(self, geometry, t) -> AtmosphereInputs:
        inp = self.inner(geometry, t)
        s = geometry.ice_surface_elevation
        P = self.ltop.precipitation_field(s).astype(s.dtype)
        return AtmosphereInputs(inp.temperature, inp.temperature_july, P)


def orographic_from_config(grid, config):
    """Build an :class:`OrographicPrecipitation` from
    ``atmosphere.orographic_precipitation.*`` parameters (PISM names)."""
    import math

    p = "atmosphere.orographic_precipitation."
    speed = config.get_number(p + "wind_speed", "m s-1")
    direction = config.get_number(p + "wind_direction", "degrees")
    # meteorological convention: direction the wind blows FROM, clockwise
    # from north; 270 deg = westerly = +x wind
    theta = math.radians(direction)
    # Cw = rho_Sref Gamma_m / gamma (Smith & Barstad 2004) when the
    # thermodynamic constants are configured and no direct uplift
    # sensitivity overrides them
    if not config.is_set(p + "uplift_sensitivity") and any(
            config.is_set(p + k) for k in
            ("reference_density", "moist_adiabatic_lapse_rate",
             "lapse_rate")):
        Cw = (config.get_number(p + "reference_density")
              * config.get_number(p + "moist_adiabatic_lapse_rate")
              / config.get_number(p + "lapse_rate"))
    else:
        Cw = config.get_number(p + "uplift_sensitivity", "kg m-3")
    # Coriolis parameter at the configured latitude
    lat = config.get_number(p + "coriolis_latitude")
    f_cor = 2.0 * 7.2921e-5 * math.sin(math.radians(lat))
    return OrographicPrecipitation(
        grid=grid,
        wind_u=-speed * math.sin(theta),
        wind_v=-speed * math.cos(theta),
        tau_c=config.get_number(p + "conversion_time", "seconds"),
        tau_f=config.get_number(p + "fallout_time", "seconds"),
        Hw=config.get_number(p + "water_vapor_scale_height", "m"),
        Nm=config.get_number(p + "moist_stability_frequency", "s-1"),
        Cw=Cw,
        background_precip=config.get_number(
            p + "background_precip_rate", "m s-1"),
        f_cor=f_cor,
        scale_factor=config.get_number(p + "scale_factor"),
        truncate=config.get_flag(p + "truncate"),
        pad_factor=config.get_int(p + "grid_size_factor"),
    )
