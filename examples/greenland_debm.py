"""Synthetic Greenland with the dEBM-simple surface model (PISM-dEBM-simple,
Zeitz et al. 2021 role).

Same synthetic Greenland-scale geometry and hybrid SSA+SIA/enthalpy chain as
``synthetic_greenland.py``, but the surface mass balance comes from the
diurnal energy balance model: insolation-driven + temperature-driven melt
with the melt-albedo feedback (``-surface debm_simple``). A uniform air
temperature offset (``--warming``) exercises the feedback: warming lowers
the summer albedo, which amplifies melt — the mechanism the reference's
dEBM-simple paper quantifies for Greenland.

Usage: python examples/greenland_debm.py [--km 20] [--years 100]
           [--warming 0] [--float32] [--paleo]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=20.0)
    ap.add_argument("--years", type=float, default=100.0)
    ap.add_argument("--warming", type=float, default=0.0,
                    help="uniform air-temperature offset [K]")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--paleo", action="store_true",
                    help="Berger orbital insolation instead of present-day")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.debm import DEBMSimple
    from pism_tpu.coupler.ocean import Constant as OceanConstant
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.state import ModelState, new_geometry

    SPY = 3.15569259747e7
    dx = args.km * 1e3
    Lx, Ly = 750e3, 1400e3
    Mx = int(2 * Lx / dx) + 1
    My = int(2 * Ly / dx) + 1
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
    print(f"grid: {Mx} x {My} x 41 ({args.km} km)")

    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": 0.25,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "calving.thickness_calving.threshold": 50.0,
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": True,
        "time_stepping.skip.max": 10,
        "runtime.float_dtype": "float32" if args.float32 else "float64",
        "runtime.device_loop": True,
        "surface.debm_simple.paleo.enabled": bool(args.paleo),
    })

    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0     # 60N..83N
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY

    a = atm.SeariseGreenland(latitude=jnp.asarray(lat),
                             longitude=jnp.asarray(lon),
                             precipitation=jnp.asarray(precip))
    if args.warming:
        a = atm.DeltaT(inner=a, offset=lambda t: args.warming)
    surface = DEBMSimple(atmosphere=a, latitude=jnp.asarray(lat), config=cfg)
    ocean = OceanConstant(config=cfg)

    state = ModelState(geometry=new_geometry(jnp.asarray(H),
                                             jnp.asarray(bed)))
    model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean)
    state = model.prepare_state(state)
    if args.float32:
        state = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)

    t = 0.0
    spin = min(10.0, args.years)
    tic = time.time()
    state, t, stats = model.step_once(state, t, spin * SPY)
    print(f"compile+{spin:g}y spin: {time.time() - tic:.0f} s")

    tic = time.time()
    state, t, stats = model.step_once(state, t, args.years * SPY)
    wall = time.time() - tic
    H1 = np.asarray(state.geometry.ice_thickness)
    # the stored albedo is the final update interval's snapshot (usually
    # winter = albedo_max); evaluate the melt-albedo feedback at the next
    # mid-summer instant for a meaningful summer albedo map
    t_summer = (np.floor(t / SPY) + 0.55) * SPY
    atm_in = surface.atmosphere(state.geometry, t_summer)
    frac = t_summer / SPY - np.floor(t_summer / SPY)
    T = atm_in.temperature + (atm_in.temperature_july - atm_in.temperature) \
        * np.cos(2.0 * np.pi * (frac - 0.5))
    _, _, _, M = surface.melt_components(
        t_summer, T, state.geometry.ice_surface_elevation,
        state.surface_albedo)
    # one fixed-point pass of the feedback: albedo consistent with melt
    for _ in range(3):
        alb = surface.albedo_from_melt(M)
        _, _, _, M = surface.melt_components(
            t_summer, T, state.geometry.ice_surface_elevation, alb)
    alb = np.asarray(alb)
    margin = (H1 > 1.0) & (H1 < 1500.0)
    print(json.dumps({
        "model_years": args.years,
        "steps": int(stats.nsteps),
        "wall_s": round(wall, 1),
        "model_years_per_hour": round(args.years / wall * 3600.0, 1),
        "volume_1e6_km3": float(H1.sum() * grid.dx * grid.dy / 1e15),
        "summer_albedo_min": round(float(alb[H1 > 1.0].min()), 3),
        "summer_albedo_margin_mean": round(float(alb[margin].mean()), 3)
        if margin.any() else None,
        "summer_melt_max_m_a": round(float(np.asarray(M)[H1 > 1.0].max())
                                     * SPY, 2),
        "nan": bool(np.isnan(H1).any()),
    }))


if __name__ == "__main__":
    main()
