"""Synthetic Greenland-scale hybrid run (SeaRISE-Greenland config analog).

PISM's headline configuration (``examples/std-greenland``) needs the SeaRISE
input dataset, which is not available in this environment (zero egress). This
example builds a synthetic Greenland-scale geometry (1500x2800 km at a chosen
resolution) with a PDD surface model on the Fausto temperature
parameterization, hybrid SSA+SIA dynamics, enthalpy thermodynamics, till
hydrology and Mohr-Coulomb basal strength — the full SeaRISE model chain —
so throughput and behavior can be exercised end-to-end. Swap the synthetic
fields for the real dataset via ``-i`` when available.

Usage: python examples/synthetic_greenland.py [--km 20] [--years 500]
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
    ap.add_argument("--years", type=float, default=500.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--skip", type=int, default=10)
    ap.add_argument("--ssa-dtype", default=None,
                    help="stress_balance.ssa.fd.solve_dtype override "
                         "(float64 | mixed)")
    ap.add_argument("--precond", default=None,
                    help="stress_balance.ssa.fd.preconditioner override "
                         "(jacobi | mg)")
    ap.add_argument("--host-loop", action="store_true",
                    help="host-dispatched steps instead of the on-device "
                         "while_loop segment runner (debug escape hatch)")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.pdd import TemperatureIndex
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
        "hydrology.model": "null",
        "calving.methods": "thickness_calving",
        "calving.thickness_calving.threshold": 50.0,
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": args.skip > 1,
        "time_stepping.skip.max": max(args.skip, 1),
        "runtime.float_dtype": "float32" if args.float32 else "float64",
        # on-device while_loop segments; --host-loop dispatches one step
        # at a time, for debugging
        "runtime.device_loop": not args.host_loop,
    })
    if args.ssa_dtype:
        cfg.update({"stress_balance.ssa.fd.solve_dtype": args.ssa_dtype})
    if args.precond:
        cfg.update({"stress_balance.ssa.fd.preconditioner": args.precond})

    # synthetic geometry: elongated dome-ridge island with coastal shelves
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0     # 60N..83N
    lon = -42.0 + X / Lx * 10.0

    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY
    a = atm.SeariseGreenland(latitude=jnp.asarray(lat), longitude=jnp.asarray(lon),
                             precipitation=jnp.asarray(precip))
    surface = TemperatureIndex(atmosphere=a, config=cfg)
    ocean = OceanConstant(config=cfg)

    geom = new_geometry(jnp.asarray(H), jnp.asarray(bed))
    state = ModelState(geometry=geom)
    model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean)
    state = model.prepare_state(state)
    if args.float32:
        state = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)

    t = 0.0
    # warmup/compile segment (not measured; --years is the measured window)
    spin = min(10.0, args.years)
    tic = time.time()
    state, t, stats = model.step_once(state, t, spin * SPY)
    print(f"compile+{spin:g}y spin: {time.time() - tic:.0f} s")

    tic = time.time()
    state, t, stats = model.step_once(state, t, args.years * SPY)
    wall = time.time() - tic
    H1 = np.asarray(state.geometry.ice_thickness)
    print(json.dumps({
        "model_years": args.years,
        "steps": int(stats.nsteps),
        "wall_s": round(wall, 1),
        "model_years_per_hour": round(args.years / wall * 3600.0, 1),
        "volume_1e6_km3": float(H1.sum() * grid.dx * grid.dy / 1e15),
        "max_speed_m_a": float(jnp.abs(state.u_ssa).max()) * SPY,
        "nan": bool(np.isnan(H1).any()),
    }))


if __name__ == "__main__":
    main()
