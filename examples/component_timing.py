"""Per-component wall-clock breakdown of the hybrid Greenland chain
(the PISM ``-log_view`` / per-stage summary analog, SURVEY.md §5.1).

Builds the same model chain as synthetic_greenland.py, spins up briefly,
then times each jitted component standalone (block_until_ready between
calls) plus the full adaptive step, and reports SSA Newton/Krylov
iteration counts.

Usage: python examples/component_timing.py [--km 20] [--reps 20]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=20.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--spin-years", type=float, default=10.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--config", action="append", default=[],
                    metavar="KEY=VALUE", help="config override (repeatable)")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.ocean import Constant as OceanConstant
    from pism_tpu.coupler.pdd import TemperatureIndex
    from pism_tpu.model.icemodel import IceModel, StepStats
    from pism_tpu.state import ModelState, new_geometry

    SPY = 3.15569259747e7
    dx = args.km * 1e3
    Lx, Ly = 750e3, 1400e3
    Mx, My = int(2 * Lx / dx) + 1, int(2 * Ly / dx) + 1
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
    f32 = not args.float64
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
        "runtime.float_dtype": "float32" if f32 else "float64",
        "runtime.device_loop": False,
    })
    if args.config:
        from pism_tpu.cli import _apply_config_overrides
        _apply_config_overrides(cfg, args.config)
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY
    a = atm.SeariseGreenland(latitude=jnp.asarray(lat),
                             longitude=jnp.asarray(lon),
                             precipitation=jnp.asarray(precip))
    surface = TemperatureIndex(atmosphere=a, config=cfg)
    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=OceanConstant(config=cfg))
    state = model.prepare_state(
        ModelState(geometry=new_geometry(jnp.asarray(H), jnp.asarray(bed))))
    if f32:
        state = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)

    print(f"grid {Mx}x{My}x41 @ {args.km} km  "
          f"dtype={'f32' if f32 else 'f64'}")
    t = 0.0
    tic = time.time()
    state, t, _ = model.step_once(state, t, args.spin_years * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)
    print(f"spin-up+compile: {time.time() - tic:.0f} s")

    # --- standalone components ---------------------------------------
    tau_c = model.yield_stress.compute(state)

    ssa_diag = jax.jit(lambda s: model.ssa.solve(s, tau_c, diagnostics=True))
    sb_full = jax.jit(lambda s: model.stress_balance.update(s, tau_c))

    def timeit(name, fn, *a):
        out = fn(*a)
        jax.block_until_ready(out)
        tic = time.time()
        for _ in range(args.reps):
            out = fn(*a)
        jax.block_until_ready(out)
        ms = (time.time() - tic) / args.reps * 1e3
        print(f"{name:<30} {ms:>9.2f} ms")
        return out

    u, v, info = timeit("ssa.solve (warm start)", ssa_diag, state)
    print(f"    newton_iters={int(info['newton_iters'])} "
          f"krylov_iters={int(info['krylov_iters'])} "
          f"F2_final/b2={float(info['F2_final'] / info['b_norm2']):.2e}")
    cold = state.replace(u_ssa=jnp.zeros_like(u), v_ssa=jnp.zeros_like(v))
    _, _, info_c = timeit("ssa.solve (cold start)", ssa_diag, cold)
    print(f"    newton_iters={int(info_c['newton_iters'])} "
          f"krylov_iters={int(info_c['krylov_iters'])}")
    timeit("stress_balance.update (full)", sb_full, state)

    if model.energy_model is not None:
        sb = model.stress_balance.update(state, tau_c)
        smb = model.surface(state.geometry, 0.0)
        G = jnp.full(grid.shape2, model.geothermal,
                     state.geometry.ice_thickness.dtype)
        dt_f = jnp.asarray(0.1 * SPY, state.geometry.ice_thickness.dtype)

        def energy_fn(s):
            return model.energy_model.step(
                s, sb.sia3, smb.temperature, dt_f, geothermal_flux=G,
                frictional_heating=sb.basal_frictional_heating,
                tillwat=s.tillwat)
        timeit("energy step", jax.jit(energy_fn), state)

    def full_step(s):
        return model._step(s, jnp.float64(t), jnp.float64(t) + 50 * SPY,
                           StepStats.zero())
    st_out = timeit("FULL adaptive step", jax.jit(full_step), state)
    print(f"    dt = {float(st_out[1] - t) / SPY:.4f} a")


if __name__ == "__main__":
    main()
