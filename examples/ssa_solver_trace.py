"""Per-sweep SSA solver convergence trace on the synthetic-Greenland chain.

The reference logs its Picard iteration (nuH change per sweep) at high
verbosity; this is the equivalent instrument for the Newton-Picard solver:
after a short spin-up it runs one warm-started solve and prints, per Newton
sweep, the relative residual F2/b2, the relative velocity change, the
Eisenstat-Walker inner tolerance, the Krylov iteration count, the accepted
line-search alpha, and whether the Newton or the Picard-safeguard candidate
was taken. This is the tool that exposed the round-2 solver fixes (wasted
breakdown sweeps at an unreachable tolerance; over-tight warmup solves).

Usage: python examples/ssa_solver_trace.py [--km 5] [--platform gpu]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=5.0)
    ap.add_argument("--spin-years", type=float, default=10.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--config", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args()
    if args.platform:
        import jax
        from pism_tpu.cli import jax_platforms
        jax.config.update("jax_platforms", jax_platforms(args.platform))
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.ocean import Constant as OceanConstant
    from pism_tpu.coupler.pdd import TemperatureIndex
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.state import ModelState, new_geometry

    SPY = 3.15569259747e7
    Lx, Ly = 750e3, 1400e3
    dx = args.km * 1e3
    Mx, My = int(2 * Lx / dx) + 1, int(2 * Ly / dx) + 1
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
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
        "runtime.float_dtype": "float32",
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
    model = IceModel(grid=grid, config=cfg,
                     surface=TemperatureIndex(atmosphere=a, config=cfg),
                     ocean=OceanConstant(config=cfg))
    state = model.prepare_state(
        ModelState(geometry=new_geometry(jnp.asarray(H), jnp.asarray(bed))))
    state = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)

    tic = time.time()
    state, t, _ = model.step_once(state, 0.0, args.spin_years * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)
    print(f"grid {Mx}x{My}x41 @ {args.km} km; spin-up+compile "
          f"{time.time() - tic:.0f} s", flush=True)

    tau_c = model.yield_stress.compute(state)
    f = jax.jit(lambda s: model.ssa.solve(s, tau_c, diagnostics=True))
    u, v, info = f(state)
    jax.block_until_ready(u)
    tic = time.time()
    for _ in range(10):
        u, v, info = f(state)
    jax.block_until_ready(u)
    n = int(info["newton_iters"])
    tr = {k: np.asarray(x) for k, x in info["trace"].items()}
    print(f"warm solve: {(time.time() - tic) / 10 * 1e3:.1f} ms  "
          f"newton={n} krylov={int(info['krylov_iters'])} "
          f"F2/b2={float(info['F2_final'] / info['b_norm2']):.2e} "
          f"(tol {float(info['tol2'] / info['b_norm2']):.2e})")
    print(" it   F2/b2      chg2       eta     kryl  alpha  newton")
    for i in range(n):
        print(f"{i:3d}  {tr['F2_rel'][i]:9.3e}  {tr['chg2'][i]:9.3e}  "
              f"{tr['eta'][i]:8.2e}  {int(tr['krylov'][i]):4d}  "
              f"{tr['alpha'][i]:5.3f}  {int(tr['newton_taken'][i])}")


if __name__ == "__main__":
    main()
