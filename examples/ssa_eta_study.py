"""Solver-schedule study for the warm-started SSA solve (5 km default).

Spins the synthetic-Greenland hybrid chain up ONCE, then measures the
warm-started SSA solve under several inner-tolerance schedules and drag
Jacobian options on the SAME state.  This is the experiment behind the
round-3 solver defaults: the per-sweep convergence trace
(examples/ssa_solver_trace.py) showed the warm solve spending ~18 sweeps
at eta_max-loose inner tolerance, with the per-sweep FIXED cost
(linearize + high-precision residual + preconditioner build) dominating
the Krylov work - so an endgame that requests one tight inner solve when
the target is in reach should beat many loose sweeps.

Usage: python examples/ssa_eta_study.py [--km 5] [--spin-years 10]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import time


VARIANTS = [
    ("baseline (eta_max 0.3, frozen beta)", {}),
    ("endgame range 100", {"stress_balance.ssa.fd.eta_endgame_range": 100.0}),
    ("endgame 100 + f32 solve", {
        "stress_balance.ssa.fd.eta_endgame_range": 100.0,
        "stress_balance.ssa.fd.solve_dtype": "float32"}),
    ("endgame 100 + linemg", {
        "stress_balance.ssa.fd.eta_endgame_range": 100.0,
        "stress_balance.ssa.fd.preconditioner": "linemg"}),
    ("endgame 100 + eta_max 0.15", {
        "stress_balance.ssa.fd.eta_endgame_range": 100.0,
        "stress_balance.ssa.fd.ksp_rtol_max": 0.15}),
    ("endgame range 300", {"stress_balance.ssa.fd.eta_endgame_range": 300.0}),
    ("f32 solve only", {"stress_balance.ssa.fd.solve_dtype": "float32"}),
]

# third sweep: warmup-skip threshold sensitivity on a state spun under the
# round-3 defaults (auto -> f32 carry)
VARIANTS_SKIP = [
    ("auto, skip 0.5 (default)", {}),
    ("auto, skip 0.1", {"stress_balance.ssa.fd.warmup_skip_rtol": 0.1}),
    ("auto, skip 0.02", {"stress_balance.ssa.fd.warmup_skip_rtol": 0.02}),
    ("auto, never skip", {"stress_balance.ssa.fd.warmup_skip_rtol": 0.0}),
    ("mixed, skip 0.5", {"stress_balance.ssa.fd.solve_dtype": "mixed"}),
]

# round-3 first sweep (warm 5 km state; Newton sweeps / Krylov iterations):
#   baseline (eta_max 0.3, frozen beta)    newton=18 krylov=75
#   eta_max 0.05                           newton=17 krylov=304
#   endgame range 100                      newton=12 krylov=92
#   endgame range 1e3                      newton=18 krylov=209
#   endgame range 1e6                      newton=13 krylov=293
#   exact drag J                           newton=13 krylov=221
#   exact + endgame 1e3                    newton=10 krylov=459
# -> outer contraction is floored at ~0.5/sweep by the frozen-beta
#    linearization (tight inner solves do NOT cut sweeps), so the winning
#    strategy is loose-eta sweeps with a short tightened endgame.


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=5.0)
    ap.add_argument("--spin-years", type=float, default=10.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--state-cache", default=None,
                    help="pickle path: load the spun state if present, "
                    "else spin and save (skips the ~15 min 5 km spin-up)")
    ap.add_argument("--skip-study", action="store_true",
                    help="run the warmup-skip threshold variants instead")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
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

    def make_cfg(extra):
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
        cfg.update(extra)
        return cfg

    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY

    def make_model(cfg):
        a = atm.SeariseGreenland(latitude=jnp.asarray(lat),
                                 longitude=jnp.asarray(lon),
                                 precipitation=jnp.asarray(precip))
        return IceModel(grid=grid, config=cfg,
                        surface=TemperatureIndex(atmosphere=a, config=cfg),
                        ocean=OceanConstant(config=cfg))

    base = make_model(make_cfg({}))
    cache = args.state_cache
    if cache and __import__("os").path.exists(cache):
        import pickle
        with open(cache, "rb") as fh:
            tree = pickle.load(fh)
        state = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x) if hasattr(x, "dtype") else x, tree)
        print(f"grid {Mx}x{My}x41 @ {args.km} km; spun state from {cache}",
              flush=True)
    else:
        state = base.prepare_state(
            ModelState(geometry=new_geometry(jnp.asarray(H),
                                             jnp.asarray(bed))))
        state = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)
        tic = time.time()
        state, t, _ = base.step_once(state, 0.0, args.spin_years * SPY)
        jax.block_until_ready(state.geometry.ice_thickness)
        print(f"grid {Mx}x{My}x41 @ {args.km} km; spin-up+compile "
              f"{time.time() - tic:.0f} s", flush=True)
        if cache:
            import pickle
            tree = jax.tree_util.tree_map(
                lambda x: np.asarray(x) if hasattr(x, "dtype") else x, state)
            with open(cache, "wb") as fh:
                pickle.dump(tree, fh)
    tau_c = base.yield_stress.compute(state)

    variants = VARIANTS_SKIP if args.skip_study else VARIANTS
    print(f"{'variant':34s} {'ms':>7s} {'newton':>6s} {'krylov':>6s} "
          f"{'F2/b2':>9s} {'F2w/b2':>9s}")
    for name, extra in variants:
        model = make_model(make_cfg(extra))
        f = jax.jit(lambda s, m=model: m.ssa.solve(s, tau_c,
                                                   diagnostics=True))
        u, v, info = f(state)           # compile
        jax.block_until_ready(u)
        tic = time.time()
        for _ in range(args.reps):
            u, v, info = f(state)
        jax.block_until_ready(u)
        ms = (time.time() - tic) / args.reps * 1e3
        warm = info.get("F2_warmstart")
        print(f"{name:34s} {ms:7.1f} {int(info['newton_iters']):6d} "
              f"{int(info['krylov_iters']):6d} "
              f"{float(info['F2_final'] / info['b_norm2']):9.2e} "
              f"{float(warm / info['b_norm2']):9.2e}" if warm is not None
              else f"{name:34s} {ms:7.1f}", flush=True)


if __name__ == "__main__":
    main()
