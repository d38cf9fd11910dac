"""Ice-sheet hysteresis sweep (Garbe et al. 2020 role: "The hysteresis of
the Antarctic Ice Sheet", the reference fork's signature experiment).

A synthetic marine ice sheet is equilibrated under a ramp of uniform
warming offsets applied to BOTH the surface climate (PDD melt via the
atmosphere delta_T) and the sub-shelf ocean (ocean delta_T), first
upward then back down. The retreat and readvance branches of the
volume-vs-forcing curve separate when marine-instability thresholds are
crossed — the hysteresis gap this experiment family quantifies.

Defaults are sized for a quick demonstration (coarse grid, short
equilibration); production sweeps raise --years-per-level into the
multi-millennial range and run one ensemble member per device
(`parallel/ensemble.py`).

Usage: python examples/hysteresis.py [--km 50] [--years-per-level 1500]
           [--dT-max 8] [--levels 5] [--float32]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import json

import numpy as np

SPY = 3.15569259747e7


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=50.0)
    ap.add_argument("--years-per-level", type=float, default=1500.0)
    ap.add_argument("--dT-max", type=float, default=8.0)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.ocean import PIK, DeltaT as OceanDeltaT
    from pism_tpu.coupler.pdd import TemperatureIndex
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.state import ModelState, new_geometry

    dx = args.km * 1e3
    L = 800e3
    M = int(2 * L / dx) + 1
    grid = Grid(Mx=M, My=M, Lx=L, Ly=L, Mz=21, Lz=4500.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "none",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving,float_kill",
        "geometry.remove_icebergs": True,
        "runtime.float_dtype": "float32" if args.float32 else "float64",
        "runtime.device_loop": True,
    })

    # marine bed: interior above sea level, deepening outward (MISMIP-like
    # overdeepening band where the grounding line can jump)
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    bed = 500.0 - 1.3e-3 * r + 250.0 * np.sin(np.pi * r / 500e3)
    H = np.maximum(3200.0 * (1.0 - (r / 650e3) ** 2), 0.0) * (bed > -800.0)

    state0 = ModelState(geometry=new_geometry(jnp.asarray(H),
                                              jnp.asarray(bed)))

    def build_model(dT):
        a = atm.DeltaT(
            inner=atm.ElevationChange(
                inner=atm.Uniform(temperature=252.15, temperature_july=263.15,
                                  precipitation=0.25 / SPY),
                reference_surface=jnp.zeros(grid.shape2), lapse_rate=8e-3),
            offset=lambda t, d=dT: d)
        surface = TemperatureIndex(atmosphere=a, config=cfg)
        ocean = OceanDeltaT(inner=PIK(config=cfg),
                            offset=lambda t, d=dT: 0.25 * d)
        return IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean)

    dTs_up = list(np.linspace(0.0, args.dT_max, args.levels))
    dTs = dTs_up + dTs_up[-2::-1]
    state = build_model(0.0).prepare_state(state0)
    if args.float32:
        state = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)

    t = 0.0
    results = []
    for i, dT in enumerate(dTs):
        model = build_model(float(dT))
        state, t, stats = model.step_once(state, t, t + args.years_per_level
                                          * SPY)
        vol = float(jnp.sum(state.geometry.ice_thickness)
                    * grid.dx * grid.dy / 1e15)
        branch = "up" if i < len(dTs_up) else "down"
        results.append({"dT": round(float(dT), 2), "branch": branch,
                        "volume_1e6_km3": round(vol, 4),
                        "steps": int(stats.nsteps)})
        print(json.dumps(results[-1]), flush=True)

    # hysteresis gap: volume difference between branches at matching dT
    up = {r["dT"]: r["volume_1e6_km3"] for r in results if r["branch"] == "up"}
    down = {r["dT"]: r["volume_1e6_km3"]
            for r in results if r["branch"] == "down"}
    gaps = {dT: round(up[dT] - down[dT], 4) for dT in down if dT in up}
    print(json.dumps({"hysteresis_gap_by_dT": gaps}))


if __name__ == "__main__":
    main()
