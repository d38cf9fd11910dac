"""A/B solver study at the 5 km north-star shape (VERDICT r5 perf lever):
measures ms/step of the bench's synthetic-Greenland hybrid chain for a list
of config variants (warm window, best-of-3 reps like bench.py).

Usage:
  python examples/ssa_ab_study.py --km 5 --years 2 \
      --variant base \
      --variant extrap=stress_balance.ssa.fd.extrapolate_initial_guess=True \
      --variant linemg=stress_balance.ssa.fd.preconditioner=linemg
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=5.0)
    ap.add_argument("--years", type=float, default=2.0)
    ap.add_argument("--warm-years", type=float, default=3.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[],
                    help="name[=key=val[,key=val...]]")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax

    import bench

    SPY = bench.SPY
    results = {}
    for spec in (args.variant or ["base"]):
        name, _, ov = spec.partition("=")
        extra = {}
        if ov:
            for pair in ov.split(","):
                k, _, v = pair.partition("=")
                if v in ("True", "False"):
                    vv = v == "True"
                else:
                    try:
                        vv = float(v)
                    except ValueError:
                        vv = v
                extra[k] = vv
        model, state, grid = bench.hybrid_greenland_model(
            "float32", km=args.km, extra_cfg=extra)
        state, t, _ = model.step_once(state, 0.0, args.warm_years * SPY)
        jax.block_until_ready(state.geometry.ice_thickness)
        state0, t0 = state, t
        best, walls, nsteps = None, [], 0
        vol = None
        for _ in range(args.reps):
            state, t = state0, t0
            tic = time.time()
            nsteps = 0
            t_end = t + args.years * SPY
            while t < t_end - 1.0:
                state, t, st = model.step_once(state, t,
                                               min(10.0 * SPY, t_end - t))
                nsteps += int(st.nsteps)
            jax.block_until_ready(state.geometry.ice_thickness)
            wall = time.time() - tic
            walls.append(round(wall, 3))
            if best is None or wall < best:
                best = wall
            import jax.numpy as jnp
            vol = float(jnp.sum(state.geometry.ice_thickness))
        results[name] = {
            "ms_per_step": round(best / max(nsteps, 1) * 1e3, 1),
            "steps": nsteps, "walls_s": walls,
            "volume_sum": vol,
        }
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps({"study": "ssa_ab", "km": args.km,
                      "years": args.years, "results": results}))


if __name__ == "__main__":
    main()
