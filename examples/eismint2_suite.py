"""EISMINT II experiment suite (PISM ``pisms -eisII``; examples/ analog).

Runs experiment A from zero ice to (near) steady state, then the restart
experiments B (warming), C (drier), D (smaller ablation zone), E (sector
sliding patch), F (colder) from the A state, and the zero-start sliding /
topography experiments G, H, I, J, K, L — reporting the standard
EISMINT II table quantities (volume, area, divide thickness, divide basal
temperature; Payne et al. 2000).

Usage:
  python examples/eismint2_suite.py [--years 200000] [--mx 61] [--platform gpu]
  (--experiments A,...,L; restarts B-F need A in the list)
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
    ap.add_argument("--years", type=float, default=200000.0)
    ap.add_argument("--mx", type=int, default=61)
    ap.add_argument("--mz", type=int, default=61)
    ap.add_argument("--experiments", default="A,B,C,D")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args()

    if args.platform:
        import jax
        from pism_tpu.cli import jax_platforms
        jax.config.update("jax_platforms", jax_platforms(args.platform))
    import jax
    import jax.numpy as jnp

    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.physics.enthalpy_converter import EnthalpyConverter
    from pism_tpu.verification import eismint2

    SPY = 3.15569259747e7

    def report(name, es, state):
        H = np.asarray(state.geometry.ice_thickness)
        g = es.grid
        EC = EnthalpyConverter.from_config(es.config)
        c = g.My // 2
        Tb = float(EC.temperature(state.enthalpy[c, c + 0, 0],
                                  EC.pressure(state.geometry.ice_thickness[c, c])))
        icy = H > 0.01
        out = {
            "experiment": name,
            "volume_1e6_km3": float(H.sum() * g.dx * g.dy / 1e9 / 1e6),
            "area_1e6_km2": float(icy.sum() * g.dx * g.dy / 1e6 / 1e6),
            "divide_thickness_m": float(H[c, c]),
            "divide_basal_temp_K": Tb,
        }
        print(json.dumps(out), flush=True)
        return out

    results = {}
    exps = args.experiments.split(",")

    def to32(st):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, st)

    def evolve(exp, state0, label):
        es2 = eismint2.setup(exp, Mx=args.mx, Mz=args.mz)
        if args.float32:
            es2.config.update({"runtime.float_dtype": "float32"})
        model2 = IceModel(grid=es2.grid, config=es2.config,
                          surface=es2.surface, sliding_mu=es2.sliding_mu)
        st = state0 if state0 is not None else es2.state
        if args.float32:
            st = to32(st)
        t2 = 0.0
        tic = time.time()
        while t2 < args.years * SPY - 1.0:
            st, t2, stats = model2.step_once(st, t2, seg * SPY)
            print(f"{label}: t={t2 / SPY:9.0f} a  "
                  f"steps={int(stats.nsteps):7d} "
                  f"wall={time.time() - tic:7.0f} s", flush=True)
        return es2, st

    seg = 10000.0
    # experiment A from zero ice (the restart parent for B-F)
    es, state_A = evolve("A", None, "A")
    results["A"] = report("A", es, state_A)

    # warming/drier/margin/sector-sliding/colder restarts from A's steady
    # state (EISMINT II protocol); B-F keep A's flat bed
    for exp in [e for e in exps if e in ("B", "C", "D", "E", "F")]:
        es2, st = evolve(exp, state_A, exp)
        results[exp] = report(exp, es2, st)

    # sliding (G, H) and trough/mound topography (I-L) runs from zero ice
    for exp in [e for e in exps if e in ("G", "H", "I", "J", "K", "L")]:
        es2, st = evolve(exp, None, exp)
        results[exp] = report(exp, es2, st)

    print(json.dumps({"expected_A": eismint2.EXPECTED_A, "results": results},
                     indent=2))


if __name__ == "__main__":
    main()
