"""float32-vs-float64 trajectory divergence on EISMINT II experiment A.

The repo's benchmark configuration runs float32 fields with the
mixed-precision SSA solve, while the parity north star implies float64.
This study quantifies what f32 costs in *trajectory* terms on a named,
published configuration: EISMINT II A (61x61x61, thermo-coupled SIA),
comparing volume / area / divide thickness / divide basal temperature
between dtypes at checkpoints along the run.

Usage:
  python examples/precision_study.py [--years 20000] [--seg 2000]
                                     [--platform cpu] [--mx 61]
Prints one JSON line per checkpoint per dtype plus a final summary of
relative divergences.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--years", type=float, default=20000.0)
    ap.add_argument("--seg", type=float, default=2000.0)
    ap.add_argument("--mx", type=int, default=61)
    ap.add_argument("--mz", type=int, default=61)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.physics.enthalpy_converter import EnthalpyConverter
    from pism_tpu.verification import eismint2

    SPY = 3.15569259747e7

    def run(dtype):
        es = eismint2.setup("A", Mx=args.mx, Mz=args.mz)
        es.config.update({"runtime.float_dtype": dtype})
        model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
        state = es.state
        if dtype == "float32":
            state = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.float32)
                if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
                state)
        EC = EnthalpyConverter.from_config(es.config)
        g = es.grid
        c = g.My // 2
        t = 0.0
        rows = []
        tic = time.time()
        while t < args.years * SPY - 1.0:
            state, t, _ = model.step_once(state, t, args.seg * SPY)
            H = np.asarray(state.geometry.ice_thickness, np.float64)
            Tb = float(EC.temperature(
                jnp.float64(state.enthalpy[c, c, 0]),
                jnp.float64(EC.pressure(state.geometry.ice_thickness[c, c]))))
            row = {"dtype": dtype, "t_a": float(t / SPY),
                   "volume_km3": float(H.sum() * g.dx * g.dy / 1e9),
                   "area_km2": float((H > 0.01).sum() * g.dx * g.dy / 1e6),
                   "divide_H_m": float(H[c, c]), "divide_Tb_K": Tb,
                   "wall_s": round(time.time() - tic, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        return rows

    r64 = run("float64")
    r32 = run("float32")
    summary = []
    for a, b in zip(r64, r32):
        summary.append({
            "t_a": a["t_a"],
            "rel_volume": abs(b["volume_km3"] - a["volume_km3"])
            / max(a["volume_km3"], 1e-12),
            "divide_H_diff_m": b["divide_H_m"] - a["divide_H_m"],
            "divide_Tb_diff_K": b["divide_Tb_K"] - a["divide_Tb_K"],
            "area_rel": abs(b["area_km2"] - a["area_km2"])
            / max(a["area_km2"], 1e-12),
        })
    print(json.dumps({"precision_divergence_eismint2A": summary}, indent=2))


if __name__ == "__main__":
    main()
