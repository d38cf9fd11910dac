"""ISMIP-HOM higher-order intercomparison experiments A and C on the
Blatter-Pattyn solver (reference role: the Blatter verification/validation
suite; Pattyn et al. 2008).

Experiment A: no-slip flow over sinusoidal basal bumps,
    zb = zs - 1000 + 500 sin(wx) sin(wy),  zs tilted 0.5 degrees.
Experiment C: sliding flow over a flat bed with a sinusoidal linear
friction coefficient,
    beta2 = 1000 + 1000 sin(wx) sin(wy)  [Pa a m-1],  tilt 0.1 degrees.

Both are solved in the mean-slope frame (flat surface + prescribed driving
stress, bed bumps absorbed into the thickness), periodic over the domain
length L. The standard intercomparison output is the surface velocity
along y = L/4. At L = 160 km experiment A approaches the SIA limit —
the script reports the ratio against the analytic SIA surface velocity as
a built-in sanity band (the published model spread is not available in
this offline environment).

Usage: python examples/ismip_hom.py [--exp A|C] [--L 5,10,20,40,80,160]
           [--Mx 40] [--Mz 16]
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
RHO, G = 910.0, 9.81
A_GLEN = 1e-16 / SPY     # Pa^-3 s^-1 (ISMIP-HOM value)


def run_one(exp, L_km, Mx, Mz):
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.model.blatter import BlatterSolver
    from pism_tpu.physics.rheology import IsothermalGlen
    from pism_tpu.state import ModelState, new_geometry

    L = L_km * 1e3
    H0 = 1000.0
    alpha = np.deg2rad(0.5 if exp == "A" else 0.1)
    grid = Grid(Mx=Mx, My=Mx, Lx=L / 2, Ly=L / 2, Mz=Mz, Lz=2000.0,
                vertical_spacing="equal", periodicity="xy")
    # periodic wrap length is Mx*dx; use its wavenumber so the fields are
    # exactly periodic on the grid
    w = 2.0 * np.pi / (Mx * grid.dx)
    X, Y = np.meshgrid(grid.x, grid.y)
    law = IsothermalGlen(A=A_GLEN)
    cfg = Config({"basal_resistance.plastic.regularization": 1e-4,
                  "basal_resistance.pseudo_plastic.enabled": exp == "C",
                  "basal_resistance.pseudo_plastic.q": 1.0,
                  "basal_resistance.pseudo_plastic.u_threshold": 100.0})

    if exp == "A":
        H = H0 - 500.0 * np.sin(w * X) * np.sin(w * Y)
        tau_c = jnp.full(grid.shape2, 1e8)          # no slip
    else:
        H = np.full(grid.shape2, H0)
        beta2 = (1000.0 + 1000.0 * np.sin(w * X) * np.sin(w * Y)) * SPY
        # pseudo-plastic with q=1: beta = tau_c / u_threshold
        u_thr = 100.0 / SPY
        tau_c = jnp.asarray(beta2 * u_thr)

    # mean-slope frame: flat surface at 2000 m, bumps in the bed/thickness
    bed = 2000.0 - H
    geom = new_geometry(jnp.asarray(H), jnp.asarray(bed))
    taud = RHO * G * np.asarray(H) * np.tan(alpha)
    solver = BlatterSolver(grid=grid, config=cfg, flow_law=law,
                           taud_x=jnp.asarray(taud),
                           taud_y=jnp.zeros(grid.shape2))
    u, v, info = solver.solve(ModelState(geometry=geom), tau_c,
                              diagnostics=True)
    u = np.asarray(u) * SPY

    # surface velocity along the standard transect y = L/4
    jrow = int(round(Mx * 0.75)) % Mx               # y = +L/4 from center
    us = u[jrow, :, -1]
    out = {"L_km": L_km, "umin": round(float(us.min()), 2),
           "umax": round(float(us.max()), 2),
           "umean": round(float(us.mean()), 2),
           "newton_iters": int(info["newton_iters"])}
    if exp == "A":
        # SIA limit check: u_sfc = 2A/(n+1) (rho g sin a)^n H^(n+1) + 0
        Hrow = np.asarray(H)[jrow, :]
        u_sia = 2.0 * A_GLEN / 4.0 * (RHO * G * np.sin(alpha)) ** 3 \
            * Hrow ** 4 * SPY
        out["max_over_sia"] = round(float(us.max() / u_sia.max()), 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="A", choices=("A", "C"))
    ap.add_argument("--L", default="5,10,20,40,80,160")
    ap.add_argument("--Mx", type=int, default=40)
    ap.add_argument("--Mz", type=int, default=16)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    print(f"ISMIP-HOM experiment {args.exp} (Blatter-Pattyn, "
          f"{args.Mx}x{args.Mx}x{args.Mz}, surface transect y = L/4)")
    for L_km in (float(s) for s in args.L.split(",")):
        print(json.dumps(run_one(args.exp, L_km, args.Mx, args.Mz)))


if __name__ == "__main__":
    main()
