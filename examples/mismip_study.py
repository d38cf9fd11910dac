"""MISMIP grounding-line resolution study.

Runs MISMIP experiment-1-style steady states at several resolutions, with
and without sub-grid grounding-line friction scaling
(``geometry.grounded_cell_fraction``; Feldmann et al. 2014 / Gladstone
sub-grid interpolation), and compares the steady grounding-line position to
the Schoof (2007) boundary-layer semi-analytic target: the x where the
integrated accumulation flux a*x equals the boundary-layer flux
q(H_f(x)) on the linear bed. This is the quantitative study behind the
"GL over-advances at coarse resolution" known-gap note (the reference runs
the same study via examples/mismip run scripts).

Usage: python examples/mismip_study.py [--km 25,12.5] [--years 20000]
       [--platform cpu]
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


def semianalytic_gl():
    """x where accumulation flux a*x = Schoof q(flotation thickness)."""
    from pism_tpu.verification import mismip

    def f(x):
        b = mismip.bed_elevation_linear(x)
        H_f = mismip.RHO_W / mismip.RHO_I * np.maximum(-b, 0.0)
        return mismip.ACCUMULATION * x - mismip.schoof_gl_flux(H_f)

    lo, hi = 700e3, 1490e3
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(lo) * f(mid) <= 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def run_one(km, years, subgl):
    import jax.numpy as jnp
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.verification import mismip

    Mx = int(2 * 1500e3 / (km * 1e3)) + 1
    ms = mismip.setup(Mx=Mx, My=5)
    ms.config.update({
        "time_stepping.skip.enabled": True,
        "time_stepping.skip.max": 10,
        "geometry.grounded_cell_fraction": bool(subgl),
    })
    model = IceModel(grid=ms.grid, config=ms.config, surface=ms.surface,
                     calving=ms.calving)
    state = model.prepare_state(ms.state)
    t = 0.0
    # advance in 2 kyr segments (keeps single while_loop compilations sane)
    while t < years * SPY - 1.0:
        state, t, _ = model.step_once(state, t, 2000.0 * SPY)
    gl = mismip.grounding_line_position(state.geometry, ms.grid)
    # sub-grid refinement of the reported position from the grounded
    # fraction of the first partly-grounded cell
    gf = np.asarray(state.geometry.cell_grounded_fraction)
    x = np.asarray(ms.grid.x)
    c = gf.shape[0] // 2
    i = int(np.argmin(np.abs(x - gl)))
    if i + 1 < x.size:
        gl_sub = gl + float(gf[c, i + 1]) * (x[1] - x[0])
    else:
        gl_sub = gl
    return gl, gl_sub


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", default="25,12.5")
    ap.add_argument("--years", type=float, default=20000.0)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    target = semianalytic_gl()
    print(json.dumps({"schoof_semianalytic_gl_km": round(target / 1e3, 1)}),
          flush=True)
    for km in [float(s) for s in args.km.split(",")]:
        for subgl in (False, True):
            gl, gl_sub = run_one(km, args.years, subgl)
            print(json.dumps({
                "dx_km": km, "subgl_friction": subgl,
                "gl_km": round(gl / 1e3, 1),
                "gl_subgrid_km": round(gl_sub / 1e3, 1),
                "error_km": round((gl_sub - target) / 1e3, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
