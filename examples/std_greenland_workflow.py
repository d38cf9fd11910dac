"""PISM ``examples/std-greenland`` tutorial workflow, end to end via the CLI.

The reference's flagship tutorial (PISM manual "Getting started": the
``spinup.sh`` G20km runs) bootstraps from the SeaRISE Greenland dataset and
spins up in stages, each restarting from the previous NetCDF output:

  1. bootstrap + short SIA smoothing run           (``-bootstrap -y 100``)
  2. no-mass-continuity thermal evolution          (``-no_mass -y 500``)
  3. full hybrid SSA+SIA pseudo-plastic spinup     (``-stress_balance
     ssa+sia -pseudo_plastic ... -skip -skip_max 10``)

The real dataset (``pism_Greenland_5km_v1.1.nc``) is not available offline
(zero egress), so stage 0 synthesizes a Greenland-scale bootstrap file with
the same variables (thk, topg, precipitation, ice_surface_temp, lat, lon)
and the whole chain then runs through ``python -m pism_tpu`` exactly like
the tutorial: ``-atmosphere searise_greenland`` takes lat/lon/precipitation
from the bootstrap file, ``-surface pdd`` melts with the Calov-Greve
scheme, and every stage restarts from the previous stage's output file.

Usage: python examples/std_greenland_workflow.py [--km 20] [--quick]
                                                 [--workdir DIR]
"""

import argparse
import json
import os as _os
import sys as _sys
import time

import numpy as np

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()


def synthesize_bootstrap_file(path, km):
    """Greenland-scale synthetic input with the SeaRISE variable set."""
    from pism_tpu.io.nc4 import File

    Lx, Ly = 750e3, 1400e3
    nx = int(2 * Lx / (km * 1e3)) + 1
    ny = int(2 * Ly / (km * 1e3)) + 1
    x = np.linspace(-Lx, Lx, nx)
    y = np.linspace(-Ly, Ly, ny)
    X, Y = np.meshgrid(x, y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    thk = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0          # 60N..83N
    lon = -45.0 + X / (111e3 * np.cos(np.radians(72.0)))
    # precipitation: wetter in the (warmer) south, drier interior north
    precip = (1500.0 - 1100.0 * (lat - 60.0) / 23.0) * np.exp(
        -np.maximum(bed + thk, 0.0) / 2500.0)        # kg m-2 year-1
    t_sfc = 273.15 + 30.0 - 0.85 * (lat - 60.0) \
        - 0.0075 * np.maximum(bed + thk, 0.0)        # lapse + latitude

    with File(path, "w") as f:
        f.define_dimension("y", ny, y, attrs={"units": "m"})
        f.define_dimension("x", nx, x, attrs={"units": "m"})
        f.write("thk", thk, ("y", "x"), {"units": "m"})
        f.write("topg", bed, ("y", "x"), {"units": "m"})
        f.write("precipitation", precip, ("y", "x"),
                {"units": "kg m-2 year-1"})
        f.write("ice_surface_temp", np.minimum(t_sfc, 273.15), ("y", "x"),
                {"units": "K"})
        f.write("lat", lat, ("y", "x"), {"units": "degree_north"})
        f.write("lon", lon, ("y", "x"), {"units": "degree_east"})
    return nx, ny


def volume_of(path):
    from pism_tpu.io.nc4 import File
    with File(path, "r") as f:
        thk = np.asarray(f.read("thk"), float)
        if thk.ndim == 3:
            thk = thk[-1]
        x = np.asarray(f.read("x"), float)
        y = np.asarray(f.read("y"), float)
    dx, dy = x[1] - x[0], y[1] - y[0]
    return float(np.nan_to_num(thk).sum() * dx * dy / 1e9), thk


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=20.0)
    ap.add_argument("--quick", action="store_true",
                    help="tiny stage lengths (smoke/CI)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from pism_tpu import cli

    work = args.workdir or f"std_greenland_{args.km:g}km"
    _os.makedirs(work, exist_ok=True)
    boot = _os.path.join(work, "g_boot.nc")
    pre = _os.path.join(work, "g_pre.nc")
    nomass = _os.path.join(work, "g_nomass.nc")
    spun = _os.path.join(work, "g_spunup.nc")

    y1, y2, y3 = (2.0, 5.0, 5.0) if args.quick else (100.0, 500.0, 200.0)
    nx, ny = synthesize_bootstrap_file(boot, args.km)
    print(f"bootstrap file: {boot} ({nx} x {ny} @ {args.km:g} km)")
    tic = time.time()

    common = ["-atmosphere", "searise_greenland", "-surface", "pdd",
              "-config", "runtime.float_dtype=float32", "-verbose", "1",
              # restart stages re-read the parameterization inputs
              # (lat/lon/precipitation) from the original data file, like
              # the tutorial's run script passing $PISM_DATANAME each stage
              "-config", f"atmosphere.searise_greenland.file={boot}"]

    # stage 1: bootstrap + SIA smoothing run (tutorial: -y 100)
    rc = cli.main(["-i", boot, "-bootstrap",
                   "-Mx", str(nx), "-My", str(ny), "-Mz", "41",
                   "-Lz", "4000",
                   "-stress_balance", "sia",
                   "-y", str(y1), "-o", pre] + common)
    assert rc == 0, "stage 1 (bootstrap smoothing) failed"
    v1, _ = volume_of(pre)
    print(f"stage 1 (smoothing {y1:g} a):        volume {v1:10.1f} km^3")

    # stage 2: thermal evolution with fixed geometry (tutorial -no_mass)
    rc = cli.main(["-i", pre, "-y", str(y2), "-o", nomass,
                   "-config", "geometry.update.enabled=false"] + common)
    assert rc == 0, "stage 2 (no-mass thermal) failed"
    v2, _ = volume_of(nomass)
    print(f"stage 2 (no-mass thermal {y2:g} a):  volume {v2:10.1f} km^3")

    # stage 3: full hybrid pseudo-plastic spinup (tutorial G20km run)
    rc = cli.main(["-i", nomass, "-y", str(y3), "-o", spun,
                   "-stress_balance", "ssa+sia",
                   "-pseudo_plastic", "-pseudo_plastic_q", "0.25",
                   "-skip", "-skip_max", "10",
                   "-config", "geometry.update.enabled=true"] + common)
    assert rc == 0, "stage 3 (hybrid spinup) failed"
    v3, thk = volume_of(spun)
    print(f"stage 3 (hybrid spinup {y3:g} a):    volume {v3:10.1f} km^3")

    ok = (np.isfinite(thk).all() and v3 > 0.2 * v1
          and abs(v2 - v1) < 0.02 * v1)   # no-mass must not move mass
    print(json.dumps({
        "workflow": "std-greenland (synthetic)", "km": args.km,
        "stages_years": [y1, y2, y3],
        "volumes_km3": [round(v1, 1), round(v2, 1), round(v3, 1)],
        "wall_s": round(time.time() - tic, 1), "ok": bool(ok),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
