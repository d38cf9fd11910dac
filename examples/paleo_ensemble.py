"""Paleo-climate parameter ensemble (BASELINE config 5 analog).

The reference runs Antarctic paleo ensembles (Garbe-style hysteresis sweeps)
as independent MPI jobs driven by shell scripts; here the ensemble is ONE
SPMD program: members ride a vmapped leading axis of the state pytree and
shard over the "e" axis of a device mesh, while each
member's (y, x) fields can shard over the remaining axes (SURVEY.md §2.5).

Each member gets its own temperature offset dT and precipitation scaling
(exp(0.07 dT)), the standard paleo-forcing parameterization; members evolve
under a shared jitted adaptive-dt segment runner in lockstep.

Usage: python examples/paleo_ensemble.py [--members 16] [--years 500]
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
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--years", type=float, default=500.0)
    ap.add_argument("--km", type=float, default=40.0)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from pism_tpu import Config, Grid
    from pism_tpu.coupler.surface import FunctionSurface
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.parallel.ensemble import EnsembleRunner, broadcast_state
    from pism_tpu.parallel.mesh import make_mesh
    from pism_tpu.state import ModelState, new_geometry

    SPY = 3.15569259747e7
    dx = args.km * 1e3
    L = 800e3
    Mx = int(2 * L / dx) + 1
    grid = Grid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=21, Lz=4000.0)
    n = args.members
    print(f"{n} members on a {Mx} x {Mx} x 21 grid "
          f"({len(jax.devices())} devices)")

    cfg = Config({
        "stress_balance.model": "sia",
        "energy.model": "enthalpy",
        "runtime.float_dtype": "float32"
        if jax.devices()[0].platform != "cpu" else "float64",
    })

    # per-member forcing parameters ride on a broadcast helper field
    # (ice_area_specific_volume is unused in SIA-only runs): dT in [-8, +4] K
    dT_members = np.linspace(-8.0, 4.0, n)

    def smb_fn(geometry, t):
        dT = geometry.ice_area_specific_volume[0, 0]   # member parameter
        h = geometry.ice_surface_elevation
        T = 248.0 - 6.0e-3 * h + dT
        precip = 0.35 / SPY * jnp.exp(0.07 * dT)
        # crude height-desert + warming ablation
        melt = 1.0e-9 * jnp.maximum(T - 263.15, 0.0)
        smb = precip - melt
        return (jnp.broadcast_to(smb, h.shape),
                jnp.broadcast_to(jnp.minimum(T, 273.15), h.shape))

    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    H0 = np.where(r < 500e3, 2500.0 * (1 - (r / 600e3) ** 2), 0.0).clip(0)
    bed = 100.0 - 300.0 * (r / 800e3) ** 2
    geom = new_geometry(jnp.asarray(H0), jnp.asarray(bed))
    model = IceModel(grid=grid, config=cfg,
                     surface=FunctionSurface(fn=smb_fn))
    state0 = model.prepare_state(ModelState(geometry=geom))
    dtype = jnp.float32 if cfg.get_string("runtime.float_dtype") == "float32" \
        else jnp.float64
    state0 = jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state0)

    batched = broadcast_state(state0, n)
    # write the member parameter into the helper field
    Href = jnp.asarray(dT_members, dtype)[:, None, None] \
        * jnp.ones((n,) + grid.shape2, dtype)
    batched = batched.replace(
        geometry=batched.geometry.replace(ice_area_specific_volume=Href))

    runner = EnsembleRunner(model=model)
    ndev = len(jax.devices())
    if ndev > 1 and n % ndev == 0:
        mesh = make_mesh(jax.devices(), ensemble=ndev)
        batched = runner.shard(batched, mesh)
        print(f"sharded over e={ndev}")

    tic = time.time()
    out, stats = runner.run_segment(batched, 0.0, 50.0 * SPY)
    jax.block_until_ready(out.geometry.ice_thickness)
    print(f"compile+50y: {time.time() - tic:.0f} s")

    tic = time.time()
    out, stats = runner.run_segment(out, 50.0 * SPY, args.years * SPY)
    jax.block_until_ready(out.geometry.ice_thickness)
    wall = time.time() - tic

    vols = np.asarray(jnp.sum(out.geometry.ice_thickness, axis=(1, 2))) \
        * grid.dx * grid.dy / 1e15
    print(json.dumps({
        "members": n,
        "model_years": args.years,
        "wall_s": round(wall, 1),
        "member_years_per_hour": round(n * (args.years - 50.0) / wall * 3600.0, 1),
        "volume_range_1e6_km3": [round(float(vols.min()), 3),
                                 round(float(vols.max()), 3)],
        # physical sanity: warmer members (larger dT) should hold less ice
        "volume_dT_correlation": round(float(np.corrcoef(dT_members, vols)[0, 1]), 3),
    }))


if __name__ == "__main__":
    main()
