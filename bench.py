"""Benchmark harness: throughput of the model on one GPU.

Measures two throughputs and reports the flagship one:

1. PRIMARY — the BASELINE north-star configuration: Greenland-scale hybrid
   SSA+SIA with enthalpy thermodynamics, PDD surface model, Mohr-Coulomb
   basal strength (the ``examples/std-greenland`` model chain on a synthetic
   20 km geometry; the real SeaRISE dataset is not available offline), as
   model-years per wall-hour. Runs fully on device (adaptive-dt
   lax.while_loop segments; zero host sync inside a segment) in float32
   with the pure-f32 production SSA solve.
2. SECONDARY (in detail) — EISMINT II experiment A, thermomechanically
   coupled SIA on a 61x61x61 grid (the CPU-runnable reference config),
   plus the 5 km north-star shape (301x561x41).

Baseline provenance: the reference mount is empty and
BASELINE.json.published is {}. BASELINE.md records (from-memory,
unverified) that 64-rank MPI PISM sustains order 1e3-1e4 model-years/hour
on 5-20 km Greenland grids; we take 3,000 model-years/wall-hour as the
indicative 64-rank 20 km baseline (PISM manual-scale numbers), so
vs_baseline is measured/3000 with that caveat.

Every emitted JSON carries the git commit measured ("commit") and the
device it ran on. With no GPU visible the harness exits non-zero and
prints no result: a CPU number is not a device measurement.

``python bench.py --smoke`` runs the large-shape smoke gate (one warm
multi-step segment at 20 and 5 km) — run it before any perf-affecting
commit; the round-3 regression crashed the device runtime only on
multi-step segments at 5/10 km and was invisible to the test suite.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
"""

import json
import subprocess
import sys
import time

from pism_tpu.util.compile_cache import enable_compile_cache

enable_compile_cache()

BASELINE_HYBRID_MODEL_YEARS_PER_HOUR = 3.0e3   # indicative 64-rank PISM, 20 km
BASELINE_SIA_MODEL_YEARS_PER_HOUR = 1.2e6      # 1-core PISM EISMINT II estimate
SPY = 3.15569259747e7


def git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True,
                              cwd=__file__.rsplit("/", 1)[0] or ".",
                              timeout=10).stdout.strip()
    except Exception:   # noqa: BLE001
        return "unknown"


def _to_f32(state):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x, state)


def _dt_detail(stats, years, wall):
    """steps/yr + dt stats + binding-limit counts."""
    d = {
        "steps_per_model_year": round(int(stats.nsteps) / max(years, 1e-9), 2),
        "dt_min_days": round(float(stats.dt_min) / 86400.0, 4),
        "dt_mean_days": round(
            years * SPY / max(int(stats.nsteps), 1) / 86400.0, 4),
        "dt_max_days": round(float(stats.dt_max) / 86400.0, 4),
    }
    if hasattr(stats, "limit_hits_dict"):
        d["dt_limit_hits"] = stats.limit_hits_dict()
    return d


def bench_eismint_sia(dtype):
    import jax
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.verification import eismint2

    es = eismint2.setup("A", Mx=61, Mz=61, Lz=5000.0)
    es.config.update({"runtime.float_dtype": dtype})
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
    state = es.state if dtype == "float64" else _to_f32(es.state)

    # warm up: compile + spin into the diffusivity-limited dt regime
    state, t, _ = model.step_once(state, 0.0, 5000.0 * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)

    years = 2000.0
    state0, t0 = state, t
    best, walls = None, []
    for _ in range(3):   # best-of-3 of the same window (see hybrid bench)
        tic = time.time()
        state, t, stats = model.step_once(state0, t0, years * SPY)
        jax.block_until_ready(state.geometry.ice_thickness)
        wall = time.time() - tic
        walls.append(round(wall, 3))
        if best is None or wall < best[0]:
            best = (wall, stats)
    wall, stats = best
    nsteps = int(stats.nsteps)
    cells = es.grid.Mx * es.grid.My * es.grid.Mz
    return {
        "model_years_per_hour": round(years / wall * 3600.0, 1),
        "steps": nsteps,
        "wall_s": round(wall, 3),
        "rep_walls_s": walls,
        "cell_updates_per_s": round(nsteps * cells / wall, 0),
        **_dt_detail(stats, years, wall),
    }


def hybrid_greenland_model(dtype, km=20.0, mesh=None, extra_cfg=None):
    """The north-star synthetic-Greenland hybrid chain (model + initial
    state), shared by the bench, the smoke gate, and the dt studies.

    ``mesh``: a ("y", "x") jax.sharding.Mesh the caller will shard the
    state over. JAX explicit shardings need grid dims divisible by the mesh
    (the DMDA-ownership analog), so My/Mx are rounded UP to mesh multiples
    (a row/column of extra ocean at the domain edge)."""
    import jax.numpy as jnp
    import numpy as np
    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.pdd import TemperatureIndex
    from pism_tpu.coupler.ocean import Constant as OceanConstant
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.state import ModelState, new_geometry

    Lx, Ly = 750e3, 1400e3
    Mx = int(2 * Lx / (km * 1e3)) + 1
    My = int(2 * Ly / (km * 1e3)) + 1
    if mesh is not None:
        ny, nx = mesh.shape["y"], mesh.shape["x"]
        My += (-My) % ny
        Mx += (-Mx) % nx
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": 0.25,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": True,
        "time_stepping.skip.max": 10,
        "runtime.float_dtype": dtype,
        "runtime.device_loop": True,
    })
    if extra_cfg:
        cfg.update(extra_cfg)

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
    surface = TemperatureIndex(atmosphere=a, config=cfg)
    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=OceanConstant(config=cfg))
    state = model.prepare_state(ModelState(geometry=new_geometry(
        jnp.asarray(H), jnp.asarray(bed))))
    if dtype == "float32":
        state = _to_f32(state)
    return model, state, grid


def bench_hybrid_greenland(dtype, years=50.0, km=20.0, warm_years=10.0,
                           extra_cfg=None):
    import jax

    model, state, grid = hybrid_greenland_model(dtype, km=km,
                                                extra_cfg=extra_cfg)

    # warm up: compile + let the fronts/dt settle
    state, t, _ = model.step_once(state, 0.0, warm_years * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)

    years = float(years)
    # best-of-3 of the SAME measured window (each rep restarts from the
    # post-warmup snapshot, so all reps are identical work). All rep walls
    # are recorded so the JSON carries the variance alongside the best rep.
    state0, t0 = state, t
    best, walls = None, []
    for _ in range(3):
        state, t = state0, t0
        tic = time.time()
        nsteps = 0
        seg_stats = None
        t_end = t + years * SPY
        while t < t_end - 1.0:
            # 10-year dispatches: the host regains control between them
            state, t, stats = model.step_once(state, t, min(10.0 * SPY,
                                                            t_end - t))
            nsteps += int(stats.nsteps)
            from pism_tpu.model.icemodel import _merge_stats
            seg_stats = _merge_stats(seg_stats, stats)
        jax.block_until_ready(state.geometry.ice_thickness)
        wall = time.time() - tic
        walls.append(round(wall, 3))
        if best is None or wall < best[0]:
            best = (wall, nsteps, seg_stats)
    wall, nsteps, stats = best
    return {
        "model_years_per_hour": round(years / wall * 3600.0, 1),
        "steps": nsteps,
        "wall_s": round(wall, 3),
        "rep_walls_s": walls,
        "grid": f"{grid.Mx}x{grid.My}x41 @ {km:.0f} km",
        **_dt_detail(stats, years, wall),
    }


def require_gpu():
    """The measured device; exits non-zero (printing no result) when JAX
    finds no GPU — there is no CPU fallback."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU visible (JAX platform {dev.platform!r}); "
              "refusing to report a CPU run as a device measurement",
              file=sys.stderr)
        sys.exit(1)
    return dev


def smoke():
    """Large-shape smoke gate: one warm multi-step segment at 20 km and
    5 km. The round-3 regression (traced Krylov bound) crashed the device
    runtime only in this mode; the suite and single steps stayed green."""
    import jax

    require_gpu()

    results = {}
    ok = True
    for km, years in ((20.0, 5.0), (5.0, 0.25)):
        try:
            model, state, grid = hybrid_greenland_model("float32", km=km)
            tic = time.time()
            t = 0.0
            nsteps = 0
            for _ in range(2):   # two dispatches: multi-step + donation reuse
                state, t, stats = model.step_once(state, t, years / 2 * SPY)
                nsteps += int(stats.nsteps)
            jax.block_until_ready(state.geometry.ice_thickness)
            import jax.numpy as jnp
            assert bool(jnp.isfinite(state.geometry.ice_thickness).all())
            results[f"{km:g}km"] = {"steps": nsteps,
                                    "wall_s": round(time.time() - tic, 2)}
        except Exception as e:   # noqa: BLE001
            results[f"{km:g}km"] = {"error": repr(e)[:500]}
            ok = False
    out = {"smoke": "ok" if ok else "FAIL", "commit": git_commit(),
           "platform": jax.devices()[0].platform, "results": results}
    print(json.dumps(out))
    return 0 if ok else 1


def main():
    if "--smoke" in sys.argv:
        return smoke()
    import jax

    dev = require_gpu()
    dtype = "float32"

    hybrid = bench_hybrid_greenland(dtype, years=50.0)
    sia = bench_eismint_sia(dtype)
    # the 5 km north-star grid (301x561x41): short measured window — the
    # point is ms/step and model-years/hour at the target resolution. A
    # 3-year window: a 1-year window was too thin for model-yr/hr claims
    # and could miss slow dt collapse (commit 8da3a01)
    hybrid5 = bench_hybrid_greenland(dtype, years=3.0, km=5.0)
    hybrid5["ms_per_step"] = round(
        hybrid5["wall_s"] / max(hybrid5["steps"], 1) * 1e3, 1)

    value = hybrid["model_years_per_hour"]
    result = {
        "metric": "synthetic-Greenland 20 km hybrid SSA+SIA+enthalpy+PDD model-years/wall-hour",
        "value": value,
        "unit": "model_years/hour",
        "vs_baseline": round(value / BASELINE_HYBRID_MODEL_YEARS_PER_HOUR, 3),
        "commit": git_commit(),
        "detail": {
            "hybrid": hybrid,
            "hybrid_5km": hybrid5,
            "eismint2A_sia": sia,
            "eismint2A_vs_1core_baseline": round(
                sia["model_years_per_hour"] / BASELINE_SIA_MODEL_YEARS_PER_HOUR, 3),
            "dtype": dtype,
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "baseline_note": "3e3 model-years/hour indicative 64-rank PISM "
                             "20 km estimate (reference mount empty; see BASELINE.md)",
            "vs_baseline_semantics": "indicative only - the denominator is "
                                     "a from-memory order-of-magnitude "
                                     "estimate, not a measured reference "
                                     "run",
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
