"""Per-layer device times of the hybrid Greenland step on one GPU, and the
Thomas/PCR crossover of the batched column solves.

Measures, at the chosen resolution (default the 5 km north-star grid):

- the step: wall ms/step over a window, and device busy time per step and
  kernels per step from a profiler trace of a second window;
- per call, from a profiler trace of K back-to-back calls in one program:
  the SIA flux (thermomechanical and isothermal), the SSA operator apply
  and one line-preconditioner application, plus the calls of each per
  step (SIA: one per stress-balance update plus one per skip substep;
  SSA apply and line preconditioner: two per BiCGStab iteration);
- ``solve_batched_thomas`` against ``solve_batched_pcr`` at the energy and
  age column shapes of the 5 km and 20 km grids (n = 41), and how many
  kernels a Thomas solve launches.

Every time is printed with the card's name and power limit. The full result
goes to ``--out`` as JSON.

Usage: python examples/gpu_layer_profile.py [--km 5] [--out FILE]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

SPY = 3.15569259747e7
TRACE_DIR = "chiprun_out/traces"   # scratch for the profiler, emptied after


def card_label():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()


def device_events(trace_dir):
    """(start_ns, dur_ns, name) of every kernel on the first GPU plane."""
    from jax.profiler import ProfileData
    path = glob.glob(_os.path.join(trace_dir, "plugins", "profile", "*",
                                   "*.xplane.pb"))[0]
    pd = ProfileData.from_file(path)
    lines_seen = {}
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:0"):
            lines_seen[plane.name] = "plane"
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen[line.name] = len(evs)
            # kernels live on the stream lines; "XLA Modules"/"XLA Ops"
            # lines repeat them as aggregates
            if "Stream" not in line.name:
                continue
            events += [(e.start_ns, e.duration_ns, e.name) for e in evs]
    return events, lines_seen


def busy_ns(events):
    """Union of the kernel intervals."""
    total, end = 0.0, None
    for s, d, _ in sorted(events):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def traced(fn, *args):
    """Run fn(*args) under the profiler; returns (result, events, lines)."""
    import jax
    d = TRACE_DIR
    shutil.rmtree(d, ignore_errors=True)
    try:
        with jax.profiler.trace(d):
            out = fn(*args)
            jax.block_until_ready(out)
        ev, lines = device_events(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out, ev, lines


def top_kernels(events, n=25):
    agg = {}
    for _, d, name in events:
        c, t = agg.get(name, (0, 0.0))
        agg[name] = (c + 1, t + d)
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"kernel": k[:120], "count": c, "total_us": t / 1e3}
            for k, (c, t) in rows]


def per_call_us(fn, carry, K, *consts):
    """Device time per call of carry -> fn(carry, *consts), from a trace of
    K calls unrolled in one jitted program (no while loop, no host round
    trip). The fields go in as arguments, not as baked-in constants."""
    import jax

    @jax.jit
    def many(c, *cs):
        for _ in range(K):
            c = fn(c, *cs)
        return c

    jax.block_until_ready(many(carry, *consts))        # compile
    tic = time.perf_counter()
    jax.block_until_ready(many(carry, *consts))
    wall = time.perf_counter() - tic
    _, ev, _ = traced(many, carry, *consts)
    return {"device_us_per_call": busy_ns(ev) / 1e3 / K,
            "kernels_per_call": len(ev) / K,
            "wall_us_per_call": wall * 1e6 / K}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=5.0)
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/layer_profile.json")
    args = ap.parse_args()
    global TRACE_DIR
    TRACE_DIR = _os.path.join(_os.path.dirname(args.out) or ".", "traces")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from pism_tpu.ops import sia as sia_ops
    from pism_tpu.ops import ssa as ssa_ops
    from pism_tpu.physics.rheology import flow_law_from_config
    from pism_tpu import Config
    from pism_tpu.util.tridiag import (solve_batched_pcr,
                                       solve_batched_thomas)

    if jax.devices()[0].platform != "gpu":
        print("gpu_layer_profile.py: no GPU visible", file=_sys.stderr)
        return 1
    card = card_label()
    res = {"card": card, "device_kind": jax.devices()[0].device_kind,
           "km": args.km}
    print(f"card: {card}", flush=True)

    # ---- tridiagonal crossover ------------------------------------------
    key = jax.random.PRNGKey(0)
    tri = []
    shapes = {"5km columns": (301, 561, 41), "20km columns": (141, 76, 41),
              "EISMINT II 61^3 columns": (61, 61, 61)}
    for label, shape in shapes.items():
        ks = jax.random.split(key, 4)
        b = 4.0 + jax.random.uniform(ks[0], shape, jnp.float32)
        a = -jax.random.uniform(ks[1], shape, jnp.float32)
        c = -jax.random.uniform(ks[2], shape, jnp.float32)
        d = jax.random.normal(ks[3], shape, jnp.float32)
        row = {"shape": label, "n": shape[-1],
               "batch": int(np.prod(shape[:-1]))}
        for name, solver in (("thomas", solve_batched_thomas),
                             ("pcr", solve_batched_pcr)):
            def step(dd, aa, bb, cc, solver=solver):
                return dd + 1e-30 * solver(aa, bb, cc, dd)
            r = per_call_us(step, d, 10, a, b, c)
            row[name] = r
        row["winner"] = min(("thomas", "pcr"),
                            key=lambda k: row[k]["device_us_per_call"])
        tri.append(row)
        print(f"tridiag {label} n={row['n']} batch={row['batch']}: "
              f"thomas {row['thomas']['device_us_per_call']:.1f} us "
              f"({row['thomas']['kernels_per_call']:.0f} kernels), "
              f"pcr {row['pcr']['device_us_per_call']:.1f} us "
              f"({row['pcr']['kernels_per_call']:.0f} kernels) [{card}]",
              flush=True)
    res["tridiag"] = tri

    # ---- the model at its resolution ------------------------------------
    model, state, grid = bench.hybrid_greenland_model("float32", km=args.km)
    tic = time.perf_counter()
    state, t, stats = model.step_once(state, 0.0, 0.25 * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)
    res["spinup_s_incl_compile"] = time.perf_counter() - tic
    tic = time.perf_counter()
    state, t, stats = model.step_once(state, t, 0.25 * SPY)
    jax.block_until_ready(state.geometry.ice_thickness)
    wall = time.perf_counter() - tic
    n = int(stats.nsteps)
    res["step"] = {"steps": n, "wall_ms_per_step": wall * 1e3 / n}
    (state2, t2, stats2), ev, lines = traced(
        lambda s: model.step_once(s, t, 0.05 * SPY), state)
    n2 = int(stats2.nsteps)
    busy = busy_ns(ev)
    res["step"].update({
        "trace_steps": n2,
        "device_busy_ms_per_step": busy / 1e6 / n2,
        "kernels_per_step": len(ev) / n2,
        "trace_lines": lines,
        "top_kernels": top_kernels(ev)})
    print(f"step {grid.Mx}x{grid.My}x{grid.Mz}: wall "
          f"{res['step']['wall_ms_per_step']:.2f} ms/step over {n} steps; "
          f"device busy {res['step']['device_busy_ms_per_step']:.2f} "
          f"ms/step, {res['step']['kernels_per_step']:.0f} kernels/step "
          f"[{card}]", flush=True)

    # ---- per-layer calls ------------------------------------------------
    sb = model.stress_balance
    geom = state.geometry
    E = state.enthalpy
    sh = model.sh
    layers = {}

    def sia_thermo(H, g0, E):
        g = g0.replace(ice_thickness=H)
        f = sia_ops.diffusivity(sb.sia_flow_law, g, E, grid, sh,
                                n=sb.n_sia, enhancement=sb.e_sia, rho=sb.rho,
                                g=sb.g, d_limit=sb.d_limit)
        return H + 1e-30 * (f.qe + f.qn + f.max_D)
    layers["sia_thermo"] = per_call_us(sia_thermo, geom.ice_thickness, args.K,
                                       geom, E)

    iso_law = flow_law_from_config(
        Config({"stress_balance.sia.flow_law": "isothermal_glen"}), "sia",
        model.EC)

    def sia_iso(H, g0):
        g = g0.replace(ice_thickness=H)
        f = sia_ops.diffusivity(iso_law, g, None, grid, sh, n=sb.n_sia,
                                rho=sb.rho, g=sb.g, d_limit=sb.d_limit)
        return H + 1e-30 * (f.qe + f.qn + f.max_D)
    layers["sia_isothermal"] = per_call_us(sia_iso, geom.ice_thickness,
                                           args.K, geom)

    tau_c = model.yield_stress.compute(state)
    P = model.ssa.build_problem(state, tau_c)
    u, v = state.u_ssa, state.v_ssa
    nuH = P["make_nuH"](u, v)
    beta = P["beta_fn"](u, v)

    def apply(c, nuH, beta):
        Au, Av = ssa_ops.apply_operator(c[0], c[1], nuH, beta, grid.dx,
                                        grid.dy, sh)
        return (c[0] + 1e-30 * Au, c[1] + 1e-30 * Av)
    layers["ssa_apply"] = per_call_us(apply, (u, v), args.K, nuH, beta)

    def line(c, nuH, beta, bc_mask):
        # the coefficient set-up is hoisted out of the Krylov loop in the
        # solver too; only the application is per iteration
        zu, zv = ssa_ops.make_line_preconditioner(
            nuH, beta, bc_mask, grid.dx, grid.dy, sh)(c)
        return (c[0] + 1e-30 * zu, c[1] + 1e-30 * zv)
    layers["line_precond"] = per_call_us(line, (u, v), args.K, nuH, beta,
                                         P["bc_mask"])

    info = jax.jit(lambda s: model.ssa.solve(s, tau_c, diagnostics=True))(
        state)[2]
    krylov = int(info["krylov_iters"])
    newton = int(info["newton_iters"])
    calls = {"sia_thermo": 1 + model.skip_max, "sia_isothermal": 0,
             "ssa_apply": 2 * krylov, "line_precond": 2 * krylov}
    step_ms = max(res["step"]["device_busy_ms_per_step"], 1e-9)
    for k, r in layers.items():
        r["calls_per_step"] = calls[k]
        r["share_of_step"] = r["device_us_per_call"] * calls[k] / 1e3 / step_ms
        print(f"{k}: {r['device_us_per_call']:.1f} us/call device "
              f"({r['kernels_per_call']:.1f} kernels, wall "
              f"{r['wall_us_per_call']:.1f} us), {calls[k]} calls/step -> "
              f"{100 * r['share_of_step']:.1f}% of step device time "
              f"[{card}]", flush=True)
    layers["ssa_solve_warm"] = {"newton_iters": newton,
                                "krylov_iters": krylov}
    res["layers"] = layers
    print(f"warm SSA solve: {newton} Newton sweeps, {krylov} Krylov "
          "iterations", flush=True)

    _os.makedirs(_os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("card", "device_kind", "km")}))
    return 0


if __name__ == "__main__":
    _sys.exit(main())
