"""Command-line driver.

Rebuild of PISM's executable layer (``src/pism.cc``; historically ``pismr``
/ ``pisms`` / ``pismv``): restart (``-i``) or simplified-geometry start
(``-eisII A``), run duration (``-y/-ys/-ye``), output channels
(``-o``, ``-extra_file/-extra_times/-extra_vars``, ``-ts_file/-ts_times``),
and arbitrary config parameters as ``-config key=value`` pairs (in PISM
every parameter is its own flag; one generic flag keeps the same power).

Examples:
  python -m pism_tpu -eisII A -y 200000 -o eis2A.nc
  python -m pism_tpu -i restart.nc -y 100 -extra_file ex.nc \
      -extra_times 0:10:100 -extra_vars thk,velbar_mag
  python -m pism_tpu -test B -My 61 -y 1000   (verification run)
"""

from __future__ import annotations

import argparse
import sys
import time as _wall

import numpy as np

from .config.config import Config
from .grid import Grid
from .util.timecal import Time
from .util.units import SEC_PER_YEAR


_TIME_KEYWORDS = {"yearly": 1.0, "monthly": 1.0 / 12.0,
                  "daily": 1.0 / 365.0, "hourly": 1.0 / 8760.0}


def parse_times(spec: str, year_length: float, start=None, end=None):
    """PISM-style time list: "a:step:b" (step a number of model years or a
    keyword yearly/monthly/daily/hourly), a bare keyword (covers the whole
    run [start, end], in model years), or a comma list of model years."""
    if ":" in spec:
        a, step, b = spec.split(":")
        a, b = float(a), float(b)
        st = _TIME_KEYWORDS.get(step, None)
        st = float(step) if st is None else st
        return [t * year_length for t in np.arange(a, b + st / 2, st)]
    if spec in _TIME_KEYWORDS:
        if start is None or end is None:
            raise ValueError(f"bare {spec!r} needs a known run interval")
        st = _TIME_KEYWORDS[spec]
        a = np.ceil(start / st) * st     # align to keyword multiples
        return [t * year_length for t in np.arange(a, end + st / 2, st)]
    return [float(s) * year_length for s in spec.split(",")]


_PARAM_SHORTHANDS = [
    ("-sia_e", "stress_balance.sia.enhancement_factor", float),
    ("-ssa_e", "stress_balance.ssa.enhancement_factor", float),
    ("-pseudo_plastic_q", "basal_resistance.pseudo_plastic.q", float),
    ("-pseudo_plastic_uthreshold",
     "basal_resistance.pseudo_plastic.u_threshold", float),
    ("-plastic_phi", "basal_yield_stress.mohr_coulomb.till_phi_default",
     float),
    ("-till_effective_fraction_overburden",
     "basal_yield_stress.mohr_coulomb.till_effective_fraction_overburden",
     float),
    ("-thickness_calving_threshold", "calving.thickness_calving.threshold",
     float),
    ("-eigen_calving_K", "calving.eigen_calving.K", float),
    ("-sia_flow_law", "stress_balance.sia.flow_law", str),
    ("-ssa_flow_law", "stress_balance.ssa.flow_law", str),
    ("-ssa_method", "stress_balance.ssa.method", str),
]


def build_parser():
    p = argparse.ArgumentParser(prog="pism_tpu", description=__doc__)
    p.add_argument("-i", metavar="FILE", help="restart from a model-state file")
    p.add_argument("-bootstrap", action="store_true",
                   help="treat -i as a bootstrap file (regrid 2D fields, heuristics for the rest)")
    p.add_argument("-eisII", metavar="EXP",
                   help="EISMINT II experiment (A-L, incl. the sector-sliding E)")
    p.add_argument("-test", metavar="LETTER",
                   help="verification test (A-P, V)")
    p.add_argument("-y", type=float, default=None, help="run length [years]")
    p.add_argument("-ys", type=float, default=None, help="start time [years]")
    p.add_argument("-ye", type=float, default=None, help="end time [years]")
    p.add_argument("-o", default="out.nc", help="output (model state) file")
    p.add_argument("-Mx", type=int, default=None)
    p.add_argument("-My", type=int, default=None)
    p.add_argument("-Mz", type=int, default=None)
    p.add_argument("-Lx", type=float, default=None,
                   help="half-width of the domain [km] (with -bootstrap)")
    p.add_argument("-Ly", type=float, default=None,
                   help="half-length of the domain [km] (with -bootstrap)")
    p.add_argument("-Lz", type=float, default=None,
                   help="height of the computational box [m]")
    p.add_argument("-extra_file", default=None)
    p.add_argument("-extra_times", default=None)
    p.add_argument("-extra_vars", default=None,
                   help="comma list of -extra_file diagnostics (default: "
                        "config output.extra.vars or thk,usurf,velbar_mag,"
                        "mask)")
    p.add_argument("-ts_file", default=None)
    p.add_argument("-ts_times", default=None)
    p.add_argument("-ts_vars", default=None,
                   help="scalar time-series quantities (instantaneous or "
                        "interval-averaged tendency_* rates; default: "
                        "config output.timeseries.variables)")
    p.add_argument("-save_file", default=None,
                   help="snapshot file pattern (e.g. snap_{kyr:.1f}.nc)")
    p.add_argument("-view", default=None, metavar="VAR[,VAR...]",
                   help="runtime map viewer (PISM -view): refresh "
                        "view_<var>.png for each listed 2D diagnostic at "
                        "every segment boundary")
    p.add_argument("-save_times", default=None,
                   help="snapshot times [years] (a:step:b or comma list)")
    p.add_argument("-backup_interval", type=float, default=0.0,
                   help="wall-clock hours between backups")
    # most-used reference parameter shorthands (in PISM every config
    # parameter is its own flag; -config covers the rest generically)
    for flag, key, typ in _PARAM_SHORTHANDS:
        p.add_argument(flag, type=typ, default=None, help=f"sets {key}")
    p.add_argument("-pseudo_plastic", action="store_true",
                   help="sets basal_resistance.pseudo_plastic.enabled")
    p.add_argument("-config", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("-config_override", metavar="FILE", default=None,
                   help="merge config overrides from a file (.json dict or a "
                        "NetCDF file carrying a stored pism_tpu config)")
    p.add_argument("-atmosphere", default=None,
                   help="atmosphere model chain (e.g. uniform,delta_T)")
    p.add_argument("-surface", default=None,
                   help="surface model chain (e.g. simple | pdd,cache)")
    p.add_argument("-ocean", default=None,
                   help="ocean model chain (e.g. constant | pik,cache)")
    p.add_argument("-sea_level", default=None, help="sea level model chain")
    # component-selection shorthands (in PISM every config parameter is a
    # flag; these mirror the ones its manual leads with)
    p.add_argument("-stress_balance", default=None,
                   help="none|prescribed_sliding|sia|ssa|ssa+sia|"
                        "weertman_sliding|blatter")
    p.add_argument("-energy", default=None, help="none | cold | enthalpy")
    p.add_argument("-hydrology", default=None,
                   help="null | routing | distributed | steady")
    p.add_argument("-calving", default=None,
                   help="comma list: thickness_calving,eigen_calving,"
                        "vonmises_calving,hayhurst_calving,float_kill,"
                        "ocean_kill,prescribed_retreat")
    p.add_argument("-bed_def", default=None, help="none | iso | lc | given")
    p.add_argument("-skip", action="store_true",
                   help="enable mass-transport subcycling between expensive "
                        "energy/stress-balance updates")
    p.add_argument("-skip_max", type=int, default=None)
    # PISM's marine-ice-sheet convenience flags (single-purpose flags in
    # the reference; -pik enables the PIK set at once)
    p.add_argument("-pik", action="store_true",
                   help="enable the PIK marine mechanisms at once: "
                        "-cfbc -part_grid -kill_icebergs -subgl")
    p.add_argument("-cfbc", action="store_true",
                   help="calving-front stress boundary condition")
    p.add_argument("-part_grid", action="store_true",
                   help="sub-grid front advance (Albrecht part-grid)")
    p.add_argument("-kill_icebergs", action="store_true",
                   help="remove floating cells not connected to grounded ice")
    p.add_argument("-subgl", action="store_true",
                   help="sub-grid grounding line (grounded cell fraction "
                        "scales basal drag)")
    p.add_argument("-max_dt", type=float, default=None,
                   help="maximum time step [years]")
    p.add_argument("-no_model_strip", type=float, default=None, metavar="KM",
                   help="regional mode: freeze a strip this wide [km] along "
                        "the domain boundary (PISM -regional)")
    p.add_argument("-regional", action="store_true",
                   help="regional (outlet-glacier) mode: read no_model_mask "
                        "(and usurfstore/thkstore if present) from the "
                        "input file; combine with -no_model_strip to build "
                        "the mask from the domain edge instead")
    p.add_argument("-o_format", default="netcdf4",
                   choices=("netcdf4", "netcdf3"),
                   help="output format: netcdf4 (HDF5-based) | netcdf3 "
                        "(classic CDF-2, readable without HDF5; "
                        "PISM -o_format)")
    p.add_argument("-o_size", default="small",
                   choices=("small", "medium", "big"),
                   help="output-file size: small = model state only (the "
                        "restartable checkpoint), medium adds common 2D "
                        "diagnostics, big adds the 3D fields (PISM -o_size)")
    p.add_argument("-inverse", action="store_true",
                   help="run a basal yield stress / hardness inversion "
                        "from observed velocities instead of a forward run "
                        "(the reference pismi.py driver role)")
    p.add_argument("-inv_data", metavar="FILE", default=None,
                   help="file with observed velocities (u_ssa/v_ssa, "
                        "uvelsurf/vvelsurf or u_surface/v_surface, m/s; "
                        "NaN = no observation)")
    p.add_argument("-inv_design", default=None,
                   help="design variable: tauc | hardav "
                        "(default: config inverse.design_variable)")
    p.add_argument("-inv_method", default=None,
                   help="lbfgs (bounded, TAO blmvm role) | adam "
                        "(default: config inverse.method)")
    p.add_argument("-regrid_file", metavar="FILE", default=None,
                   help="after -i, replace selected 2D fields with regridded "
                        "values from FILE (PISM -regrid_file)")
    p.add_argument("-regrid_vars", default="thk",
                   help="comma list of variables for -regrid_file")
    p.add_argument("-profile", metavar="LOGDIR", default=None,
                   help="write a jax profiler trace of the run to LOGDIR "
                        "(PISM -profile/-log_view role)")
    p.add_argument("-platform", default=None,
                   help="jax platform: cpu, or gpu (an NVIDIA card)")
    p.add_argument("-verbose", type=int, default=2)
    p.add_argument("-list_params", action="store_true",
                   help="print every configuration parameter with type, "
                        "default, units and description, then exit "
                        "(the reference generates this table from "
                        "pism_config.cdl)")
    p.add_argument("-list_diagnostics", action="store_true",
                   help="print all available -extra_vars / -ts_times "
                        "quantities and exit (PISM -list_diagnostics)")
    return p


def _apply_config_overrides(cfg: Config, pairs):
    for pair in pairs:
        k, v = pair.split("=", 1)
        for conv in (int, float):
            try:
                if conv is int and ("." in v or "e" in v.lower()):
                    continue
                cfg.update({k: conv(v)})
                break
            except (ValueError, KeyError):
                continue
        else:
            if v in ("true", "false", "yes", "no"):
                cfg.update({k: v in ("true", "yes")})
            else:
                cfg.update({k: v})


def jax_platforms(platform: str) -> str:
    """The ``jax_platforms`` value for ``-platform``. JAX expands "gpu" to
    both "cuda" and "rocm" and fails when either plugin is missing, so
    "gpu" names the CUDA backend this program targets."""
    return "cuda" if platform == "gpu" else platform


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_params:
        from .config.docgen import print_table
        print_table()
        return 0
    if args.list_diagnostics:
        from .model.diaggen import print_table
        print_table()
        return 0
    if args.o_format == "netcdf4":
        from .io import nc4
        if nc4.h5py is None:
            print(f"pism_tpu: error: -o {args.o}: {nc4.H5PY_MISSING}",
                  file=sys.stderr)
            return 2
    if args.platform:
        import jax
        jax.config.update("jax_platforms", jax_platforms(args.platform))

    import jax.numpy as jnp

    from .io import checkpoint as ckpt
    from .model.icemodel import IceModel
    from .model.output import OutputManager
    from .state import ModelState, new_geometry
    from .util.logger import log, set_verbosity

    set_verbosity(args.verbose)

    t0 = 0.0
    sliding_mu = None
    if args.eisII:
        from .verification import eismint2
        if args.i:  # restart experiment B/C/D/... from an A steady state:
            # the climate setup must live on the restored grid
            grid0 = ckpt.load_grid(args.i)
            es = eismint2.setup(args.eisII, Mx=grid0.Mx, Mz=grid0.Mz,
                                Lz=grid0.Lz)
            grid, cfg, surface = es.grid, es.config, es.surface
            state, t0 = ckpt.load_state(args.i, config=cfg)
        else:
            es = eismint2.setup(args.eisII, Mx=args.Mx or 61,
                                Mz=args.Mz or 61)
            grid, cfg, state, surface = es.grid, es.config, es.state, es.surface
        sliding_mu = es.sliding_mu
    elif args.test and args.test.upper() in tuple("ADEFGHKLOP"):
        # pismv-style single-test runs with an error report (runner.py)
        from .verification import runner
        over = Config({})
        _apply_config_overrides(over, args.config or [])
        runner.run_test(args.test, Mx=args.Mx, Mz=args.Mz, years=args.y,
                        config=over.non_default() or None)
        return 0
    elif args.test and args.test.upper() == "I":
        # PISM ``ssa_testi``: exact Schoof (2006) plastic-till stream, one
        # SSA solve (FD or FEM per stress_balance.ssa.method), error report

        from .model.ssa import SSAFD
        from .model.ssafem import SSAFEM
        from .physics.rheology import IsothermalGlen
        from .verification.ssa_exact import ExactI

        ti = ExactI()
        Mx, My = args.Mx or 11, args.My or 61
        grid = Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
        # fully-converged verification solve; plastic drag dominates test I,
        # so use the exact drag Jacobian (frozen-beta stagnates here)
        cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
                      "stress_balance.ssa.fd.drag_jacobian": "exact"})
        _apply_config_overrides(cfg, args.config)
        tau_c = jnp.asarray(np.tile(ti.tau_c(grid.y)[:, None], (1, Mx)))
        law = IsothermalGlen(A=float(ti.B) ** -3.0)
        geom = new_geometry(jnp.full(grid.shape2, ti.H0),
                            jnp.zeros(grid.shape2))
        bc = np.zeros(grid.shape2, bool)
        bc[0, :] = bc[-1, :] = True
        method = cfg.get_string("stress_balance.ssa.method")
        if method not in ("fd", "fem"):
            raise SystemExit(f"stress_balance.ssa.method = {method!r}; "
                             "expected 'fd' or 'fem'")
        cls = SSAFEM if method == "fem" else SSAFD
        ssa = cls(grid=grid, config=cfg, flow_law=law,
                  bc_mask=jnp.asarray(bc),
                  bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2),
                  taud_x=jnp.full(grid.shape2, ti.f),
                  taud_y=jnp.zeros(grid.shape2))
        u, v = ssa.solve(ModelState(geometry=geom), tau_c)
        spy = 3.15569259747e7
        uex = ti.velocity(grid.y)
        err = np.abs(np.asarray(u)[:, Mx // 2] - uex) * spy
        print(f"test I ({cls.__name__}): max |u| = "
              f"{float(np.abs(np.asarray(u)).max()) * spy:.2f} m/a "
              f"(exact {float(np.abs(uex).max()) * spy:.2f}); "
              f"max error = {err.max():.3f} m/a, avg = {err.mean():.3f} m/a")
        return 0
    elif args.test and args.test.upper() == "J":
        # PISM ``ssa_testj`` role: periodic shelf, one SSA solve against
        # the full nonlinear manufactured solution with an error report
        # and a refinement line
        from .verification.ssa_manufactured import ManufacturedSSA

        m = ManufacturedSSA()
        spy = 3.15569259747e7
        Mx = args.Mx or 61
        err, grid = m.solve_on(Mx)
        err2, _ = m.solve_on(2 * (Mx - 1) + 1)
        print(f"test J (manufactured periodic shelf, {Mx} -> "
              f"{2 * (Mx - 1) + 1} points): max velocity error = "
              f"{err * spy:.3f} -> {err2 * spy:.3f} m/a "
              f"(rate {np.log2(err / max(err2, 1e-30)):.2f})")
        return 0
    elif args.test and args.test.upper() == "M":
        # PISM ``pismv -test M``: annular shelf, radial exact profile

        from .model.ssa import SSAFD
        from .physics.rheology import IsothermalGlen
        from .state import ModelState, new_geometry
        from .verification.ssa_exact import ExactM

        tm = ExactM()
        Mx = args.Mx or 61
        grid = Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3)
        cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0})
        _apply_config_overrides(cfg, args.config)
        X, Y = np.meshgrid(np.asarray(grid.x), np.asarray(grid.y))
        R = np.hypot(X, Y)
        Rs = np.maximum(R, 1.0)
        u_ex = tm.velocity(R)
        H = np.where(R <= tm.Rc, tm.H0m, 0.0)
        bc = R <= tm.Rg + grid.dx
        geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -3000.0))
        ssa = SSAFD(grid=grid, config=cfg,
                    flow_law=IsothermalGlen(A=float(tm.B) ** -3.0),
                    bc_mask=jnp.asarray(bc),
                    bc_u=jnp.asarray(np.where(bc, u_ex * X / Rs, 0.0)),
                    bc_v=jnp.asarray(np.where(bc, u_ex * Y / Rs, 0.0)))
        u, v = ssa.solve(ModelState(geometry=geom), None)
        spy = 3.15569259747e7
        spd = np.hypot(np.asarray(u), np.asarray(v))
        sel = (R > tm.Rg + grid.dx) & (R < tm.Rc - grid.dx)
        err = np.abs(spd[sel] - u_ex[sel]) * spy
        print(f"test M (SSAFD, annulus + staircase CFBC): "
              f"max speed = {spd.max() * spy:.2f} m/a "
              f"(exact front {tm.velocity(tm.Rc) * spy:.2f}); "
              f"max error = {err.max():.2f} m/a, avg = {err.mean():.2f} m/a")
        return 0
    elif args.test and args.test.upper() == "V":
        # PISM ``pismv -test V``: van der Veen unconfined shelf, one SSA
        # solve with the calving-front stress BC, error report

        from .model.ssa import SSAFD
        from .physics.rheology import IsothermalGlen
        from .state import ModelState, new_geometry
        from .verification.ssa_exact import ExactV

        tv = ExactV()
        Mx, My = args.Mx or 101, args.My or 5
        L = 300e3
        grid = Grid(Mx=Mx, My=My, Lx=L / 2, Ly=50e3, periodicity="y")
        cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0})
        _apply_config_overrides(cfg, args.config)
        x = np.asarray(grid.x) + L / 2
        jf = int(0.85 * Mx)
        H = np.zeros(grid.shape2)
        H[:, :jf] = np.tile(tv.thickness(x[:jf])[None, :], (My, 1))
        geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -3000.0))
        bc = np.zeros(grid.shape2, bool)
        bc[:, 0] = True
        u_in = np.zeros(grid.shape2)
        u_in[:, 0] = tv.velocity(x[0])
        ssa = SSAFD(grid=grid, config=cfg,
                    flow_law=IsothermalGlen(A=float(tv.B) ** -3.0),
                    bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_in),
                    bc_v=jnp.zeros(grid.shape2))
        u, v = ssa.solve(ModelState(geometry=geom), None)
        spy = 3.15569259747e7
        uex = tv.velocity(x[:jf])
        err = np.abs(np.asarray(u)[My // 2, :jf] - uex) * spy
        print(f"test V (SSAFD, CFBC): front u = "
              f"{float(np.asarray(u)[My // 2, jf - 1]) * spy:.2f} m/a "
              f"(exact {uex[-1] * spy:.2f}); "
              f"max error = {err.max():.3f} m/a, avg = {err.mean():.3f} m/a")
        return 0
    elif args.test and args.test.upper() == "N":
        # PISM ``exactTestN`` role: Bodvardsson/Bueler (2014) steady
        # plastic-till marine ice stream with a calving front; one SSA
        # solve on the exact geometry + tau_c, error report
        from .model.ssa import SSAFD
        from .physics.rheology import IsothermalGlen
        from .state import ModelState, new_geometry
        from .verification.ssa_exact import ExactN

        tn = ExactN()
        Mx, My = args.Mx or 221, args.My or 5
        grid = Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
        cfg = Config({"stress_balance.ssa.fd.drag_jacobian": "exact"})
        _apply_config_overrides(cfg, args.config)
        x = np.asarray(grid.x)
        H = np.tile(tn.thickness(x)[None, :], (My, 1))
        tau = np.tile(tn.tau_c(x)[None, :], (My, 1))
        geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -tn.depth))
        bc = np.zeros(grid.shape2, bool)
        bc[:, Mx // 2] = True
        ssa = SSAFD(grid=grid, config=cfg,
                    flow_law=IsothermalGlen(A=float(tn.B) ** -3.0),
                    bc_mask=jnp.asarray(bc),
                    bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2))
        u, v, info = ssa.solve(ModelState(geometry=geom), jnp.asarray(tau),
                               diagnostics=True)
        spy = 3.15569259747e7
        uex = tn.velocity(x)
        sel = np.abs(x) <= tn.xc - 2 * grid.dx
        err = np.abs(np.asarray(u)[My // 2] - uex)[sel] * spy
        print(f"test N (SSAFD, plastic till + CFBC, exact drag Jacobian): "
              f"max u = {np.asarray(u)[My // 2].max() * spy:.1f} m/a "
              f"(exact {uex.max() * spy:.1f}); interior max error = "
              f"{err.max():.2f} m/a, avg = {err.mean():.2f} m/a "
              f"({int(info['newton_iters'])} Newton sweeps)")
        return 0
    elif args.test:
        if args.test.upper() not in ("B", "C"):
            print(f"pism_tpu: unsupported verification test {args.test!r} "
                  "(supported: A-P, V)", file=sys.stderr)
            return 2
        from .verification import halfar
        sol = halfar.test_B() if args.test.upper() == "B" else halfar.test_C()
        Mx = args.Mx or 61
        grid = Grid(Mx=Mx, My=args.My or Mx, Lx=900e3, Ly=900e3)
        cfg = Config({
            "stress_balance.model": "sia",
            "stress_balance.sia.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
            "energy.model": "none"})
        t0 = sol.t0
        state = ModelState(geometry=new_geometry(
            jnp.asarray(sol.thickness(t0, grid.radius)), jnp.zeros(grid.shape2)))
        from .coupler.surface import FunctionSurface
        lam = sol.lam

        def smb(geometry, t):
            m = lam / t * geometry.ice_thickness
            return m, jnp.full(geometry.ice_thickness.shape, 263.15)

        surface = FunctionSurface(smb)
    elif args.i and args.bootstrap:
        from .io.bootstrap import bootstrap as _bootstrap
        cfg = Config()
        # grid-shaping parameters must be visible before construction
        # (overrides are re-applied later with everything else)
        _apply_config_overrides(cfg, args.config)
        grid = Grid(Mx=args.Mx or cfg.get_int("grid.Mx"),
                    My=args.My or cfg.get_int("grid.My"),
                    Lx=args.Lx * 1e3 if args.Lx else cfg.get_number("grid.Lx"),
                    Ly=args.Ly * 1e3 if args.Ly else cfg.get_number("grid.Ly"),
                    Mz=args.Mz or cfg.get_int("grid.Mz"),
                    Lz=args.Lz or cfg.get_number("grid.Lz"),
                    registration=cfg.get_string("grid.registration"))
        state = _bootstrap(args.i, grid, cfg)
        from .coupler.surface import Uniform
        surface = Uniform(smb=0.0)
    elif args.i:
        grid = ckpt.load_grid(args.i)
        cfg = ckpt.load_config(args.i)
        state, t0 = ckpt.load_state(args.i, config=cfg)
        from .coupler.surface import Uniform
        surface = Uniform(smb=0.0)  # continuation runs should supply forcing
    else:
        print("error: need one of -i, -eisII, -test", file=sys.stderr)
        return 1

    if args.i and not cfg.get_string("grid.projection"):
        # adopt the input file's grid mapping so outputs keep the
        # projection (and lat/lon) through restart chains
        from .io.nc4 import File as _File
        with _File(args.i, "r") as _f:
            _p = _f.get_global_attr("proj")
        if _p is not None:
            if isinstance(_p, bytes):
                _p = _p.decode()
            cfg.update({"grid.projection": str(_p)})

    if args.regrid_file:
        # PISM -regrid_file/-regrid_vars: overwrite selected 2D fields with
        # values regridded from another file (only where that file covers
        # the domain; outside stays as restored)
        from .io.bootstrap import read_and_regrid
        names = [s.strip() for s in args.regrid_vars.split(",") if s.strip()]
        fields = read_and_regrid(args.regrid_file, grid, variables=names)
        field_map = {"thk": "ice_thickness", "topg": "bed_elevation"}
        geom = state.geometry
        for var, arr in fields.items():
            if var in field_map:
                old = getattr(geom, field_map[var])
                new = jnp.where(jnp.isnan(jnp.asarray(arr)), old,
                                jnp.asarray(arr, old.dtype))
                geom = geom.replace(**{field_map[var]: new})
            else:
                from .io.checkpoint import _STATE_VARS
                rev = {v[0]: k for k, v in _STATE_VARS.items()}
                if var not in rev or _STATE_VARS[rev[var]][2] != 2:
                    print(f"warning: -regrid_vars {var!r} is not a "
                          "regriddable 2D state variable; skipped",
                          file=sys.stderr)
                    continue
                old = getattr(state, rev[var])
                a = jnp.asarray(fields[var])
                if old is None:
                    old = jnp.zeros(grid.shape2)
                new = jnp.where(jnp.isnan(a), old, a.astype(old.dtype))
                state = state.replace(**{rev[var]: new})
        state = state.replace(geometry=geom)
        log.message(2, "regridded %s from %s", ",".join(fields),
                    args.regrid_file)

    if args.config_override:
        # PISM ``-config_override``: merge a user parameter file on top of the
        # defaults (reference src/util/ConfigInterface.cc override handling)
        if args.config_override.endswith(".json"):
            import json
            with open(args.config_override) as f:
                cfg.update(json.load(f))
        else:
            over = ckpt.load_config(args.config_override)
            cfg.update(over.non_default())
    # component-selection shorthands -> config parameters
    if args.stress_balance:
        cfg.update({"stress_balance.model": args.stress_balance})
    if args.energy:
        cfg.update({"energy.model": args.energy})
    if args.hydrology:
        cfg.update({"hydrology.model": args.hydrology})
    if args.calving:
        cfg.update({"calving.methods": args.calving})
    if args.bed_def:
        cfg.update({"bed_deformation.model": args.bed_def})
    if args.skip:
        cfg.update({"time_stepping.skip.enabled": True})
    if args.skip_max is not None:
        cfg.update({"time_stepping.skip.enabled": True,
                    "time_stepping.skip.max": args.skip_max})
    for flag, key, _typ in _PARAM_SHORTHANDS:
        val = getattr(args, flag.lstrip("-"))
        if val is not None:
            cfg.update({key: val})
    if args.pseudo_plastic:
        cfg.update({"basal_resistance.pseudo_plastic.enabled": True})
    if args.pik or args.cfbc:
        cfg.update({"stress_balance.calving_front_stress_bc": True})
    if args.pik or args.part_grid:
        cfg.update({"geometry.part_grid.enabled": True})
    if args.pik or args.kill_icebergs:
        cfg.update({"geometry.remove_icebergs": True})
    if args.pik or args.subgl:
        cfg.update({"geometry.grounded_cell_fraction": True})
    if args.max_dt is not None:   # stored in years (parameters.py)
        cfg.update({"time_stepping.maximum_time_step": args.max_dt})
    _apply_config_overrides(cfg, args.config)

    # runtime flags double as config parameters (the reference pattern:
    # every option is stored in the config that lands in the output files)
    if args.platform:
        cfg.update({"runtime.platform": args.platform})
    if args.profile:
        cfg.update({"runtime.profile.directory": args.profile})
    if args.ts_vars:
        cfg.update({"output.timeseries.variables": args.ts_vars})
    if args.view:
        cfg.update({"output.runtime.viewer.variables": args.view})
    if args.inverse and args.inv_method is not None:
        # only override when explicitly given, so -config inverse.method=...
        # is not clobbered by the argparse default
        cfg.update({"inverse.method": args.inv_method})
    # input/output/time options mirror into the config (reference pattern:
    # every option IS a config parameter; the stored config in outputs then
    # reflects the actual run settings)
    import sys as _sys
    cfg.update({"run_info.command": " ".join(_sys.argv)})
    cfg.update({"runtime.verbosity": args.verbose})
    if args.i:
        cfg.update({"input.file": args.i})
    cfg.update({"input.bootstrap": bool(args.bootstrap)})
    if args.regrid_file:
        cfg.update({"input.regrid.file": args.regrid_file})
        if getattr(args, "regrid_vars", None):
            cfg.update({"input.regrid.vars": args.regrid_vars})
    cfg.update({"output.file": args.o})
    if args.ys is not None:
        cfg.update({"time.start": args.ys})
    if args.ye is not None:
        cfg.update({"time.end": args.ye})
    if args.y is not None:
        cfg.update({"time.run_length": args.y})
    if getattr(args, "no_model_strip", None) is not None:
        cfg.update({"regional.no_model_strip": args.no_model_strip})
    # persistent XLA compilation cache: compiled executables are reused
    # across processes (the first compile of a km-scale grid dominates
    # start-up)
    from .util.compile_cache import enable_compile_cache
    enable_compile_cache(cfg.get_string("runtime.jit.cache_dir"))

    no_model_mask = None
    usurf_store = thk_store = None
    if args.regional and args.i:
        # PISM -regional: the stored frame comes from the input file when
        # it carries the regional variables (IceRegionalModel reads
        # no_model_mask / usurfstore / thkstore)
        cfg.update({"regional.enabled": True})
        from .io.nc4 import File
        with File(args.i, "r") as f:
            if f.has_variable("no_model_mask"):
                no_model_mask = jnp.asarray(
                    np.asarray(f.read("no_model_mask")).squeeze() > 0.5)
            if f.has_variable("usurfstore"):
                usurf_store = jnp.asarray(
                    np.asarray(f.read("usurfstore")).squeeze())
            if f.has_variable("thkstore"):
                thk_store = jnp.asarray(
                    np.asarray(f.read("thkstore")).squeeze())
    if args.no_model_strip:
        # PISM -regional: strip of width L [km] along the domain boundary
        cfg.update({"regional.enabled": True})
        w = args.no_model_strip * 1e3
        nmm = np.zeros(grid.shape2, bool)
        nx = max(int(np.ceil(w / grid.dx)), 1)
        ny = max(int(np.ceil(w / grid.dy)), 1)
        nmm[:ny, :] = nmm[-ny:, :] = True
        nmm[:, :nx] = nmm[:, -nx:] = True
        no_model_mask = jnp.asarray(nmm)
    if args.regional and no_model_mask is None:
        raise SystemExit("-regional needs no_model_mask in the input file "
                         "or an explicit -no_model_strip width")

    # PISM-style coupler selection flags: build chains via the factory.
    # Restarts (-i) rebuild chains recorded in the stored config, so a
    # continuation run keeps its forcing without re-specifying flags
    # (models needing input fields must come through the Python API).
    ocean_model = None
    sl_model = None
    nd = cfg.non_default()
    atm_sel = args.atmosphere or (args.i and nd.get("atmosphere.models"))
    surf_sel = args.surface or (args.i and not args.eisII
                                and nd.get("surface.models"))
    ocean_sel = args.ocean or (args.i and nd.get("ocean.models"))
    sl_sel = args.sea_level or (args.i and nd.get("sea_level.models"))
    if atm_sel or surf_sel or ocean_sel or sl_sel:
        from .coupler import factory as _cf
        atm_model = None
        if atm_sel:
            cfg.update({"atmosphere.models": atm_sel})
            atm_inputs = _cf.inputs_from_files(cfg, grid, "atmosphere")
            atm_base = str(atm_sel).split(",")[0]
            if args.i and atm_base in ("searise_greenland", "pik"):
                # PISM reads the parameterization inputs (lat/lon and the
                # precipitation map) from the input/bootstrap file when no
                # separate forcing file is given
                from .io.bootstrap import (lonlat_from_projection,
                                           read_and_regrid,
                                           read_forcing_fields)
                flds = read_and_regrid(args.i, grid,
                                       variables=["lat", "latitude",
                                                  "lon", "longitude"])
                lat = flds.get("lat", flds.get("latitude"))
                lon = flds.get("lon", flds.get("longitude"))
                if (lat is None or lon is None) and cfg.get_flag(
                        "grid.recompute_longitude_and_latitude"):
                    # reference grid.recompute_longitude_and_latitude:
                    # derive lon/lat from the projection metadata
                    lon_p, lat_p = lonlat_from_projection(args.i, grid)
                    lat = lat if lat is not None else lat_p
                    lon = lon if lon is not None else lon_p
                fdt = jnp.float32 \
                    if cfg.get_string("runtime.float_dtype") == "float32" \
                    else jnp.float64
                if lat is not None:
                    atm_inputs.setdefault("latitude", jnp.asarray(lat, fdt))
                if lon is not None:
                    atm_inputs.setdefault("longitude", jnp.asarray(lon, fdt))
                if "precipitation" not in atm_inputs:
                    pf, _ = read_forcing_fields(args.i, grid,
                                                ["precipitation"])
                    if "precipitation" in pf:
                        p = pf["precipitation"]
                        atm_inputs["precipitation"] = jnp.asarray(
                            p[-1] if p.ndim == 3 else p, fdt)
            atm_model = _cf.atmosphere_from_config(
                cfg, inputs=atm_inputs, grid=grid)
        elif surf_sel and any(m in surf_sel for m in
                              ("simple", "pdd", "debm_simple", "pik")):
            # the restored surface chain needs an atmosphere but the
            # stored atmosphere chain is the default (not recorded in
            # non_default()): build it from the config as-is
            atm_model = _cf.atmosphere_from_config(
                cfg, inputs=_cf.inputs_from_files(cfg, grid, "atmosphere"),
                grid=grid)
        if surf_sel:
            cfg.update({"surface.models": surf_sel})
            surf_inputs = _cf.inputs_from_files(cfg, grid, "surface")
            if args.i and any(m in surf_sel for m in ("debm_simple", "pik")):
                # latitude-dependent surface models read lat from the
                # input file (PISM: mandatory lat/lon variables), falling
                # back to computing it from the projection metadata
                from .io.bootstrap import (latitude_from_projection,
                                           read_and_regrid)
                flds = read_and_regrid(args.i, grid,
                                       variables=["lat", "latitude"])
                lat = flds.get("lat", flds.get("latitude"))
                if lat is None and cfg.get_flag(
                        "grid.recompute_longitude_and_latitude"):
                    lat = latitude_from_projection(args.i, grid)
                if lat is not None:
                    surf_inputs["latitude"] = jnp.asarray(lat)
            surf_inputs["_grid"] = grid
            surface = _cf.surface_from_config(cfg, inputs=surf_inputs,
                                              atmosphere=atm_model)
        elif atm_model is not None:
            from .coupler.surface import Simple
            surface = Simple(atmosphere=atm_model)
        if ocean_sel:
            cfg.update({"ocean.models": ocean_sel})
            ocean_model = _cf.ocean_from_config(
                cfg, inputs=_cf.inputs_from_files(cfg, grid, "ocean"),
                grid=grid)
        if sl_sel:
            cfg.update({"sea_level.models": sl_sel})
            sl_model = _cf.sea_level_from_config(
                cfg, inputs=_cf.inputs_from_files(cfg, grid, "sea_level"))

    # -ys/-ye/-y fall back to time.{start,end,run_length} from the config;
    # the calendar/reference date label the time axis and align dated
    # forcing (year *durations* stay SEC_PER_YEAR package-wide)
    from .util.timecal import Calendar
    yl = SEC_PER_YEAR
    _ys_cfg = cfg.get_number("time.start", "years")
    _ye_cfg = cfg.get_number("time.end", "years")
    ys = args.ys * yl if args.ys is not None else (
        _ys_cfg * yl if cfg.is_set("time.start") else t0)
    if args.ye is not None:
        ye = args.ye * yl
    elif args.y is not None:
        ye = ys + args.y * yl
    elif cfg.is_set("time.end") and _ye_cfg > _ys_cfg:
        ye = _ye_cfg * yl
    elif cfg.is_set("time.run_length"):
        ye = ys + cfg.get_number("time.run_length", "years") * yl
    else:
        ye = ys
    run_time = Time(start=ys, end=ye,
                    calendar=Calendar(cfg.get_string("time.calendar")),
                    reference_date=cfg.get_string("time.reference_date"))

    # multi-device spatial decomposition (the PETSc DMDA rank layout the
    # reference fixes at -Nx/-Ny): build a ("y", "x") mesh when more than
    # one accelerator is visible and shard the state over it: GSPMD
    # partitions every stencil and inserts the halo collectives
    mesh = None
    import jax as _jax
    n_dev = len(_jax.devices())
    nx_cfg = cfg.get_int("grid.Nx")
    ny_cfg = cfg.get_int("grid.Ny")
    if n_dev > 1 or nx_cfg or ny_cfg:
        from .parallel.mesh import best_factorization, make_mesh
        ny_m, nx_m = ((ny_cfg, nx_cfg) if (nx_cfg and ny_cfg)
                      else best_factorization(n_dev))
        if grid.My % ny_m or grid.Mx % nx_m:
            log.message(
                1, "grid %dx%d not divisible by device mesh %dx%d; "
                "running unsharded (choose -Mx/-My multiples of the mesh, "
                "or set grid.Nx/grid.Ny)", grid.Mx, grid.My, nx_m, ny_m)
        else:
            mesh = make_mesh(shape=(ny_m, nx_m))

    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=ocean_model, sea_level=sl_model,
                     no_model_mask=no_model_mask, sliding_mu=sliding_mu,
                     usurf_store=usurf_store, thk_store=thk_store)

    if not cfg.get_flag("stress_balance.ssa.read_initial_guess") \
            and (state.u_ssa is not None or state.v_ssa is not None):
        # reference -ssa_read_initial_guess false: cold-start the SSA
        # instead of warm-starting from the input file's velocities
        state = state.replace(u_ssa=None, v_ssa=None)

    if cfg.get_flag("stress_balance.ssa.dirichlet_bc") and args.i:
        # reference -ssa_dirichlet_bc: bc_mask + u_bc/v_bc (m/year in
        # files) from the input file fix the SSA velocity where set
        from .io.bootstrap import read_and_regrid
        flds = read_and_regrid(args.i, grid,
                               ["bc_mask", "u_bc", "v_bc",
                                "u_ssa_bc", "v_ssa_bc"])
        bcm = flds.get("bc_mask")
        ub = flds.get("u_bc", flds.get("u_ssa_bc"))
        vb = flds.get("v_bc", flds.get("v_ssa_bc"))
        if bcm is None or ub is None or vb is None:
            raise SystemExit(
                "-config stress_balance.ssa.dirichlet_bc=True needs "
                "bc_mask, u_bc and v_bc variables in the -i file")
        if model.ssa is None:
            raise SystemExit("ssa.dirichlet_bc needs an SSA stress balance")
        spy = 3.15569259747e7
        model.ssa.bc_mask = jnp.asarray(np.nan_to_num(bcm) > 0.5)
        model.ssa.bc_u = jnp.asarray(np.nan_to_num(ub) / spy)
        model.ssa.bc_v = jnp.asarray(np.nan_to_num(vb) / spy)
    if mesh is not None:
        from .parallel.mesh import shard_state
        state = shard_state(state, mesh)
        log.message(2, "spatial decomposition: %d devices as %s mesh",
                    mesh.size, dict(mesh.shape))

    if args.inverse:
        return _run_inversion(args, model, state, grid, cfg)

    # output flags fall back to their config parameters (reference: every
    # -extra_*/-ts_*/-save_*/-backup_* option IS a config parameter); the
    # CLI values mirror back in for provenance
    extra_file = args.extra_file or cfg.get_string("output.extra.file") or None
    extra_times_s = args.extra_times or cfg.get_string("output.extra.times")
    extra_vars_s = args.extra_vars or cfg.get_string("output.extra.vars") \
        or "thk,usurf,velbar_mag,mask"
    ts_file = args.ts_file or cfg.get_string("output.timeseries.filename") \
        or None
    ts_times_s = args.ts_times or cfg.get_string("output.timeseries.times")
    save_file = args.save_file or cfg.get_string("output.snapshot.file") \
        or None
    save_times_s = args.save_times or cfg.get_string("output.snapshot.times")
    backup_h = args.backup_interval \
        or cfg.get_number("output.backup_interval", "hours") \
        or cfg.get_number("output.checkpoint.interval", "hours")
    cfg.update({k: v for k, v in {
        "output.extra.file": extra_file or "",
        "output.extra.times": extra_times_s or "",
        "output.extra.vars": extra_vars_s,
        "output.timeseries.filename": ts_file or "",
        "output.timeseries.times": ts_times_s or "",
        "output.snapshot.file": save_file or "",
        "output.snapshot.times": save_times_s or "",
        "output.backup_interval": backup_h,
    }.items()})
    out = OutputManager(
        grid=grid, config=cfg,
        extra_times=parse_times(extra_times_s, yl, ys / yl, ye / yl)
        if extra_times_s else (),
        extra_vars=tuple(extra_vars_s.split(",")),
        extra_file=extra_file,
        ts_times=parse_times(ts_times_s, yl, ys / yl, ye / yl)
        if ts_times_s else (),
        ts_vars=tuple(cfg.get_string("output.timeseries.variables").split(",")),
        ts_file=ts_file,
        snapshot_times=parse_times(save_times_s, yl, ys / yl, ye / yl)
        if save_times_s else (),
        snapshot_file=save_file or "snapshots_{kyr:.3f}.nc",
        backup_interval=backup_h * 3600.0,
        view_vars=tuple(v for v in cfg.get_string(
            "output.runtime.viewer.variables").split(",") if v),
        async_io=cfg.get_flag("output.async"),
    )

    wall0 = _wall.time()
    t_reached = run_time.start

    # runtime summary formatting (reference output.runtime.*): volume/area
    # scaling exponents, calendar-date time stamps, time unit label
    _vscale = 10.0 ** cfg.get_number(
        "output.runtime.volume_scale_factor_log10")
    _ascale = 10.0 ** cfg.get_number("output.runtime.area_scale_factor_log10")
    _tunit = cfg.get_string("output.runtime.time_unit_name") or "a"
    _tcal = cfg.get_flag("output.runtime.time_use_calendar")

    def report(state_, t, stats):
        nonlocal t_reached
        t_reached = t
        if log.verbosity >= 2:
            vol = float(jnp.sum(state_.geometry.ice_thickness)) \
                * grid.dx * grid.dy / 1e9 / _vscale
            h_std = cfg.get_number("output.ice_free_thickness_standard")
            area = float(jnp.sum(
                (state_.geometry.ice_thickness > h_std).astype(
                    jnp.float32))) * grid.dx * grid.dy / 1e6 / _ascale
            tstamp = run_time.date_string(t) if _tcal \
                else f"{t / yl:12.2f} {_tunit}"
            log.message(
                2, "t = %s   steps = %7d   volume = %14.1f km3   "
                "area = %12.1f km2   wall = %7.1f s",
                tstamp, int(stats.nsteps), vol, area,
                _wall.time() - wall0)

    from .util.signals import SignalMonitor
    import contextlib
    prof = contextlib.nullcontext()
    if args.profile:
        from .util.profiling import trace
        prof = trace(args.profile)
    with SignalMonitor() as sigs, prof:
        state, stats = model.run(state, run_time, output=out,
                                 callback=report, signals=sigs)
    out.close()
    if cfg.get_flag("time_stepping.count_time_steps") and stats is not None:
        # reference -count_time_steps: report the total adaptive steps
        # taken, with the per-limit attribution this framework records
        log.message(1, "count_time_steps: %d adaptive steps (binding "
                    "limits: %s)", int(stats.nsteps),
                    stats.limit_hits_dict())
    regional_2d = None
    if no_model_mask is not None:
        # PISM regional runs carry the mask and stored frame in the output
        # so -regional restarts reconstruct the same subdomain setup
        regional_2d = {
            "no_model_mask": (no_model_mask, {"long_name":
                              "regional-mode no-model strip mask"}),
            "usurfstore": (model.usurf_store, {"units": "m", "long_name":
                           "stored surface elevation (regional frame)"}),
            "thkstore": (model.thk_store, {"units": "m", "long_name":
                         "stored ice thickness (regional frame)"}),
        }
    ckpt.save_state(args.o, state, grid, t_reached, config=cfg,
                    format=args.o_format, extra_2d=regional_2d)
    cfg.update({"output.size": args.o_size, "output.format": args.o_format,
                "output.snapshot.size":
                    cfg.get_string("output.snapshot.size")})
    if args.o_size != "small":
        # variable sets from the config DB (reference output.sizes.*)
        med = tuple(cfg.get_string("output.sizes.medium").split())
        names = med
        if args.o_size in ("big_2d", "big"):
            names = names + tuple(
                cfg.get_string("output.sizes.big_2d").split())
        if args.o_size == "big":
            names = names + tuple(cfg.get_string("output.sizes.big").split())
        ckpt.append_diagnostics(args.o, names, state, model, t_reached)
    if args.test and args.test.upper() in ("B", "C"):
        # pismv-style error report at the final time (Halfar similarity)
        from .verification import halfar
        from .verification.runner import _report
        He = sol.thickness(t_reached, grid.radius)
        e = halfar.error_norms(np.asarray(state.geometry.ice_thickness), He)
        _report(f"test {args.test.upper()} (Halfar, t = {t_reached / yl:.0f} a)",
                [("geometry", {"prcnt_volume": 100.0 * e["rel_volume"],
                               "max_H": e["max_H"], "avg_H": e["avg_H"],
                               "dome_H": e["dome_H"]})])
    log.message(1, "done; state written to %s", args.o)
    return 0


def _run_inversion(args, model, state, grid, cfg):
    """The ``pismi.py`` driver role: invert tau_c (or hardness) from
    observed velocities with the bounded L-BFGS / Adam optimizers, log
    the convergence ladder, write the result state
    (reference ``src/inverse/`` + ``util/pismi.py``)."""
    import numpy as np
    import jax.numpy as jnp

    from .inverse.parameterizations import from_config
    from .inverse.ssa_inverse import HardnessInversion, TaucInversion
    from .io import checkpoint as ckpt
    from .io.bootstrap import read_and_regrid
    from .util.logger import log

    if args.inv_data is None:
        print("error: -inverse needs -inv_data FILE", file=sys.stderr)
        return 1
    state = model.prepare_state(state)
    fields = read_and_regrid(args.inv_data, grid, variables=[
        "u_ssa", "v_ssa", "uvelsurf", "vvelsurf", "u_surface", "v_surface"])
    u_obs = fields.get("u_ssa", fields.get("uvelsurf",
                                           fields.get("u_surface")))
    v_obs = fields.get("v_ssa", fields.get("vvelsurf",
                                           fields.get("v_surface")))
    if u_obs is None or v_obs is None:
        print(f"error: no observed velocities found in {args.inv_data}",
              file=sys.stderr)
        return 1
    obs_mask = np.isfinite(np.asarray(u_obs)) & np.isfinite(np.asarray(v_obs))
    u_obs = jnp.asarray(np.nan_to_num(np.asarray(u_obs)))
    v_obs = jnp.asarray(np.nan_to_num(np.asarray(v_obs)))

    design = args.inv_design or cfg.get_string("inverse.design_variable")
    reg_kind = {"cH1": "h1", "cL2": "l2", "cTV": "tv"}
    weights = {k: cfg.get_number(f"inverse.design.{k}")
               for k in ("cH1", "cL2", "cTV")}
    kind, w = max(weights.items(), key=lambda kv: kv[1])
    # the misfit is a dimensionless per-cell mean; scale the summed design
    # functional to a per-cell mean too so the c* weights are O(1) knobs
    w = w / (grid.Mx * grid.My)
    param = from_config(cfg, "tauc" if design == "tauc" else "hardav")
    ssa = model.ssa
    if ssa is None:
        print("error: -inverse needs an SSA stress balance "
              "(-stress_balance ssa or ssa+sia)", file=sys.stderr)
        return 1

    def monitor(rec):
        log.message(2, "inv iter %3d: J = %.6e (misfit %.3e, reg %.3e)  "
                    "|proj grad| = %.3e  step = %.2f", rec.iteration, rec.J,
                    rec.J_misfit, rec.J_regularization, rec.pgrad_norm,
                    rec.step)

    max_it = cfg.get_int("inverse.max_iterations")
    # nondimensionalized regularizer gradients (inverse.ssa.length_scale),
    # TV smoothing epsilon and the velocity-misfit weight
    mis_w = cfg.get_number("inverse.ssa.velocity_misfit_weight")
    grad_scale = cfg.get_number("inverse.ssa.length_scale", "m") / grid.dx
    tv_eps = cfg.get_number("inverse.design.tv_epsilon")
    # Morozov discrepancy target (inverse.target_misfit, m/year) in the
    # dimensionless misfit units (J = w 0.5 e_rms^2 / <|u_obs|^2>)
    wmask = np.asarray(obs_mask, float)
    nobs = max(float(wmask.sum()), 1.0)
    obs2 = float((np.asarray(u_obs) ** 2 * wmask).sum()
                 + (np.asarray(v_obs) ** 2 * wmask).sum()) / nobs
    target_ms = cfg.get_number("inverse.target_misfit", "m s-1")
    misfit_target = mis_w * 0.5 * target_ms ** 2 / max(obs2, 1e-30) \
        if target_ms > 0 else None
    if design == "tauc":
        tau0 = model.yield_stress.compute(state)
        inv = TaucInversion(ssa=ssa, state=state, u_obs=u_obs, v_obs=v_obs,
                            obs_mask=jnp.asarray(obs_mask),
                            reg_kind=reg_kind[kind], reg_weight=w,
                            param=param, misfit_weight=mis_w,
                            grad_scale=grad_scale, tv_eps=tv_eps)
        tauc_min = cfg.get_number("inverse.ssa.tauc_min")
        tauc_max = cfg.get_number("inverse.ssa.tauc_max")
        if param.kind == "exp":
            # reference inverse.log_ratio: bound |ln(tauc / scale)| in the
            # exp parameterization
            lr = cfg.get_number("inverse.log_ratio")
            tauc_min = max(tauc_min, param.scale * float(np.exp(-lr)))
            tauc_max = min(tauc_max, param.scale * float(np.exp(lr)))
        if cfg.get_string("inverse.method") == "lbfgs":
            res, opt = inv.run_lbfgs(
                tau0, max_iterations=max_it,
                tauc_min=tauc_min,
                tauc_max=tauc_max,
                grtol=cfg.get_number("inverse.gradient_tolerance"),
                steptol=cfg.get_number("inverse.step_tolerance"),
                monitor=monitor, misfit_target=misfit_target)
            log.message(1, "inversion %s (%s) after %d iterates",
                        "converged" if opt.converged else "stopped",
                        opt.reason, len(opt.log))
        else:
            res = inv.run(tau0, iterations=max_it)
        result_var = ("tauc", "Pa", "inverted basal yield stress")
    else:
        B0 = jnp.full(grid.shape2, param.scale)
        tau_c = model.yield_stress.compute(state)
        inv = HardnessInversion(ssa=ssa, state=state, u_obs=u_obs,
                                v_obs=v_obs, tau_c=tau_c,
                                obs_mask=jnp.asarray(obs_mask),
                                reg_kind=reg_kind[kind], reg_weight=w,
                                param=param)
        res = inv.run(B0, iterations=max_it)
        result_var = ("hardav", "Pa s(1/3)",
                      "inverted vertically-averaged ice hardness")

    out_state = state.replace(u_ssa=res.u, v_ssa=res.v)
    out_file = cfg.get_string("inverse.state_file") or args.o
    ckpt.save_state(out_file, out_state, grid, 0.0, config=cfg,
                    format=args.o_format)
    from .io.nc4 import File
    name, units, long_name = result_var
    with File(out_file, "r+") as f:
        f.write(name, np.asarray(res.tau_c), dims=("y", "x"),
                attrs={"units": units, "long_name": long_name})
        f.define_dimension("inv_iter", len(res.misfits))
        f.write("inv_misfit", np.asarray(res.misfits), dims=("inv_iter",),
                attrs={"long_name": "inversion objective history"})
    log.message(1, "inverse done; final J = %.6e; state written to %s",
                float(res.misfits[-1]), out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
