"""MISMIP3d grounding-line experiments (Pattyn et al. 2013).

The reference ships this intercomparison as run scripts under
``examples/mismip3d/``; this is the same protocol on this rebuild:

  Stnd  — spin a marine ice sheet on the linear bed b = -100 - x/1km to a
          steady grounding line (uniform Weertman friction C |u|^(1/3),
          expressed through the pseudo-plastic sliding law exactly as the
          reference does: q = 1/3, tau_c = C u_threshold^q).
  P75S  — reduce the basal friction by 75% in a Gaussian patch centered on
          the steady grounding line at the channel centerline
          (x_c = 150 km, y_c = 10 km) and run 100 years: the center GL
          advances, the lateral GL retreats (the curved-GL signature).
  P75R  — restore uniform friction and run on: the grounding line must
          return toward its Stnd position (reversibility, the key MISMIP3d
          result for marine-ice-sheet well-posedness).

Friction perturbations are prescribed through ``GivenYieldStress``
(-yield_stress given), the same mechanism the reference uses by writing a
``tauc`` field into the input file.

Usage: python examples/mismip3d.py [--dx-km 10] [--stnd-years 15000]
       [--recovery-years 2000] [--platform cpu] [--float32]
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

# MISMIP3d constants (Pattyn et al. 2013, Table 2)
A_3D = 1.0e-25            # Pa^-3 s^-1  (3.1536e-18 Pa^-3 a^-1)
C_3D = 1.0e7              # Pa m^-1/3 s^1/3
M_EXP = 1.0 / 3.0
ACC = 0.5 / SPY           # m/s
RHO_I, RHO_W, G = 900.0, 1000.0, 9.8
XC, YC, AMP = 150.0e3, 10.0e3, 0.75


def bed_3d(x):
    """b(x) = -100 - |x|/1000 m (divide at x = 0, symmetric half-domains)."""
    return -100.0 - np.abs(np.asarray(x)) / 1.0e3


def make_setup(dx, Lx=800.0e3, Ly=50.0e3, float32=False):
    import jax.numpy as jnp
    from pism_tpu import Config, Grid
    from pism_tpu.coupler.surface import FunctionSurface
    from pism_tpu.model.calving import CalvingModel
    from pism_tpu.state import ModelState, new_geometry
    from pism_tpu.verification.mismip import initial_profile

    Mx = int(round(2 * Lx / dx)) + 1
    My = 2 * int(round(Ly / dx)) + 1    # odd: a row on the centerline
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly)

    u_th = 100.0 / SPY
    tau_c0 = C_3D * u_th ** M_EXP

    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": A_3D,
        "constants.ice.density": RHO_I,
        "constants.sea_water.density": RHO_W,
        "constants.standard_gravity": G,
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": M_EXP,
        "basal_resistance.pseudo_plastic.u_threshold": 100.0,  # m/a
        "basal_yield_stress.model": "given",
        "energy.model": "none",
        "geometry.ice_free_thickness_standard": 0.01,
        "geometry.part_grid.enabled": True,
        "geometry.grounded_cell_fraction": True,
        "geometry.remove_icebergs": True,
        "calving.methods": "thickness_calving,ocean_kill",
        "calving.thickness_calving.threshold": 30.0,
        "stress_balance.ssa.fd.max_speed": 150.0e3,
        "time_stepping.maximum_time_step": 10.0,
        "runtime.float_dtype": "float32" if float32 else "float64",
    })

    bed = np.tile(bed_3d(grid.x)[None, :], (My, 1))
    # start near the Schoof semi-analytic steady state (GL ~ 606 km for
    # these parameters) so the spin-up resolves the approach, not a
    # 50-kyr advance transient
    H0 = np.tile(initial_profile(grid.x, H_divide=2000.0,
                                 margin=620.0e3)[None, :], (My, 1))
    geometry = new_geometry(jnp.asarray(H0), jnp.asarray(bed),
                            ice_density=RHO_I, ocean_density=RHO_W)

    def climate(geometry_, t):
        shp = geometry_.ice_thickness.shape
        dt_ = geometry_.ice_thickness.dtype
        return (jnp.full(shp, ACC, dt_), jnp.full(shp, 253.15, dt_))

    kill = np.abs(np.tile(grid.x[None, :], (My, 1))) > Lx - 2.5 * dx
    calving = CalvingModel(grid=grid, config=cfg,
                           ocean_kill_mask=jnp.asarray(kill))
    return grid, cfg, ModelState(geometry=geometry), \
        FunctionSurface(climate), calving, tau_c0


def tau_c_perturbed(grid, tau_c0, x_b):
    """P75S friction: C* = C (1 - 0.75 exp(-(x-x_b)^2/2xc^2 - y^2/2yc^2)),
    applied on both symmetric half-domains."""
    y, x = np.meshgrid(grid.y, grid.x, indexing="ij")
    a = AMP * (np.exp(-((x - x_b) ** 2) / (2 * XC ** 2)
                      - y ** 2 / (2 * YC ** 2))
               + np.exp(-((x + x_b) ** 2) / (2 * XC ** 2)
                        - y ** 2 / (2 * YC ** 2)))
    return tau_c0 * (1.0 - np.minimum(a, AMP))


def gl_x(state, grid, row):
    """Sub-grid grounding-line x on row ``row`` (x > 0 side)."""
    mask = np.asarray(state.geometry.cell_type)[row]
    frac = np.asarray(state.geometry.cell_grounded_fraction)[row]
    x = np.asarray(grid.x)
    sel = (mask == 2) & (x >= 0)
    if not sel.any():
        return 0.0
    i = np.where(sel)[0].max()
    dx = grid.dx
    # extend by the grounded fraction of the next (partially grounded) cell
    f = frac[i + 1] if i + 1 < x.size else 0.0
    return float(x[i] + f * dx)


def run_phase(model, state, years, label):
    import time as _time
    from pism_tpu import Time
    tic = _time.time()
    state, stats = model.run(state, Time(0.0, years * SPY))
    print(f"  {label}: {years:.0f} a in {_time.time() - tic:.1f} s "
          f"({int(stats.nsteps)} steps)")
    return state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dx-km", type=float, default=10.0)
    ap.add_argument("--stnd-years", type=float, default=15000.0)
    ap.add_argument("--perturb-years", type=float, default=100.0)
    ap.add_argument("--recovery-years", type=float, default=2000.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.physics.basal import GivenYieldStress

    grid, cfg, state, surface, calving, tau_c0 = make_setup(
        args.dx_km * 1e3, float32=args.float32)
    mid, edge = grid.My // 2, 0
    uniform = GivenYieldStress(
        cfg, tau_c=np.full(grid.shape2, tau_c0))

    def model_with(ys):
        return IceModel(grid=grid, config=cfg, surface=surface,
                        calving=calving, yield_stress=ys)

    print(f"MISMIP3d at dx = {args.dx_km:g} km "
          f"({grid.Mx}x{grid.My}); tau_c0 = {tau_c0:.0f} Pa; "
          f"Schoof semi-analytic steady GL ~ 606 km")
    m = model_with(uniform)
    state = run_phase(m, state, args.stnd_years, "Stnd ")
    gl_stnd = gl_x(state, grid, mid)
    print(f"  Stnd grounding line: x = {gl_stnd / 1e3:.1f} km")

    pert = GivenYieldStress(
        cfg, tau_c=tau_c_perturbed(grid, tau_c0, gl_stnd))
    state = run_phase(model_with(pert), state, args.perturb_years, "P75S ")
    gl_c, gl_e = gl_x(state, grid, mid), gl_x(state, grid, edge)
    print(f"  P75S grounding line: center {gl_c / 1e3:.1f} km, "
          f"edge {gl_e / 1e3:.1f} km (center - edge = "
          f"{(gl_c - gl_e) / 1e3:.1f} km)")

    state = run_phase(model_with(uniform), state, args.recovery_years,
                      "P75R ")
    gl_r = gl_x(state, grid, mid)
    print(f"  P75R grounding line: x = {gl_r / 1e3:.1f} km "
          f"(Stnd {gl_stnd / 1e3:.1f} km; residual "
          f"{abs(gl_r - gl_stnd) / 1e3:.2f} km)")

    print(json.dumps({
        "dx_km": args.dx_km,
        "gl_stnd_km": gl_stnd / 1e3,
        "gl_p75s_center_km": gl_c / 1e3,
        "gl_p75s_edge_km": gl_e / 1e3,
        "gl_p75r_km": gl_r / 1e3,
        "reversibility_residual_km": abs(gl_r - gl_stnd) / 1e3,
    }))


if __name__ == "__main__":
    main()
