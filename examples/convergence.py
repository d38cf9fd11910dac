"""Verification convergence sweep (the role of the reference's
``test/vfnow.py``): run each available exact/manufactured test over a
refinement ladder and print an error-norm + convergence-rate table.

Covers: Halfar similarity test B (SIA mass transport), exact test I
(SSAFD and SSAFEM plastic-till stream), the manufactured nonlinear SSA
(periodic, full operator), and the manufactured thermo-coupled SIA
(enthalpy + flow coupling, the role of tests F/G).

Usage: python examples/convergence.py [--platform cpu] [--fast]
"""

import os as _os
import sys as _sys

# runnable as `python examples/<name>.py` without installing
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
from pism_tpu.util.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import argparse
import math


def rate_table(name, pairs, unit):
    print(f"\n{name}  (error [{unit}]; rate = log2(e_coarse/e_fine))")
    print(f"  {'N':>6} {'error':>12} {'rate':>6}")
    prev = None
    for N, e in pairs:
        r = f"{math.log2(prev / e):5.2f}" if prev else "    -"
        print(f"  {N:>6} {e:12.5g} {r:>6}")
        prev = e


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="skip the finest level of each ladder")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np

    SPY = 3.15569259747e7

    # -- Halfar test B (SIA + mass transport) -------------------------------
    from pism_tpu import Config, Grid, Time, new_geometry
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.state import ModelState
    from pism_tpu.coupler.surface import Uniform
    from pism_tpu.verification import halfar

    sol = halfar.test_B()
    rows = []
    for Mx in ([31, 61] if args.fast else [31, 61, 121]):
        grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
        cfg = Config({"stress_balance.model": "sia",
                      "stress_balance.sia.flow_law": "isothermal_glen",
                      "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
                      "energy.model": "none"})
        state = ModelState(geometry=new_geometry(
            jnp.asarray(sol.thickness(sol.t0, grid.radius)),
            jnp.zeros(grid.shape2)))
        model = IceModel(grid=grid, config=cfg, surface=Uniform(smb=0.0))
        t1 = sol.t0 + 1000.0 * SPY
        state, _ = model.run(state, Time(sol.t0, t1))
        errs = halfar.error_norms(np.asarray(state.geometry.ice_thickness),
                                  sol.thickness(t1, grid.radius))
        rows.append((Mx, errs["avg_H"]))
    rate_table("Halfar test B (avg |dH|)", rows, "m")

    # -- exact test I (SSAFD / SSAFEM) ---------------------------------------
    from pism_tpu.model.ssa import SSAFD
    from pism_tpu.model.ssafem import SSAFEM
    from pism_tpu.physics.rheology import IsothermalGlen
    from pism_tpu.verification.ssa_exact import ExactI

    ti = ExactI()
    for cls, label in ((SSAFD, "SSAFD"), (SSAFEM, "SSAFEM")):
        rows = []
        for My in ([31, 61] if args.fast else [31, 61, 121]):
            grid = Grid(Mx=11, My=My, Lx=10e3, Ly=60e3, periodicity="x")
            cfg = Config()
            tau_c = jnp.asarray(np.tile(ti.tau_c(grid.y)[:, None], (1, 11)))
            law = IsothermalGlen(A=float(ti.B) ** -3.0)
            geom = new_geometry(jnp.full(grid.shape2, ti.H0),
                                jnp.zeros(grid.shape2))
            bc = np.zeros(grid.shape2, bool)
            bc[0, :] = bc[-1, :] = True
            ssa = cls(grid=grid, config=cfg, flow_law=law,
                      bc_mask=jnp.asarray(bc),
                      bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2),
                      taud_x=jnp.full(grid.shape2, ti.f),
                      taud_y=jnp.zeros(grid.shape2))
            u, _ = ssa.solve(ModelState(geometry=geom), tau_c)
            err = np.abs(np.asarray(u)[:, 5] - ti.velocity(grid.y)) * SPY
            rows.append((My, float(err.max())))
        rate_table(f"exact test I ({label}, max |du|)", rows, "m/a")

    # -- manufactured nonlinear SSA ------------------------------------------
    from pism_tpu.verification.ssa_manufactured import ManufacturedSSA

    m = ManufacturedSSA()
    rows = []
    for Mx in ([33, 65] if args.fast else [33, 65, 129]):
        e, _ = m.solve_on(Mx)
        rows.append((Mx, e * SPY))
    rate_table("manufactured nonlinear SSA (max |du|)", rows, "m/a")

    # -- manufactured thermo-coupled SIA (tests F/G role) --------------------
    from pism_tpu.verification.manufactured import ManufacturedThermoSIA

    mt = ManufacturedThermoSIA()
    rows = []
    for Mx in [31, 61] if args.fast else [31, 61, 91]:
        grid = Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3, Mz=31, Lz=3500.0)
        cfg = Config({"stress_balance.model": "sia",
                      "stress_balance.sia.flow_law": "pb",
                      "energy.model": "none"})
        state, surface = mt.setup(grid, cfg)
        model = IceModel(grid=grid, config=cfg, surface=surface)
        t1 = 200.0 * SPY
        state, _ = model.run(state, Time(0.0, t1))
        H = np.asarray(state.geometry.ice_thickness)
        He = np.asarray(mt.thickness(jnp.asarray(grid.radius)))
        rows.append((Mx, float(np.abs(H - He).mean())))
    rate_table("manufactured thermo-SIA (avg |dH| after 200 a)", rows, "m")


if __name__ == "__main__":
    main()
