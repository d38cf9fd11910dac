"""SSA stress-balance tests: exact test I (Schoof plastic-till stream),
grid convergence, and floating-shelf behavior."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pism_tpu import Config, Grid
from pism_tpu.state import ModelState, new_geometry
from pism_tpu.model.ssa import SSAFD
from pism_tpu.physics.rheology import IsothermalGlen
from pism_tpu.verification.ssa_exact import ExactI

SPY = 3.15569259747e7


def _solve_test_I(My, Mx=11):
    ti = ExactI()
    grid = Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    tau_c = jnp.asarray(np.tile(ti.tau_c(grid.y)[:, None], (1, Mx)))
    # exact-solution verification: run fully converged, not at the
    # production velocity-change stop; the plastic-till drag dominates this
    # problem, so use the exact d(beta u)/du Jacobian — the frozen-beta
    # linearization contracts at ~(1 - membrane/tau_c) per sweep and
    # stagnates orders of magnitude above the true discrete solution
    cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
                  "stress_balance.ssa.fd.drag_jacobian": "exact"})
    law = IsothermalGlen(A=float(ti.B) ** -3.0)
    geom = new_geometry(jnp.full(grid.shape2, ti.H0), jnp.zeros(grid.shape2))
    state = ModelState(geometry=geom)
    bc = np.zeros(grid.shape2, bool)
    bc[0, :] = bc[-1, :] = True
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc),
                bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2),
                taud_x=jnp.full(grid.shape2, ti.f),
                taud_y=jnp.zeros(grid.shape2))
    u, v = jax.jit(lambda s: ssa.solve(s, tau_c))(state)
    return ti, grid, np.asarray(u), np.asarray(v)


def test_I_exact_stream():
    ti, grid, u, v = _solve_test_I(61)
    uex = ti.velocity(grid.y)
    err = np.abs(u[:, 5] - uex) * SPY
    assert u[:, 5].max() * SPY == pytest.approx(777.5, rel=0.02)
    assert err.max() < 10.0      # m/a on a ~780 m/a stream
    assert np.abs(v).max() * SPY < 0.05   # ~1e-5 of the stream speed


def test_I_convergence():
    errs = []
    for My in (31, 61):
        ti, grid, u, v = _solve_test_I(My)
        uex = ti.velocity(grid.y)
        errs.append(np.abs(u[:, 5] - uex).max() * SPY)
    assert errs[1] < 0.7 * errs[0]


def test_floating_shelf_no_drag():
    """A confined floating shelf with uniform thickness: zero driving
    stress (flat surface) => velocity stays at the Dirichlet inflow value;
    with a thickness gradient the shelf accelerates downstream."""
    Mx, My = 41, 11
    grid = Grid(Mx=Mx, My=My, Lx=100e3, Ly=25e3, periodicity="y")
    cfg = Config()
    law = IsothermalGlen(A=1e-25)
    # thickness ramp 600 -> 200 m along +x, floating over deep ocean
    Hx = np.linspace(600.0, 200.0, Mx)
    H = jnp.asarray(np.tile(Hx[None, :], (My, 1)))
    bed = jnp.full(grid.shape2, -2000.0)
    geom = new_geometry(H, bed)
    assert bool((np.asarray(geom.cell_type) == 3).all())  # all floating
    state = ModelState(geometry=geom)
    bc = np.zeros(grid.shape2, bool)
    bc[:, 0] = True   # inflow velocity 100 m/a
    u_in = np.zeros(grid.shape2)
    u_in[:, 0] = 100.0 / SPY
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_in),
                bc_v=jnp.zeros(grid.shape2))
    u, v = jax.jit(lambda s: ssa.solve(s, None))(state)
    u = np.asarray(u) * SPY
    # accelerates monotonically downstream along the centerline interior
    c = My // 2
    assert u[c, 1] > 90.0
    assert np.all(np.diff(u[c, 1:-1]) > -1e-6)
    assert u[c, -2] > 2 * u[c, 1]


def test_operator_positive_definite(rng):
    from pism_tpu.ops import ssa as ssa_ops
    from pism_tpu.ops.stencils import Shifter
    g = Grid(Mx=16, My=12, Lx=80e3, Ly=60e3)
    sh = Shifter(g)
    nuH = ssa_ops.NuH(e=jnp.asarray(rng.uniform(1e13, 1e15, g.shape2)),
                      n=jnp.asarray(rng.uniform(1e13, 1e15, g.shape2)))
    beta = jnp.asarray(rng.uniform(1e3, 1e9, g.shape2))
    for _ in range(5):
        x = (jnp.asarray(rng.normal(size=g.shape2)),
             jnp.asarray(rng.normal(size=g.shape2)))
        Ax = ssa_ops.apply_operator(x[0], x[1], nuH, beta, g.dx, g.dy, sh)
        xAx = float(sum(jnp.sum(a * b) for a, b in zip(Ax, x)))
        assert xAx > 0.0


def test_operator_jvp_is_bilinear(rng):
    """A(u, v; nuH, beta) is linear in the velocities and in the
    coefficients separately, so its JVP in all five arguments is
    A(du, dv; nuH, beta) + A(u, v; dnuH, dbeta) — the rule the Newton
    linearization relies on through plain autodiff."""
    from pism_tpu.ops import ssa as ssa_ops
    from pism_tpu.ops.stencils import Shifter
    g = Grid(Mx=16, My=12, Lx=80e3, Ly=60e3)
    sh = Shifter(g)

    def fld(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, g.shape2))

    def op(u, v, e, n, beta):
        return ssa_ops.apply_operator(u, v, ssa_ops.NuH(e, n), beta,
                                      g.dx, g.dy, sh)

    primals = (fld(-1e-5, 1e-5), fld(-1e-5, 1e-5), fld(1e13, 1e15),
               fld(1e13, 1e15), fld(1e3, 1e9))
    tangents = (fld(-1e-6, 1e-6), fld(-1e-6, 1e-6), fld(-1e12, 1e12),
                fld(-1e12, 1e12), fld(-1e7, 1e7))
    out, tan = jax.jvp(op, primals, tangents)
    u, v, e, n, beta = primals
    du, dv, de, dn, dbeta = tangents
    rule = [a + b for a, b in zip(op(du, dv, e, n, beta),
                                  op(u, v, de, dn, dbeta))]
    for t, r, o in zip(tan, rule, op(*primals)):
        np.testing.assert_allclose(np.asarray(t), np.asarray(r), rtol=1e-12,
                                   atol=1e-12 * float(jnp.abs(r).max()))
    for a, b in zip(out, op(*primals)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_krylov_solvers_agree(rng):
    """CG and BiCGStab agree on a mildly nonsymmetric SSA system."""
    from pism_tpu.ops import ssa as ssa_ops
    from pism_tpu.ops.stencils import Shifter
    g = Grid(Mx=16, My=12, Lx=80e3, Ly=60e3)
    sh = Shifter(g)
    nuH = ssa_ops.NuH(e=jnp.full(g.shape2, 1e14), n=jnp.full(g.shape2, 1e14))
    beta = jnp.full(g.shape2, 1e8)
    b = (jnp.asarray(rng.normal(size=g.shape2) * 1e4),
         jnp.asarray(rng.normal(size=g.shape2) * 1e4))

    def matvec(x):
        return ssa_ops.apply_operator(x[0], x[1], nuH, beta, g.dx, g.dy, sh)

    du, dv = ssa_ops.operator_diagonal(nuH, beta, g.dx, g.dy, sh)

    def precond(r):
        return (r[0] / du, r[1] / dv)

    x0 = (jnp.zeros(g.shape2), jnp.zeros(g.shape2))
    xc, itc, rc = ssa_ops.cg_solve(matvec, b, x0, precond, rtol=1e-10)
    xb, itb, rb = ssa_ops.bicgstab_solve(matvec, b, x0, precond, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(xc[0]), np.asarray(xb[0]), rtol=1e-6)
    assert int(itc) < 300 and int(itb) < 300


def test_mixed_precision_iterative_refinement():
    """solve_dtype=mixed (f64 iterate + outer residual, f32 Krylov) must
    CONVERGE (F below the Newton tolerance, not a stagnation exit) and
    match the float64-island velocities to ~1e-6 on a grounding-line
    problem with a floating shelf (strong nuH contrast). A pure-f32 solve
    stalls at the f32 cancellation floor of the operator (~1e-4 relative);
    iterative refinement is what breaks through it."""
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.verification import mismip

    res = {}
    for sd in ("float64", "mixed"):
        ms = mismip.setup(Mx=151, My=7)
        ms.config.update({"stress_balance.ssa.fd.solve_dtype": sd,
                          "runtime.float_dtype": "float32",
                          # this test verifies convergence to the NEWTON
                          # tolerance, so disable the production
                          # velocity-change early stop
                          "stress_balance.ssa.fd.velocity_change_rtol": 0.0})
        model = IceModel(grid=ms.grid, config=ms.config, surface=ms.surface)
        state = model.prepare_state(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
            ms.state))
        tau_c = model.yield_stress.compute(state)
        u, v, info = jax.jit(
            lambda s, tc: model.ssa.solve(s, tc, diagnostics=True))(state, tau_c)
        assert float(info["F2_final"]) <= float(info["tol2"]) * 1.01, sd
        res[sd] = np.asarray(u)
        assert u.dtype == jnp.float32
    rel = np.abs(res["mixed"] - res["float64"]).max() / \
        np.abs(res["float64"]).max()
    assert rel < 5e-6


def test_solver_trace_and_production_floor():
    """The diagnostics trace records one row per Newton sweep, and the
    production configuration (velocity-change stop ON, mixed precision)
    reaches its Newton tolerance rather than exiting on stagnation — the
    mixed pre-polish floor is 3e-5 relative, so the target must be
    attainable (a tighter, unreachable target makes every solve run to
    stagnation through ksp_max-iteration breakdown sweeps)."""
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.verification import mismip

    ms = mismip.setup(Mx=151, My=7)
    ms.config.update({"stress_balance.ssa.fd.solve_dtype": "mixed",
                      "runtime.float_dtype": "float32"})
    model = IceModel(grid=ms.grid, config=ms.config, surface=ms.surface)
    state = model.prepare_state(jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
        ms.state))
    tau_c = model.yield_stress.compute(state)
    u, v, info = jax.jit(
        lambda s, tc: model.ssa.solve(s, tc, diagnostics=True))(state, tau_c)
    n = int(info["newton_iters"])
    tr = info["trace"]
    assert n >= 1
    f2 = np.asarray(tr["F2_rel"])
    kr = np.asarray(tr["krylov"])
    assert np.isfinite(f2[:n]).all() and np.isnan(f2[n:]).all()
    assert int(kr[:n].sum()) == int(info["krylov_iters"])
    # last recorded row matches the final state of the loop
    assert float(f2[n - 1]) == pytest.approx(
        float(info["F2_final"] / info["b_norm2"]), rel=1e-12)
    # the production target is the attainable mixed floor (3e-5 relative)
    assert float(info["tol2"] / info["b_norm2"]) >= (3.0e-5) ** 2 * 0.99


def test_fracture_softening_speeds_up_shelf():
    """Fracture-induced softening (reference: SSAFD::compute_nuH applies
    hardness *= max(1-(1-eps)*phi, eps) when
    fracture_density.softening_lower_limit = eps < 1): a fractured shelf
    flows faster than intact ice; eps = 1 leaves the solution unchanged."""
    Mx, My = 41, 11
    grid = Grid(Mx=Mx, My=My, Lx=100e3, Ly=25e3, periodicity="y")
    law = IsothermalGlen(A=1e-25)
    Hx = np.linspace(600.0, 200.0, Mx)
    H = jnp.asarray(np.tile(Hx[None, :], (My, 1)))
    geom = new_geometry(H, jnp.full(grid.shape2, -2000.0))
    phi = jnp.full(grid.shape2, 0.5)

    bc = np.zeros(grid.shape2, bool)
    bc[:, 0] = True
    u_in = np.zeros(grid.shape2)
    u_in[:, 0] = 100.0 / SPY

    def speed(soft_min, with_phi=True):
        cfg = Config({"fracture_density.enabled": True,
                      "fracture_density.softening_lower_limit": soft_min})
        state = ModelState(geometry=geom,
                           fracture_density=phi if with_phi else None)
        ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                    bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_in),
                    bc_v=jnp.zeros(grid.shape2))
        u, v = jax.jit(lambda s: ssa.solve(s, None))(state)
        return np.asarray(u)[My // 2, -2] * SPY

    u_intact = speed(1.0)
    u_soft = speed(0.1)
    # hardness multiplier 1-(1-0.1)*0.5 = 0.55 -> softness x (1/0.55)^3 ~ 6
    assert u_soft > 1.5 * u_intact
    # eps = 1 disables the feedback entirely
    assert speed(1.0, with_phi=False) == pytest.approx(u_intact, rel=1e-12)


def _solve_test_V(Mx, front_frac=0.85):
    """Van der Veen shelf (PISM test V): prescribed exact thickness,
    Dirichlet inflow at x=0, calving front inside the domain."""
    from pism_tpu.verification.ssa_exact import ExactV

    tv = ExactV()
    My = 5
    L = 300e3
    grid = Grid(Mx=Mx, My=My, Lx=L / 2, Ly=50e3, periodicity="y")
    x = np.asarray(grid.x) + L / 2          # 0 .. L
    jf = int(front_frac * Mx)               # front column
    H = np.zeros(grid.shape2)
    H[:, :jf] = np.tile(tv.thickness(x[:jf])[None, :], (My, 1))
    geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -3000.0))
    cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0})
    law = IsothermalGlen(A=float(tv.B) ** -3.0)
    bc = np.zeros(grid.shape2, bool)
    bc[:, 0] = True
    u_in = np.zeros(grid.shape2)
    u_in[:, 0] = tv.velocity(x[0])
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_in),
                bc_v=jnp.zeros(grid.shape2))
    u, v = jax.jit(lambda s: ssa.solve(s, None))(
        ModelState(geometry=geom))
    return tv, x, jf, np.asarray(u), np.asarray(v)


def test_V_van_der_veen_shelf():
    tv, x, jf, u, v = _solve_test_V(101)
    uex = tv.velocity(x[:jf]) * SPY
    uc = u[2, :jf] * SPY
    rel = np.abs(uc - uex) / uex
    # interior matches the closed form; the last column feels the discrete
    # front, so measure up to one cell short of it
    assert rel[: jf - 1].max() < 0.03
    assert np.abs(v[2, :jf]).max() * SPY < 1.0
    # speeds grow monotonically toward the front
    assert np.all(np.diff(uc[: jf - 1]) > 0)


def test_V_convergence():
    errs = []
    for Mx in (51, 101):
        tv, x, jf, u, v = _solve_test_V(Mx)
        uex = tv.velocity(x[:jf])
        errs.append(float(np.abs(u[2, : jf - 1] / uex[: jf - 1] - 1).max()))
    assert errs[1] < 0.6 * errs[0]


def _solve_test_M(Mx, outer="dirichlet"):
    """Annular shelf (test M role): exact-profile Dirichlet ring at the
    grounding line; the outer edge is either an exact-profile Dirichlet
    ring (isolates the interior operator; converges) or the staircase
    calving front with the CFBC (outer="cfbc")."""
    from pism_tpu.verification.ssa_exact import ExactM

    tm = ExactM()
    grid = Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3)
    X, Y = np.meshgrid(np.asarray(grid.x), np.asarray(grid.y))
    R = np.hypot(X, Y)
    Rs = np.maximum(R, 1.0)
    u_ex = tm.velocity(R)
    # Dirichlet rings carry the exact profile at each cell's true radius
    # (the reference's SSATestCase pattern: exact values as BC)
    bc = R <= tm.Rg + 1.0 * grid.dx
    if outer == "dirichlet":
        H = np.full(grid.shape2, tm.H0m)
        bc = bc | (R >= tm.Rc - 1.5 * grid.dx)
    else:
        H = np.where(R <= tm.Rc, tm.H0m, 0.0)
    geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -3000.0))
    u_bc = np.where(bc, u_ex * X / Rs, 0.0)
    v_bc = np.where(bc, u_ex * Y / Rs, 0.0)
    cfg = Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0})
    law = IsothermalGlen(A=float(tm.B) ** -3.0)
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_bc),
                bc_v=jnp.asarray(v_bc))
    u, v = jax.jit(lambda s: ssa.solve(s, None))(ModelState(geometry=geom))
    return tm, grid, R, np.asarray(u), np.asarray(v)


def test_M_annular_shelf_radial():
    """2D SSAFD vs the radial ODE along the +x ray, and isotropy: the
    speed profile along x, y, and the diagonal must agree (the Cartesian
    discretization must not prefer an axis)."""
    tm, grid, R, u, v = _solve_test_M(61)
    c = grid.My // 2
    x = np.asarray(grid.x)
    sel = (x > tm.Rg + 50e3) & (x < tm.Rc - 60e3)
    u_num = u[c, sel] * SPY
    u_ex = tm.velocity(x[sel]) * SPY
    rel = np.abs(u_num - u_ex) / u_ex
    assert rel.max() < 0.03

    # isotropy: same profile along +y and the diagonal
    spd = np.hypot(u, v) * SPY
    along_y = spd[sel, c]   # grid is square: same selection indices
    assert np.abs(along_y - u_num).max() < 0.02 * u_ex.max()
    ii = np.where(sel)[0]
    for i in ii[:: max(len(ii) // 4, 1)]:
        # diagonal sample at the same radius r = sqrt(2)|x_d|
        r_i = abs(x[i])
        d = int(round(r_i / np.sqrt(2.0) / grid.dx))
        jd, id_ = c + d, c + d
        r_d = R[jd, id_]
        if tm.Rg + 50e3 < r_d < tm.Rc - 60e3:
            assert abs(spd[jd, id_] - tm.velocity(r_d) * SPY) \
                < 0.05 * tm.velocity(r_d) * SPY


def test_M_staircase_front_cfbc():
    """With the true staircase calving front + CFBC the solution is
    systematically fast by ~10% (diagonal front faces over-apply the
    pressure-imbalance term — the same artifact the reference shows on
    circular fronts); pin that behavior as a tolerance band so
    regressions in the front treatment are caught."""
    tm, grid, R, u, v = _solve_test_M(61, outer="cfbc")
    c = grid.My // 2
    x = np.asarray(grid.x)
    sel = (x > tm.Rg + 50e3) & (x < tm.Rc - 30e3)
    rel = u[c, sel] / tm.velocity(x[sel]) - 1.0
    assert rel.max() < 0.18 and rel.min() > -0.05


@pytest.mark.slow
def test_M_convergence():
    errs = []
    for Mx in (41, 81):
        tm, grid, R, u, v = _solve_test_M(Mx)
        c = grid.My // 2
        x = np.asarray(grid.x)
        sel = (x > tm.Rg + 50e3) & (x < tm.Rc - 60e3)
        u_ex = tm.velocity(x[sel])
        errs.append(float(np.abs(u[c, sel] / u_ex - 1.0).max()))
    assert errs[1] < 0.7 * errs[0]


def test_melange_back_pressure_slows_front():
    """Melange back pressure (reference ocean::Frac_MBP / Delta_MBP):
    raising the water-column pressure at the calving front weakens the
    CFBC spreading stress; with fraction 1 the pressure imbalance vanishes
    and the unconfined shelf barely spreads beyond its inflow speed."""
    from pism_tpu.coupler.ocean import (Constant, DeltaMBP, FracMBP,
                                        hydrostatic_water_column_pressure)

    Mx, My = 31, 11
    grid = Grid(Mx=Mx, My=My, Lx=75e3, Ly=25e3, periodicity="y")
    cfg = Config()
    law = IsothermalGlen(A=1e-25)
    H = np.full(grid.shape2, 400.0)
    H[:, -6:] = 0.0                       # open ocean beyond the front
    geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -2000.0))
    state = ModelState(geometry=geom)
    bc = np.zeros(grid.shape2, bool)
    bc[:, 0] = True
    u_in = np.zeros(grid.shape2)
    u_in[:, 0] = 100.0 / SPY
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(u_in),
                bc_v=jnp.zeros(grid.shape2))
    ocean = Constant(config=cfg)

    def front_speed(wcp):
        u, v = jax.jit(lambda s: ssa.solve(s, None,
                                           water_column_pressure=wcp))(state)
        return float(np.asarray(u)[My // 2, Mx - 7] * SPY)

    base = front_speed(None)
    # fraction 0 reproduces the hydrostatic default
    lam0 = FracMBP(inner=ocean, fraction=lambda t: 0.0)
    same = front_speed(lam0.water_column_pressure(geom, 0.0))
    assert same == pytest.approx(base, rel=1e-6)
    # explicit hydrostatic pressure also reproduces the default
    same2 = front_speed(hydrostatic_water_column_pressure(geom))
    assert same2 == pytest.approx(base, rel=1e-6)
    # full melange support kills the spreading
    lam1 = FracMBP(inner=ocean, fraction=lambda t: 1.0)
    held = front_speed(lam1.water_column_pressure(geom, 0.0))
    assert base > 150.0                      # spreads freely by default
    assert held < 0.25 * base                # nearly no spreading
    # intermediate support in between, monotone
    lam05 = FracMBP(inner=ocean, fraction=lambda t: 0.5)
    mid = front_speed(lam05.water_column_pressure(geom, 0.0))
    assert held < mid < base
    # a positive scalar offset also slows the front
    dmbp = DeltaMBP(inner=ocean, offset=lambda t: 2.0e5)
    slowed = front_speed(dmbp.water_column_pressure(geom, 0.0))
    assert held < slowed < base


def _solve_test_N(Mx):
    """Bodvardsson plastic-till marine ice stream (test N role): exact
    parabolic thickness + exact tau_c prescribed, u = 0 pinned at the
    divide, calving front inside the domain. Drag dominates the membrane
    term here, so the solver needs the exact plastic-drag Jacobian (the
    frozen-beta Picard linearization contracts at ~(1 - membrane/tau_c)
    per sweep and stalls)."""
    from pism_tpu.verification.ssa_exact import ExactN

    tn = ExactN()
    My = 5
    grid = Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
    x = np.asarray(grid.x)
    H = np.tile(tn.thickness(x)[None, :], (My, 1))
    tau = np.tile(tn.tau_c(x)[None, :], (My, 1))
    geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -tn.depth))
    bc = np.zeros(grid.shape2, bool)
    bc[:, Mx // 2] = True
    cfg = Config({"stress_balance.ssa.fd.drag_jacobian": "exact",
                  "stress_balance.ssa.fd.velocity_change_rtol": 0.0})
    ssa = SSAFD(grid=grid, config=cfg,
                flow_law=IsothermalGlen(A=float(tn.B) ** -3.0),
                bc_mask=jnp.asarray(bc),
                bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2))
    u, v, info = ssa.solve(ModelState(geometry=geom), jnp.asarray(tau),
                           diagnostics=True)
    return tn, grid, x, np.asarray(u), np.asarray(v), info


def test_N_exact_stream():
    tn, grid, x, u, v, info = _solve_test_N(111)
    # exact-Jacobian Newton converges in a handful of sweeps (the Picard
    # linearization needs hundreds here)
    assert int(info["newton_iters"]) < 20
    uex = tn.velocity(x)
    sel = np.abs(x) <= tn.xc - 2 * grid.dx
    rel = np.abs(u[2] - uex)[sel].max() / uex.max()
    assert rel < 0.08
    assert np.abs(v).max() * SPY < 1.0
    # odd symmetry about the divide
    np.testing.assert_allclose(u[2], -u[2, ::-1], atol=1e-4 * uex.max())


def test_N_convergence():
    errs = []
    for Mx in (111, 221):
        tn, grid, x, u, v, _ = _solve_test_N(Mx)
        uex = tn.velocity(x)
        sel = np.abs(x) <= tn.xc - 2 * grid.dx
        errs.append(np.abs(u[2] - uex)[sel].mean())
    assert errs[1] < 0.65 * errs[0]


def test_exact_solution_is_discrete_solution_N():
    """The exact (H, u, tau_c) triple satisfies the discrete SSA residual
    to near round-off — validates the derivation independently of the
    nonlinear solver."""
    from pism_tpu.verification.ssa_exact import ExactN

    tn = ExactN()
    Mx, My = 111, 5
    grid = Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
    x = np.asarray(grid.x)
    H = np.tile(tn.thickness(x)[None, :], (My, 1))
    tau = np.tile(tn.tau_c(x)[None, :], (My, 1))
    geom = new_geometry(jnp.asarray(H), jnp.full(grid.shape2, -tn.depth))
    bc = np.zeros(grid.shape2, bool)
    bc[:, Mx // 2] = True
    ssa = SSAFD(grid=grid, config=Config(),
                flow_law=IsothermalGlen(A=float(tn.B) ** -3.0),
                bc_mask=jnp.asarray(bc),
                bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2))
    P = ssa.build_problem(ModelState(geometry=geom), jnp.asarray(tau))
    uex = jnp.asarray(np.tile(tn.velocity(x)[None, :], (My, 1)))
    ru, rv = P["residual"]((uex, jnp.zeros_like(uex)))
    # residual ~1e-3 Pa on the interior (front cells feel the staircase
    # front) vs a ~2.4e4 Pa driving-stress scale
    interior = np.abs(x) <= tn.xc - 2 * grid.dx
    assert np.abs(np.asarray(ru)[2][interior]).max() < 0.05


def test_warm_start_skips_continuation_warmup():
    """A warm start (previous converged velocity) must skip the Picard
    drag-continuation warmup - its nearly-linear-drag first sweeps move a
    converged iterate AWAY from the solution (round-3 trace: initial
    F2/b2 jumped to ~30, ~12 recovery sweeps) - while a cold start keeps
    it. Production config (velocity-change stop active)."""
    ti = ExactI()
    Mx, My = 11, 31
    grid = Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    tau_c = jnp.asarray(np.tile(ti.tau_c(grid.y)[:, None], (1, Mx)))
    cfg = Config({})     # production defaults
    law = IsothermalGlen(A=float(ti.B) ** -3.0)
    geom = new_geometry(jnp.full(grid.shape2, ti.H0), jnp.zeros(grid.shape2))
    state = ModelState(geometry=geom)
    bc = np.zeros(grid.shape2, bool)
    bc[0, :] = bc[-1, :] = True
    ssa = SSAFD(grid=grid, config=cfg, flow_law=law,
                bc_mask=jnp.asarray(bc),
                bc_u=jnp.zeros(grid.shape2), bc_v=jnp.zeros(grid.shape2),
                taud_x=jnp.full(grid.shape2, ti.f),
                taud_y=jnp.zeros(grid.shape2))
    solve = jax.jit(lambda s, u0, v0: ssa.solve(s, tau_c, u0=u0, v0=v0,
                                                diagnostics=True))
    zero = jnp.zeros(grid.shape2)
    u, v, cold = solve(state, zero, zero)
    assert not bool(cold["warmup_skipped"])      # cold: |F(0)| = |b|
    assert float(cold["F2_warmstart"]) == pytest.approx(
        float(cold["b_norm2"]), rel=1e-6)
    u2, v2, warm = solve(state, u, v)
    assert bool(warm["warmup_skipped"])
    assert float(warm["F2_warmstart"]) < 0.25 * float(warm["b_norm2"])
    assert int(warm["newton_iters"]) <= int(cold["newton_iters"])
    # the warm re-solve stays at the converged stream speed
    assert np.asarray(u2)[:, 5].max() * SPY == pytest.approx(
        np.asarray(u)[:, 5].max() * SPY, rel=1e-3)
