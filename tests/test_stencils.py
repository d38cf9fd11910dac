import numpy as np
import jax.numpy as jnp
import pytest

from pism_tpu.grid import Grid
from pism_tpu.ops import stencils as st
from pism_tpu.ops.stencils import Shifter


def test_shift_clamped(rng):
    a = jnp.asarray(rng.normal(size=(5, 7)))
    b = st.shift(a, 0, 1)
    assert np.allclose(b[:, :-1], a[:, 1:])
    assert np.allclose(b[:, -1], a[:, -1])  # edge clamp
    c = st.shift(a, -1, 0)
    assert np.allclose(c[1:, :], a[:-1, :])
    assert np.allclose(c[0, :], a[0, :])


def test_shift_periodic(rng):
    a = jnp.asarray(rng.normal(size=(5, 7)))
    b = st.shift(a, 0, 2, periodic_x=True)
    assert np.allclose(b, np.roll(a, -2, axis=1))
    c = st.shift(a, -1, 0, periodic_y=True)
    assert np.allclose(c, np.roll(a, 1, axis=0))


def test_divergence_telescopes_to_boundary(rng):
    """Interior divergence of any staggered flux sums to the boundary flux
    (discrete divergence theorem) - the conservation property mass transport
    relies on."""
    grid = Grid(Mx=8, My=6, Lx=7e3 / 2, Ly=5e3 / 2)
    sh = Shifter(grid)
    QE = jnp.asarray(rng.normal(size=(6, 8)))
    QN = jnp.asarray(rng.normal(size=(6, 8)))
    # zero fluxes on the domain-boundary faces
    QE = QE.at[:, -1].set(0.0).at[:, 0].set(0.0)
    QN = QN.at[-1, :].set(0.0).at[0, :].set(0.0)
    div = st.div_staggered(QE, QN, grid.dx, grid.dy, sh)
    # with all boundary faces zero, total divergence telescopes to zero
    total = float(jnp.sum(div) * grid.dx * grid.dy)
    assert total == pytest.approx(0.0, abs=1e-6)


def test_gradients_linear_field_exact():
    grid = Grid(Mx=12, My=10, Lx=11e3 / 2, Ly=9e3 / 2)
    sh = Shifter(grid)
    X, Y = np.meshgrid(grid.x, grid.y)
    s = jnp.asarray(2.0 * X + 3.0 * Y)
    gx = st.grad_x_east(s, grid.dx, sh)
    gy = st.grad_y_east(s, grid.dy, sh)
    # interior faces exact
    assert np.allclose(gx[:, :-1], 2.0)
    assert np.allclose(gy[1:-1, :-1], 3.0)
    cx, cy = st.centered_grad(s, grid.dx, grid.dy, sh)
    assert np.allclose(cx[:, 1:-1], 2.0)
    assert np.allclose(cy[1:-1, :], 3.0)


def test_upwind_selects_donor():
    sh = Shifter(Grid(Mx=4, My=3, Lx=1.5e3, Ly=1e3))
    a = jnp.asarray([[1.0, 2.0, 3.0, 4.0]] * 3)
    u_pos = jnp.ones_like(a)
    u_neg = -jnp.ones_like(a)
    assert np.allclose(st.upwind_flux_east(u_pos, a, sh), a)
    assert np.allclose(st.upwind_flux_east(u_neg, a, sh)[:, :-1], -a[:, 1:])


def test_sia_diffusivity_limit():
    """PISM stress_balance.sia.limit_diffusivity: D (and the flux computed
    from it) is capped at max_diffusivity; the dt stability limit relaxes
    accordingly. The cap also scales the 3D shear column flux."""
    import numpy as np
    from pism_tpu import Config, Grid
    from pism_tpu.state import new_geometry
    from pism_tpu.ops import sia as sia_ops
    from pism_tpu.ops import sia3d
    from pism_tpu.ops.stencils import Shifter
    from pism_tpu.physics.rheology import flow_law_from_config
    from pism_tpu.physics.enthalpy_converter import EnthalpyConverter

    grid = Grid(Mx=31, My=31, Lx=150e3, Ly=150e3, Mz=9, Lz=4000.0)
    cfg = Config({"stress_balance.sia.flow_law": "isothermal_glen"})
    EC = EnthalpyConverter.from_config(cfg)
    law = flow_law_from_config(cfg, "sia", EC)
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / 100e3) ** 2 + (Y / 100e3) ** 2
    # sharp cliff margin: huge surface gradients -> huge uncapped D
    H = np.where(r2 < 0.5, 2500.0, 0.0)
    geom = new_geometry(jnp.asarray(H), jnp.zeros(grid.shape2))
    sh = Shifter(grid)

    free = sia_ops.diffusivity(law, geom, None, grid, sh)
    capped = sia_ops.diffusivity(law, geom, None, grid, sh, d_limit=100.0)
    assert float(free.max_D) > 1e3
    assert float(capped.max_D) <= 100.0 + 1e-9
    assert np.all(np.asarray(capped.De) <= 100.0 + 1e-9)
    # the flux uses the capped D: |q_capped| <= |q_free|, equal where the
    # cap is inactive
    qf, qc = np.asarray(free.qe), np.asarray(capped.qe)
    assert np.all(np.abs(qc) <= np.abs(qf) + 1e-12)
    inactive = np.asarray(free.De) < 99.0
    np.testing.assert_allclose(qc[inactive], qf[inactive], rtol=1e-12)

    # dt limit relaxes by the cap ratio
    dt_free = float(sia_ops.max_timestep_diffusivity(
        free.max_D, grid.dx, grid.dy))
    dt_cap = float(sia_ops.max_timestep_diffusivity(
        capped.max_D, grid.dx, grid.dy))
    assert dt_cap > 10.0 * dt_free

    # 3D velocities: column flux scaled to the same cap
    v_free = sia3d.sia_3d(law, geom, None, grid, sh)
    v_cap = sia3d.sia_3d(law, geom, None, grid, sh, max_diffusivity=100.0)
    assert float(v_cap.max_u) < float(v_free.max_u) / 10.0


def _np_shift(a, jy, ix):
    """numpy twin of ops.stencils.shift with edge-replication ghosts."""
    pad = [(max(-jy, 0), max(jy, 0)), (max(-ix, 0), max(ix, 0))] \
        + [(0, 0)] * (a.ndim - 2)
    p = np.pad(a, pad, mode="edge")
    My, Mx = a.shape[:2]
    j0, i0 = max(jy, 0), max(ix, 0)
    return p[j0:j0 + My, i0:i0 + Mx]


def test_sia_diffusivity_limit_thermo_matches_numpy(rng):
    """The d_limit cap on the thermomechanical SIA path agrees with an f64
    numpy reference of the Mahaffy scheme: staggered thickness, enthalpy
    and 4-point gradients, the trapezoid softness integral clipped to the
    ice column, D = 2 (rho g)^n |grad s|^(n-1) K capped at d_limit, and
    the flux from the capped D. The flow law enters as a black box."""
    from pism_tpu import Config, Grid
    from pism_tpu.state import new_geometry
    from pism_tpu.ops import sia as sia_ops
    from pism_tpu.ops.stencils import Shifter
    from pism_tpu.physics.rheology import flow_law_from_config
    from pism_tpu.physics.enthalpy_converter import EnthalpyConverter

    grid = Grid(Mx=24, My=20, Lx=120e3, Ly=100e3, Mz=7, Lz=4000.0)
    cfg = Config({})
    law = flow_law_from_config(cfg, "sia", EnthalpyConverter.from_config(cfg))
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / 90e3) ** 2 + (Y / 75e3) ** 2
    H = np.where(r2 < 0.6, 2200.0 * (1.0 - 0.5 * r2), 0.0)
    bed = 100.0 * np.sin(X / 30e3)
    E = rng.uniform(9.0e4, 1.05e5, size=(20, 24, 7))
    n, rho, g, d_limit = 3.0, 910.0, 9.81, 100.0

    geom = new_geometry(jnp.asarray(H), jnp.asarray(bed))
    got = sia_ops.diffusivity(law, geom, jnp.asarray(E), grid, Shifter(grid),
                              n=n, rho=rho, g=g, d_limit=d_limit)

    s = np.asarray(geom.ice_surface_elevation, np.float64)
    dx, dy = grid.dx, grid.dy
    sh = _np_shift
    sx_e = (sh(s, 0, 1) - s) / dx
    sy_e = (sh(s, 1, 0) + sh(s, 1, 1) - sh(s, -1, 0) - sh(s, -1, 1)) / (4 * dy)
    sx_n = (sh(s, 0, 1) + sh(s, 1, 1) - sh(s, 0, -1) - sh(s, 1, -1)) / (4 * dx)
    sy_n = (sh(s, 1, 0) - s) / dy
    z = np.asarray(grid.z, np.float64)

    def K(Hf, Ef):
        depth = np.maximum(Hf[..., None] - z, 0.0)
        p = np.asarray(law.EC.pressure(jnp.asarray(depth)))
        A = np.asarray(law.softness(jnp.asarray(Ef), jnp.asarray(p)))
        f = A * depth ** (n + 1.0)
        w = np.diff(np.minimum(z, Hf[..., None]), axis=-1)
        return np.sum(0.5 * (f[..., 1:] + f[..., :-1]) * w, axis=-1)

    C = 2.0 * (rho * g) ** n
    De = C * (sx_e ** 2 + sy_e ** 2) ** ((n - 1) / 2) \
        * K(0.5 * (H + sh(H, 0, 1)), 0.5 * (E + sh(E, 0, 1)))
    Dn = C * (sx_n ** 2 + sy_n ** 2) ** ((n - 1) / 2) \
        * K(0.5 * (H + sh(H, 1, 0)), 0.5 * (E + sh(E, 1, 0)))
    assert De.max() > 2 * d_limit and De[De > 0].min() < d_limit
    De, Dn = np.minimum(De, d_limit), np.minimum(Dn, d_limit)
    ref = {"De": De, "Dn": Dn, "qe": -De * sx_e, "qn": -Dn * sy_n}
    for name, a in ref.items():
        np.testing.assert_allclose(np.asarray(getattr(got, name)), a,
                                   rtol=1e-10, atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)
    assert float(got.max_D) == d_limit
