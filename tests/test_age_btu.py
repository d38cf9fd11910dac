"""Age transport and bedrock thermal unit tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pism_tpu import Config, Grid
from pism_tpu.model.age import AgeModel
from pism_tpu.model.btu import BTUFull, BTUMinimal, btu_from_config
from pism_tpu.ops.sia3d import SIA3D
from pism_tpu.state import ModelState, new_geometry

SPY = 3.15569259747e7


def _zero_sia3(shape3):
    z = jnp.zeros(shape3)
    return SIA3D(u=z, v=z, w=z, strain_heating=z,
                 max_u=jnp.zeros(()), max_v=jnp.zeros(()))


def test_age_grows_without_flow():
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=11, Lz=2000.0,
                vertical_spacing="equal")
    cfg = Config({"age.enabled": True})
    am = AgeModel(grid=grid, config=cfg)
    geom = new_geometry(jnp.full(grid.shape2, 1500.0), jnp.zeros(grid.shape2))
    state = ModelState(geometry=geom, age=jnp.zeros(grid.shape3))
    dt = 100.0 * SPY
    A = state.age
    for _ in range(5):
        A = am.step(state.replace(age=A), _zero_sia3(grid.shape3), dt)
    # within the ice, age advanced by 500 years exactly (dA/dt = 1)
    assert float(A[2, 2, 0]) == pytest.approx(500 * SPY, rel=1e-10)
    # above the surface: zero
    assert float(A[2, 2, -1]) == 0.0


def test_age_downward_advection_limits_surface_age():
    """With downward w (accumulation), the steady age at depth is finite
    and increases toward the base."""
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=21, Lz=2000.0,
                vertical_spacing="equal")
    cfg = Config({"age.enabled": True})
    am = AgeModel(grid=grid, config=cfg)
    geom = new_geometry(jnp.full(grid.shape2, 1850.0), jnp.zeros(grid.shape2))
    w = jnp.full(grid.shape3, -0.3 / SPY)  # 0.3 m/a downward
    z = jnp.zeros(grid.shape3)
    sia3 = SIA3D(u=z, v=z, w=w, strain_heating=z,
                 max_u=jnp.zeros(()), max_v=jnp.zeros(()))
    state = ModelState(geometry=geom, age=jnp.zeros(grid.shape3))

    step = jax.jit(lambda A: am.step(state.replace(age=A), sia3, 200.0 * SPY))
    A = state.age
    for _ in range(200):
        A = step(A)
    prof = np.asarray(A)[2, 2] / SPY
    assert prof[-1] == 0.0                  # above the surface: no ice
    assert np.all(np.diff(prof[:19]) <= 1e-6)  # older downward within ice
    # advection: age at depth d ~ d / |w|; at z=1000 (d=850): ~2800 a
    assert 2000 < prof[10] < 4500


def test_btu_steady_flux_passthrough():
    """At steady state the BTU transmits the geothermal flux unchanged."""
    grid = Grid(Mx=4, My=4, Lx=10e3, Ly=10e3, Mbz=11, Lbz=1000.0)
    cfg = Config({"grid.Mbz": 11, "grid.Lbz": 1000.0})
    btu = btu_from_config(grid, cfg)
    assert isinstance(btu, BTUFull)
    G = jnp.full(grid.shape2, 0.05)
    T_top = jnp.full(grid.shape2, 263.15)
    T = btu.init_temperature(T_top, G)
    # bottom is warmer by G/k * Lbz
    assert float(T[0, 0, 0]) == pytest.approx(263.15 + 0.05 / 3.0 * 1000.0)
    T2, flux = btu.step(T, T_top, G, 100.0 * SPY)
    assert float(flux[0, 0]) == pytest.approx(0.05, rel=1e-6)
    np.testing.assert_allclose(np.asarray(T2), np.asarray(T), atol=1e-6)


def test_btu_transient_damping():
    """A step change in surface temperature diffuses into the bedrock:
    the flux responds gradually, not instantly."""
    grid = Grid(Mx=4, My=4, Lx=10e3, Ly=10e3, Mbz=21, Lbz=1000.0)
    cfg = Config({"grid.Mbz": 21, "grid.Lbz": 1000.0})
    btu = BTUFull(grid=grid, config=cfg)
    G = jnp.full(grid.shape2, 0.05)
    T_top0 = jnp.full(grid.shape2, 263.15)
    T = btu.init_temperature(T_top0, G)
    T_warm = T_top0 + 10.0
    T1, flux1 = btu.step(T, T_warm, G, 10.0 * SPY)
    # warming the top reduces the upward flux at the top initially
    assert float(flux1[0, 0]) < 0.05
    step = jax.jit(lambda Tb: btu.step(Tb, T_warm, G, 100.0 * SPY))
    for _ in range(3000):
        T1, fluxN = step(T1)
    # after ~300 kyr it re-equilibrates to the geothermal flux
    assert float(fluxN[0, 0]) == pytest.approx(0.05, rel=1e-3)


def test_btu_minimal():
    grid = Grid(Mx=4, My=4, Lx=10e3, Ly=10e3)
    btu = btu_from_config(grid, Config())
    assert isinstance(btu, BTUMinimal)
    G = jnp.full(grid.shape2, 0.042)
    T, flux = btu.step(None, jnp.full(grid.shape2, 260.0), G, 1.0)
    assert T is None
    np.testing.assert_array_equal(np.asarray(flux), np.asarray(G))

def test_pcr_matches_thomas():
    """Parallel cyclic reduction (the GPU path) reproduces the Thomas scan
    to machine precision on diagonally dominant batched systems."""
    import numpy as np
    from pism_tpu.util.tridiag import solve_batched_pcr, solve_batched_thomas

    rng = np.random.default_rng(7)
    for n in (2, 3, 41):
        a = rng.standard_normal((5, 6, n)) * 0.3
        c = rng.standard_normal((5, 6, n)) * 0.3
        b = 2.0 + np.abs(a) + np.abs(c) + rng.random((5, 6, n))
        d = rng.standard_normal((5, 6, n))
        x1 = np.asarray(solve_batched_thomas(a, b, c, d))
        x2 = np.asarray(solve_batched_pcr(a, b, c, d))
        assert np.abs(x1 - x2).max() < 1e-12 * np.abs(x1).max() + 1e-14
