"""Mesh-shape invariance: the analog of PISM's "same answer under
mpiexec -n 1..4" regression runs (SURVEY.md §4). A jitted SIA step over a
sharded state on a 2x4 CPU device mesh must match the single-device result;
the manual ppermute halo library must match the GSPMD path bit-for-bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pism_tpu import Config, Grid
from pism_tpu.state import ModelState, new_geometry
from pism_tpu.model.icemodel import IceModel
from pism_tpu.coupler.surface import Uniform
from pism_tpu.parallel.mesh import make_mesh, shard_state, sharding2d
from pism_tpu.parallel import halo
from pism_tpu.ops import stencils as st
from pism_tpu.verification import halfar

SPY = 3.15569259747e7


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state():
    """Drop compiled executables accumulated by the ~270 tests that run
    before this module in a full-tier pass.  The XLA CPU compiler has been
    observed to segfault (in backend_compile_and_load, on a trivial
    elementwise op) when these sharded tests compile late in a long
    single-process session; the same tests pass deterministically in a
    fresh process.  Clearing JAX's caches frees the accumulated JIT state
    before the mesh compilations start."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return d


def _setup(Mx=64):
    sol = halfar.test_B()
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = Config({
        "stress_balance.model": "sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
        "energy.model": "none",
    })
    H0 = sol.thickness(sol.t0, grid.radius)
    state = ModelState(geometry=new_geometry(jnp.asarray(H0), jnp.zeros(grid.shape2)))
    model = IceModel(grid=grid, config=cfg, surface=Uniform(smb=0.0))
    return sol, grid, state, model


def test_sharded_run_matches_single_device(devices):
    sol, grid, state, model = _setup()

    s1, t1, _ = model.step_once(state, sol.t0, 20 * SPY)

    mesh = make_mesh(devices, shape=(2, 4))
    state_sh = shard_state(state, mesh)
    s8, t8, _ = model.step_once(state_sh, sol.t0, 20 * SPY)

    a = np.asarray(s1.geometry.ice_thickness)
    b = np.asarray(s8.geometry.ice_thickness)
    assert t1 == t8
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_halo_pad_matches_shift(devices, rng):
    """Manual ppermute halo exchange reproduces clamped/periodic shifts."""
    mesh = make_mesh(devices, shape=(2, 4))
    a = jnp.asarray(rng.normal(size=(16, 32)))

    for periodic in [(False, False), (True, True)]:
        def local_id(p):
            return halo.crop(p, 1)

        fn = halo.stencil_shard_map(local_id, mesh, width=1, periodic=periodic)
        np.testing.assert_allclose(np.asarray(fn(a)), np.asarray(a), atol=0)

        # a 4-neighbor stencil through the halo path vs the global path
        def lap_local(p):
            return (p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2]
                    - 4.0 * p[1:-1, 1:-1])

        fn = halo.stencil_shard_map(lap_local, mesh, width=1, periodic=periodic)
        got = np.asarray(fn(a))

        py, px = periodic
        ref = (st.shift(a, 1, 0, py, px) + st.shift(a, -1, 0, py, px)
               + st.shift(a, 0, 1, py, px) + st.shift(a, 0, -1, py, px) - 4.0 * a)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-12)


def test_mesh_factorization():
    from pism_tpu.parallel.mesh import best_factorization
    assert best_factorization(8) == (2, 4)
    assert best_factorization(16) == (4, 4)
    assert best_factorization(7) == (1, 7)


@pytest.mark.slow
def test_full_hybrid_chain_mesh_invariance(devices):
    """The FULL production chain (SSA+SIA, enthalpy, stateful PDD,
    calving, iceberg removal) gives the same answer on one device and on
    a 2x4 mesh — the reference's mpiexec -n 1 vs -n 4 regression on the
    real model, not just the SIA core. The sharded SSA's psum-ordered
    reductions differ in rounding, so the comparison is tight-but-not-
    bitwise on the float64 state."""
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.pdd import TemperatureIndex

    Mx, My = 40, 48
    Lx, Ly = 400e3, 480e3
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=11, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
    })
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.7 * Lx)) ** 2 + (Y / (0.7 * Ly)) ** 2
    bed = 300.0 - 800.0 * r2
    H = 2000.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -500)
    lat = 65.0 + (Y + Ly) / (2 * Ly) * 15.0
    a = atm.SeariseGreenland(
        latitude=jnp.asarray(lat), longitude=jnp.full(grid.shape2, -40.0),
        precipitation=jnp.full(grid.shape2, 0.4 / SPY))
    surface = TemperatureIndex(atmosphere=a, config=cfg)
    model = IceModel(grid=grid, config=cfg, surface=surface)
    state = model.prepare_state(ModelState(geometry=new_geometry(
        jnp.asarray(H), jnp.asarray(bed))))

    cap = 0.05 * SPY     # below the adaptive dt: exactly one step each
    s1, t1, st1 = model.step_once(state, 0.0, cap)

    mesh = make_mesh(devices, shape=(2, 4))
    s8, t8, st8 = model.step_once(shard_state(state, mesh), 0.0, cap)

    assert t1 == t8 and int(st1.nsteps) == int(st8.nsteps) == 1
    for name, a1, a8, tol in (
            ("thk", s1.geometry.ice_thickness, s8.geometry.ice_thickness,
             1e-5),
            ("enthalpy", s1.enthalpy, s8.enthalpy, 1e-5),
            ("u_ssa", s1.u_ssa, s8.u_ssa, 5e-3),
            ("snow", s1.snow_depth, s8.snow_depth, 1e-6)):
        a1, a8 = np.asarray(a1), np.asarray(a8)
        scale = max(np.abs(a1).max(), 1e-30)
        assert np.max(np.abs(a1 - a8)) / scale < tol, name


def test_regional_mode_mesh_invariance(devices):
    """Regional (no_model_mask) runs shard like everything else: the
    strip's stored-frame driving stress and strip-face SIA gradients are
    plain stencils, so a 2x4 mesh must reproduce the single-device step
    (the reference's regional runs under mpiexec -n N contract)."""
    from pism_tpu.physics.basal import GivenYieldStress

    Mx, My = 40, 48
    grid = Grid(Mx=Mx, My=My, Lx=200e3, Ly=240e3)
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.hypot(X, Y)
    H = 600.0 + 1400.0 * np.exp(-(r / 60e3) ** 2)
    tauc = np.where(r < 80e3, 4.0e4, 1.0e8)
    nmm = np.zeros(grid.shape2, bool)
    nmm[:3, :] = nmm[-3:, :] = nmm[:, :3] = nmm[:, -3:] = True
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "energy.model": "none",
        "basal_yield_stress.model": "given",
        "regional.enabled": True,
        # invariance is asserted on fully-converged solves: the production
        # velocity-change stop (1e-4) legitimately fires after different
        # sweep counts across mesh shapes (psum-order noise near the
        # threshold), leaving velocity differences up to the stop
        # tolerance — the reference's rank-count contract is likewise
        # tolerance-based (nccmp diffs), not bit-exact, for its
        # iteratively-solved fields
        "stress_balance.ssa.fd.velocity_change_rtol": 0.0,
    })
    model = IceModel(grid=grid, config=cfg,
                     surface=Uniform(smb=0.0),
                     yield_stress=GivenYieldStress(cfg, tau_c=jnp.asarray(tauc)),
                     no_model_mask=jnp.asarray(nmm))
    state = model.prepare_state(ModelState(geometry=new_geometry(
        jnp.asarray(H), jnp.zeros(grid.shape2))))

    cap = 0.2 * SPY
    s1, t1, _ = model.step_once(state, 0.0, cap)
    mesh = make_mesh(devices, shape=(2, 4))
    s8, t8, _ = model.step_once(shard_state(state, mesh), 0.0, cap)

    assert t1 == t8
    a1 = np.asarray(s1.geometry.ice_thickness)
    a8 = np.asarray(s8.geometry.ice_thickness)
    assert np.max(np.abs(a1 - a8)) / max(np.abs(a1).max(), 1e-30) < 1e-6
    # the frozen strip is bit-identical (no dynamics there at all)
    np.testing.assert_array_equal(a1[nmm], a8[nmm])


# ---------------------------------------------------------------------------
# Hot-path operators under GSPMD: the SIA flux and the SSA operator jitted on
# a state sharded over a 2x4 mesh match the single-device result.
# ---------------------------------------------------------------------------

def _dome(Mx, My, Lx, Ly, rng):
    X, Y = np.meshgrid(np.linspace(-Lx, Lx, Mx), np.linspace(-Ly, Ly, My))
    r2 = (X / (0.8 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    H = 2500.0 * np.maximum(1.0 - r2, 0.0) ** 1.2
    bed = 200.0 * np.sin(X / 50e3) * np.cos(Y / 70e3)
    return H.astype(np.float32), bed.astype(np.float32)


@pytest.mark.parametrize("law_kind", ["thermomechanical", "isothermal"])
def test_sia_diffusivity_sharded_matches_single_device(devices, rng,
                                                       law_kind):
    """The SIA flux jitted over a 2x4 mesh (GSPMD halos) equals the
    single-device result, for the enthalpy-coupled and the isothermal
    laws, on a mesh-divisible 40x48 grid."""
    from pism_tpu.ops import sia as sia_ops
    from pism_tpu.ops.stencils import Shifter
    from pism_tpu.physics.rheology import flow_law_from_config
    from pism_tpu.physics.enthalpy_converter import EnthalpyConverter

    Mx, My, Mz = 48, 40, 9
    grid = Grid(Mx=Mx, My=My, Lx=300e3, Ly=250e3, Mz=Mz, Lz=4000.0)
    over = {"runtime.float_dtype": "float32"}
    if law_kind == "isothermal":
        over["stress_balance.sia.flow_law"] = "isothermal_glen"
    cfg = Config(over)
    law = flow_law_from_config(cfg, "sia", EnthalpyConverter.from_config(cfg))
    H, bed = _dome(Mx, My, grid.Lx, grid.Ly, rng)
    geom = new_geometry(jnp.asarray(H), jnp.asarray(bed))
    geom = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if hasattr(a, "dtype")
        and a.dtype == jnp.float64 else a, geom)
    E = None
    if law_kind == "thermomechanical":
        E = jnp.asarray(rng.uniform(9.0e4, 1.05e5, size=(My, Mx, Mz))
                        .astype(np.float32))
    sh = Shifter(grid)

    @jax.jit
    def flux(geom, E):
        return sia_ops.diffusivity(law, geom, E, grid, sh, d_limit=50.0)

    ref = flux(geom, E)
    mesh = make_mesh(devices, shape=(2, 4))
    from jax.sharding import NamedSharding, PartitionSpec as P
    s2 = NamedSharding(mesh, P("y", "x"))
    geom_s = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, s2) if getattr(a, "ndim", 0) == 2 else a,
        geom)
    E_s = None if E is None else jax.device_put(
        E, NamedSharding(mesh, P("y", "x", None)))
    got = flux(geom_s, E_s)
    assert len(got.qe.devices()) == 8
    for name in ("De", "Dn", "qe", "qn"):
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        scale = max(np.abs(a).max(), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6 * scale,
                                   err_msg=name)
    assert float(got.max_D) == float(ref.max_D)


def test_ssa_matvec_sharded_matches_xla(devices, rng):
    """The SSA operator jitted over a 2x4 mesh (GSPMD halos) equals the
    single-device XLA apply, including the physical-boundary clamp-shift
    semantics and the JVP the Newton linearization uses."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pism_tpu.ops import ssa as ssa_ops
    from pism_tpu.ops.stencils import Shifter

    Mx, My = 40, 32
    grid = Grid(Mx=Mx, My=My, Lx=200e3, Ly=160e3)
    sh = Shifter(grid)
    f32 = np.float32
    fields = [rng.normal(size=(My, Mx)).astype(f32) * 1e-5,
              rng.normal(size=(My, Mx)).astype(f32) * 1e-5,
              rng.uniform(1e13, 1e15, size=(My, Mx)).astype(f32),
              rng.uniform(1e13, 1e15, size=(My, Mx)).astype(f32),
              rng.uniform(1e8, 1e10, size=(My, Mx)).astype(f32)]
    tangents = [rng.normal(size=(My, Mx)).astype(f32) * 1e-6,
                rng.normal(size=(My, Mx)).astype(f32) * 1e-6]

    def op(u, v, nuH_e, nuH_n, beta):
        return ssa_ops.apply_operator(u, v, ssa_ops.NuH(nuH_e, nuH_n), beta,
                                      grid.dx, grid.dy, sh)

    @jax.jit
    def apply_and_jvp(u, v, nuH_e, nuH_n, beta, du, dv):
        return jax.jvp(lambda a, b: op(a, b, nuH_e, nuH_n, beta),
                       (u, v), (du, dv))

    ref = apply_and_jvp(*map(jnp.asarray, fields + tangents))
    mesh = make_mesh(devices, shape=(2, 4))
    s2 = NamedSharding(mesh, P("y", "x"))
    got = apply_and_jvp(*(jax.device_put(jnp.asarray(a), s2)
                          for a in fields + tangents))
    assert len(got[0][0].devices()) == 8
    for part in (0, 1):          # primal, tangent
        for a, b in zip(ref[part], got[part]):
            a, b = np.asarray(a), np.asarray(b)
            np.testing.assert_allclose(
                b, a, rtol=0, atol=1e-5 * max(np.abs(a).max(), 1e-30))


def test_sharded_segments_compile_once(devices):
    """shard_state places 3D fields with the spec XLA gives a segment's
    outputs, so the second segment of a sharded run reuses the compiled
    step instead of compiling it again."""
    from pism_tpu.verification import eismint2

    es = eismint2.setup("A", Mx=16, Mz=5, Lz=5000.0)
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
    state = shard_state(model.prepare_state(es.state),
                        make_mesh(devices, shape=(2, 4)))
    assert state.enthalpy.ndim == 3
    state, t, _ = model.step_once(state, 0.0, 100 * SPY)
    model.step_once(state, t, 100 * SPY)
    assert model._advance_device._cache_size() == 1
