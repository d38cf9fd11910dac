import numpy as np
import jax.numpy as jnp
import pytest

from pism_tpu import Config, Grid
from pism_tpu.state import ModelState, new_geometry
from pism_tpu.model.energy import EnergyModel, bootstrap_enthalpy
from pism_tpu.model.icemodel import IceModel
from pism_tpu.ops.sia3d import SIA3D
from pism_tpu.physics.enthalpy_converter import EnthalpyConverter
from pism_tpu.util.tridiag import solve_batched

SPY = 3.15569259747e7


def test_tridiag_matches_dense(rng):
    n = 17
    shape = (3, 4)
    a = rng.normal(size=shape + (n,)) * 0.3
    c = rng.normal(size=shape + (n,)) * 0.3
    b = 2.0 + np.abs(rng.normal(size=shape + (n,)))  # diagonally dominant
    d = rng.normal(size=shape + (n,))
    x = np.asarray(solve_batched(a, b, c, d))
    for i in range(3):
        for j in range(4):
            M = np.diag(b[i, j]) + np.diag(a[i, j, 1:], -1) + np.diag(c[i, j, :-1], 1)
            ref = np.linalg.solve(M, d[i, j])
            np.testing.assert_allclose(x[i, j], ref, rtol=1e-10)


def _energy_setup(H_val=2000.0, Mz=41, T_s=243.15):
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=Mz, Lz=3000.0,
                vertical_spacing="equal")
    cfg = Config({"grid.Mz": Mz, "grid.Lz": 3000.0})
    EC = EnthalpyConverter.from_config(cfg)
    em = EnergyModel(grid=grid, config=cfg, EC=EC)
    H = jnp.full(grid.shape2, H_val)
    geom = new_geometry(H, jnp.zeros(grid.shape2))
    E0 = bootstrap_enthalpy(grid, EC, H, jnp.full(grid.shape2, T_s))
    z3 = (5, 5, Mz)
    sia3 = SIA3D(u=jnp.zeros(z3), v=jnp.zeros(z3), w=jnp.zeros(z3),
                 strain_heating=jnp.zeros(z3),
                 max_u=jnp.zeros(()), max_v=jnp.zeros(()))
    state = ModelState(geometry=geom, enthalpy=E0,
                       basal_melt_rate=jnp.zeros(grid.shape2))
    return grid, cfg, EC, em, state, sia3


def test_steady_conduction_profile():
    """No flow, cold column: steady state is T(z) = Ts + (G/k)(H - z)."""
    import jax
    H_val, T_sv, G = 1000.0, 243.15, 0.02   # base stays ~9.5 K below melting
    grid, cfg, EC, em, state, sia3 = _energy_setup(H_val=H_val, T_s=T_sv)
    T_s = jnp.full(grid.shape2, T_sv)
    dt = 200.0 * SPY
    Gf = jnp.full(grid.shape2, G)

    @jax.jit
    def iterate(E):
        res = em.step(state.replace(enthalpy=E), sia3, T_s, dt,
                      geothermal_flux=Gf)
        return res.enthalpy, res.basal_melt_rate

    E = state.enthalpy
    for _ in range(300):
        E, mb = iterate(E)
    z = np.asarray(grid.z)
    within = z <= H_val
    T_num = np.asarray(EC.temperature(
        E, EC.pressure(jnp.maximum(H_val - jnp.asarray(z), 0.0))))[2, 2]
    T_exact = T_sv + G / 2.10 * (H_val - z)
    np.testing.assert_allclose(T_num[within], T_exact[within], atol=0.05)
    assert float(mb[2, 2]) == 0.0  # cold base, no melt


def test_basal_melt_with_strong_geothermal():
    """Huge geothermal flux melts the base: temperate base, positive melt
    rate close to the excess-flux estimate."""
    import jax
    grid, cfg, EC, em, state, sia3 = _energy_setup(H_val=2000.0, T_s=260.15)
    T_s = jnp.full(grid.shape2, 260.15)
    G = 0.5  # W/m^2, very hot
    dt = 100.0 * SPY
    Gf = jnp.full(grid.shape2, G)

    @jax.jit
    def iterate(E):
        res = em.step(state.replace(enthalpy=E), sia3, T_s, dt,
                      geothermal_flux=Gf)
        return res.enthalpy, res.basal_melt_rate

    E = state.enthalpy
    for _ in range(400):
        E, mb = iterate(E)
    res = em.step(state.replace(enthalpy=E), sia3, T_s, dt, geothermal_flux=Gf)
    p_b = EC.pressure(2000.0)
    assert bool(E[2, 2, 0] >= EC.enthalpy_cts(p_b))  # temperate base
    mb = float(res.basal_melt_rate[2, 2]) * SPY      # m/a
    # steady state: melt ~ (G - q_cond)/(rho L); q_cond = k dT/dz ~ k (Tm-Ts)/H
    rho, L = 910.0, 3.34e5
    q_cond = 2.10 * (float(EC.melting_temperature(p_b)) - 260.15) / 2000.0
    mb_est = (G - q_cond) / (rho * L) * SPY
    assert mb == pytest.approx(mb_est, rel=0.2)
    assert 0.001 < mb < 0.2


def test_eismint2_short_run_sane():
    from pism_tpu.verification import eismint2
    es = eismint2.setup("A", Mx=31, Mz=21, Lz=5000.0)
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
    state, t, stats = model.step_once(es.state, 0.0, 2000 * SPY)
    H = np.asarray(state.geometry.ice_thickness)
    E = np.asarray(state.enthalpy)
    assert not np.isnan(H).any() and not np.isnan(E).any()
    # interior grows at M_max = 0.5 m/a while flow is negligible
    assert H.max() == pytest.approx(1000.0, rel=0.05)
    # margin area is ablation-limited: no ice far from the center
    assert H[0, 0] == 0.0
    # basal temperature at the divide warmed above the surface temperature
    EC = EnthalpyConverter.from_config(es.config)
    c = es.grid.My // 2
    Tb = float(EC.temperature(jnp.asarray(E[c, c, 0]),
                              EC.pressure(jnp.asarray(H[c, c]))))
    assert 238.15 < Tb < 273.15


def test_eismint2_sliding_experiments_g_h():
    """Experiments G/H (Payne et al. 2000): linear hard-bed sliding
    u_b = -B tau_b. G slides everywhere grounded; H only where the base is
    temperate — early in the (cold) spin-up H must slide strictly less,
    and G must export more ice than the no-sliding run of the same length."""
    from pism_tpu.verification import eismint2

    vols, speeds = {}, {}
    for exp in ("A", "G", "H"):
        es = eismint2.setup(exp, Mx=31, Mz=15, Lz=5000.0)
        model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
        state, t, stats = model.step_once(es.state, 0.0, 3000 * SPY)
        sb = model.stress_balance.update(state)
        sp = np.sqrt(np.asarray(sb.u_base) ** 2 + np.asarray(sb.v_base) ** 2)
        H = np.asarray(state.geometry.ice_thickness)
        assert not np.isnan(H).any()
        vols[exp] = H.sum()
        speeds[exp] = sp.max() * SPY  # m/a
    assert speeds["A"] == 0.0
    assert speeds["G"] > 1.0           # sliding is active (m/a scale)
    assert speeds["H"] <= speeds["G"]  # melt gate can only reduce sliding
    assert vols["G"] < vols["A"]       # sliding flattens the sheet


def test_eismint2_trough_and_mound_experiments():
    """Experiments I/K (upstream IceEISModel trough/mound beds): the bed
    shapes are right, runs are stable, and for I the channel carries more
    ice flux than the plateau at the same distance east."""
    from pism_tpu.verification import eismint2

    # bed geometry sanity
    es_i = eismint2.setup("I", Mx=31, Mz=15, Lz=5000.0)
    bed = np.asarray(es_i.state.geometry.bed_elevation)
    c = es_i.grid.My // 2
    assert bed[c, -1] == pytest.approx(0.0, abs=1.0)     # trough mouth
    assert bed[0, 0] == pytest.approx(1000.0)            # plateau
    assert bed[c, 0] == pytest.approx(1000.0)            # west half intact

    es_k = eismint2.setup("K", Mx=31, Mz=15, Lz=5000.0)
    bk = np.asarray(es_k.state.geometry.bed_elevation)
    assert bk.min() >= 0.0 and 300.0 < bk.max() <= 500.0

    for es in (es_i, es_k):
        model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
        state, t, stats = model.step_once(es.state, 0.0, 5000 * SPY)
        H = np.asarray(state.geometry.ice_thickness)
        assert not np.isnan(H).any()
        assert H.max() > 500.0

    # trough channels the flow: at a fixed eastern column inside the sheet,
    # the ice in the channel row is thicker than on the plateau rows
    j = int(0.75 * 31)
    Hi = np.asarray(state.geometry.ice_thickness)  # K run; redo for I
    es = es_i
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface)
    state, t, stats = model.step_once(es.state, 0.0, 5000 * SPY)
    Hi = np.asarray(state.geometry.ice_thickness)
    assert Hi[c, j] > Hi[2, j]


def test_cryo_hydrologic_warming():
    """energy.ch_warming (Phillips et al. 2010 / CHSystem role): where the
    surface melts, the water-filled CH columns sit at the pressure-melting
    point and warm the (colder) ice; with the option off nothing changes."""
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=21, Lz=1500.0,
                vertical_spacing="equal")

    def run(enabled, years=40.0, melting=True):
        cfg = Config({"energy.ch_warming.enabled": bool(enabled),
                      "energy.ch_warming.average_channel_spacing": 20.0})
        EC = EnthalpyConverter.from_config(cfg)
        em = EnergyModel(grid=grid, config=cfg, EC=EC)
        H = jnp.full(grid.shape2, 1000.0)
        geom = new_geometry(H, jnp.zeros(grid.shape2))
        T_s = jnp.full(grid.shape2, 263.15)
        E0 = bootstrap_enthalpy(grid, EC, H, T_s)
        z3 = grid.shape2 + (grid.Mz,)
        sia3 = SIA3D(u=jnp.zeros(z3), v=jnp.zeros(z3), w=jnp.zeros(z3),
                     strain_heating=jnp.zeros(z3),
                     max_u=jnp.zeros(()), max_v=jnp.zeros(()))
        state = ModelState(geometry=geom, enthalpy=E0)
        ch = E0 if enabled else None
        melt = jnp.full(grid.shape2, (1.0 if melting else 0.0) / SPY)
        dt = SPY
        for _ in range(int(years)):
            res = em.step(state, sia3, T_s, dt, surface_melt=melt,
                          ch_enthalpy=ch)
            state = state.replace(enthalpy=res.enthalpy)
            ch = res.ch_enthalpy
        return state.enthalpy, ch, EC

    E_off, ch_off, EC = run(False)
    E_on, ch_on, _ = run(True)
    assert ch_off is None and ch_on is not None
    # CH columns saturated at pressure melting mid-column
    z = np.asarray(grid.z)
    k_mid = int(np.argmin(np.abs(z - 500.0)))
    p = EC.pressure(jnp.asarray(500.0))
    E_cts = float(EC.enthalpy_cts(p))
    assert float(ch_on[2, 2, k_mid]) >= E_cts - 1.0
    # ice warmed relative to the CH-off run, but not beyond temperate
    dE = float(E_on[2, 2, k_mid] - E_off[2, 2, k_mid])
    assert dE > 500.0           # J/kg: clearly warmed over 40 years
    assert float(E_on[2, 2, k_mid]) <= E_cts + 1e3
    # no surface melt -> CH columns cool toward the ice state, little warming
    E_dry, ch_dry, _ = run(True, melting=False)
    dE_dry = float(E_dry[2, 2, k_mid] - E_off[2, 2, k_mid])
    assert abs(dE_dry) < 0.2 * dE


def test_eismint2_experiment_e_sector_sliding():
    """Experiment E: the sliding patch (annular sector, 200-700 km radius,
    10-40 deg azimuth) slides only inside the sector, breaks the radial
    symmetry of A, and drains ice relative to the no-sliding run."""
    from pism_tpu.verification import eismint2

    es = eismint2.setup("E", Mx=31, Mz=15, Lz=5000.0)
    mu = np.asarray(es.sliding_mu)
    X, Y = np.meshgrid(es.grid.x, es.grid.y)
    r = np.hypot(X, Y)
    th = np.degrees(np.arctan2(Y, X))
    inside = (r > 200e3) & (r < 700e3) & (th > 10.0) & (th < 40.0)
    assert mu.max() > 0.0 and mu.max() <= eismint2.MU_MAX_E * 1.0001
    assert (mu[~inside] == 0.0).all()
    assert (mu[inside] >= 0.0).all()

    model = IceModel(grid=es.grid, config=es.config, surface=es.surface,
                     sliding_mu=es.sliding_mu)
    state, t, stats = model.step_once(es.state, 0.0, 3000 * SPY)
    H = np.asarray(state.geometry.ice_thickness)
    assert not np.isnan(H).any()

    sb = model.stress_balance.update(state)
    sp = np.hypot(np.asarray(sb.u_base), np.asarray(sb.v_base)) * SPY
    assert sp[~inside].max() == 0.0       # no sliding outside the sector
    assert sp[inside].max() > 0.5          # the patch slides (m/a scale)

    # symmetry of A is broken: the sector flank thins vs its mirror image
    esA = eismint2.setup("A", Mx=31, Mz=15, Lz=5000.0)
    modelA = IceModel(grid=esA.grid, config=esA.config, surface=esA.surface)
    stateA, _, _ = modelA.step_once(esA.state, 0.0, 3000 * SPY)
    HA = np.asarray(stateA.geometry.ice_thickness)
    dH = H - HA
    assert dH[inside].min() < -1.0         # patch thinned vs A
    assert H.sum() < HA.sum()              # net ice loss from sliding


@pytest.mark.parametrize("platform,expected", [
    ("cpu", "thomas"),
    ("gpu", "pcr"),          # measured on the H100: PCR wins at every shape
])
def test_tridiag_dispatch_shape_rules(platform, expected):
    """One helper (util/dispatch.py) picks the batched tridiagonal solver
    from the platform; solve_batched follows the placement it sees, and
    both algorithms agree on a diagonally dominant system."""
    import jax
    from pism_tpu.util import dispatch
    from pism_tpu.util.tridiag import solve_batched, solve_batched_pcr

    assert dispatch.tridiag_method(platform) == expected
    rng = np.random.default_rng(41)
    shape = (3, 41)
    a, c = -rng.uniform(size=shape), -rng.uniform(size=shape)
    b = 2.5 + rng.uniform(size=shape)
    d = rng.normal(size=shape)
    with jax.default_device(jax.devices("cpu")[0]):
        assert dispatch.platform() == "cpu"
        x = np.asarray(solve_batched(a, b, c, d))
    np.testing.assert_allclose(np.asarray(solve_batched_pcr(a, b, c, d)),
                               x, rtol=1e-10, atol=1e-12)
