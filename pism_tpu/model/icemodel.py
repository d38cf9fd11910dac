"""Model driver.

Rebuild of PISM ``src/icemodel/`` (``IceModel::run``/``step``,
``timestepping.cc``): owns the grid, config and components, orders the
sub-model updates within a step, and selects the adaptive time step as the
min over stability limits and component restrictions.

Accelerator structure: the *entire* inner loop — stress balance, dt
selection, energy step, mass transport, couplers — is one jitted
``lax.while_loop`` ("segment") that advances from t0 to t_end on device with
zero host synchronization; the host loop around it only handles output
scheduling, reporting and checkpointing. This replaces PISM's host-driven
step loop + MPI allreduce dt selection (reductions become on-device
``jnp.min``s that GSPMD lowers to psum-style collectives when sharded).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import state as S
from ..config.config import Config
from ..grid import Grid
from ..ops import sia as sia_ops
from ..ops.stencils import Shifter
from ..physics.rheology import flow_law_from_config
from ..physics.enthalpy_converter import EnthalpyConverter
from ..util.logger import log
from ..util.timecal import Time
from . import geometry_evolution as ge
from .stressbalance import StressBalance, StressBalanceResult


class CellBudget(NamedTuple):
    """Per-cell time-integrated thickness changes [m] (dH convention) for
    the spatial ``tendency_of_ice_amount_due_to_*`` diagnostics (reference
    ``GeometryEvolution``'s per-cell conservation fields)."""
    flow: jnp.ndarray
    smb: jnp.ndarray
    bmb: jnp.ndarray
    nonneg: jnp.ndarray
    discharge: jnp.ndarray
    # discharge split per mechanism (reference diagnostics
    # tendency_of_ice_amount_due_to_{calving,frontal_melt,forced_retreat})
    calving: jnp.ndarray
    frontal_melt: jnp.ndarray
    forced_retreat: jnp.ndarray

    @staticmethod
    def zero(shape, dtype=jnp.float64):
        z = jnp.zeros(shape, dtype)
        return CellBudget(z, z, z, z, z, z, z, z)


# Which adaptive-dt limit bound the step (reference: PISM prints the
# binding restriction per step in its summary line; src/icemodel/
# timestepping.cc max_timestep accounting). Indexes into StepStats.limit_hits.
DT_LIMITS = ("max_dt", "sia_diffusivity", "cfl_2d", "cfl_3d", "hydrology",
             "surface", "hit_multiples", "min_dt_floor", "end_of_segment",
             "front_retreat")


class StepStats(NamedTuple):
    """Per-segment accumulated statistics (a pytree carried in the loop)."""
    nsteps: jnp.ndarray
    dt_min: jnp.ndarray
    dt_max: jnp.ndarray
    sum_div_flux: jnp.ndarray    # time-integrated flux-divergence volume [m^3]
    sum_smb: jnp.ndarray         # time-integrated applied SMB volume [m^3]
    sum_bmb: jnp.ndarray
    sum_nonneg: jnp.ndarray
    sum_discharge: jnp.ndarray   # volume change by calving/front retreat [m^3]
    sum_calving: jnp.ndarray        # calving-law part of the discharge [m^3]
    sum_frontal_melt: jnp.ndarray   # frontal-melt-driven retreat part [m^3]
    sum_forced_retreat: jnp.ndarray  # prescribed-retreat part [m^3]
    cell: Optional[CellBudget] = None   # per-cell budget (None = not tracked)
    # count of steps each DT_LIMITS entry was the binding dt restriction
    limit_hits: Optional[jnp.ndarray] = None
    # largest SIA diffusivity seen [m^2/s] (reference max_diffusivity check)
    max_diffusivity: Optional[jnp.ndarray] = None

    @staticmethod
    def zero(dtype=jnp.float64, shape2=None):
        z = jnp.zeros((), dtype)
        cell = CellBudget.zero(shape2, dtype) if shape2 is not None else None
        return StepStats(jnp.zeros((), jnp.int64), jnp.full((), jnp.inf, dtype),
                         jnp.zeros((), dtype), z, z, z, z, z, z, z, z, cell,
                         jnp.zeros((len(DT_LIMITS),), jnp.int32),
                         jnp.zeros((), dtype))

    def limit_hits_dict(self):
        """Host-side {limit_name: count} for the limits that ever bound."""
        if self.limit_hits is None:
            return {}
        import numpy as np
        h = np.asarray(self.limit_hits)
        return {name: int(n) for name, n in zip(DT_LIMITS, h) if n > 0}


@dataclass
class IceModel:
    """Composes the components; builds the jitted segment runner.

    Components are plain callables/objects resolved at construction from the
    config (the factory seam PISM implements with ``PCFactory``).
    """

    grid: Grid
    config: Config
    surface: Callable = None           # SurfaceModel
    ocean: Callable = None             # OceanModel (sub-shelf melt), optional
    sea_level: Callable = None         # SeaLevelModel, optional
    energy_model: object = None        # model/energy_step.EnergyModel, optional
    ssa: object = None                 # SSA solver, optional
    hydrology: object = None
    yield_stress: object = None
    calving: object = None
    frontal_melt: object = None        # FrontalMeltModel, optional
    bed_deformation: object = None
    # regional mode (PISM src/regional/): thickness/enthalpy are frozen
    # where no_model_mask is set (outlet-glacier subdomain runs)
    no_model_mask: object = None
    # regional stored geometry (usurfstore/thkstore, reference
    # IceRegionalModel): the frame the strip's driving stress and SIA
    # gradients are pinned to; default = the initial geometry
    usurf_store: object = None
    thk_store: object = None
    # target surface elevation for the iterative till-friction-angle
    # optimization (tillphi_opt; defaults to the .file config or the
    # initial surface when enabled)
    tillphi_target: object = None
    # prescribed per-cell linear sliding coefficient for the Weertman
    # path (EISMINT II experiment E sector patch)
    sliding_mu: object = None
    # prescribed sliding velocity fields (-stress_balance
    # prescribed_sliding[+sia]; read from
    # stress_balance.prescribed_sliding.file by the CLI)
    prescribed_u: object = None
    prescribed_v: object = None

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid)
        self.EC = EnthalpyConverter.from_config(cfg)
        self.dtype = jnp.float64 if cfg.get_string("runtime.float_dtype") == "float64" else jnp.float32

        sb_model = cfg.get_string("stress_balance.model")
        energy_kind = cfg.get_string("energy.model")
        if energy_kind == "cold":
            # legacy temperature-based model (PISM ``TemperatureModel``):
            # the enthalpy solver with a cold converter (omega forced to 0,
            # no drainage) reproduces the cold-ice limit
            from ..physics.enthalpy_converter import ColdEnthalpyConverter
            self.EC = ColdEnthalpyConverter.from_config(cfg)
        if energy_kind in ("enthalpy", "cold") and self.energy_model is None:
            from .energy import EnergyModel
            self.energy_model = EnergyModel(grid=self.grid, config=cfg, EC=self.EC)
        self.blatter = None
        if sb_model == "blatter":
            from .blatter import BlatterSolver
            # a dedicated Blatter flow law when explicitly configured
            # (stress_balance.blatter.flow_law), else the SSA's
            blatter_law = flow_law_from_config(
                cfg, "blatter" if cfg.is_set("stress_balance.blatter.flow_law")
                else "ssa", self.EC)
            self.blatter = BlatterSolver(grid=self.grid, config=cfg,
                                         flow_law=blatter_law)
            if self.yield_stress is None:
                from ..physics.basal import yield_stress_from_config
                self.yield_stress = yield_stress_from_config(cfg, self.grid)
            if self.hydrology is None:
                from ..physics.hydrology import hydrology_from_config
                self.hydrology = hydrology_from_config(self.grid, cfg)
        if "ssa" in sb_model:
            if self.ssa is None:
                ssa_law = flow_law_from_config(cfg, "ssa", self.EC)
                method = cfg.get_string("stress_balance.ssa.method")
                if method == "fem":
                    from .ssafem import SSAFEM
                    self.ssa = SSAFEM(grid=self.grid, config=cfg,
                                      flow_law=ssa_law)
                elif method == "fd":
                    from .ssa import SSAFD
                    self.ssa = SSAFD(grid=self.grid, config=cfg,
                                     flow_law=ssa_law)
                else:
                    raise ValueError(
                        f"stress_balance.ssa.method = {method!r}; "
                        "expected 'fd' or 'fem'")
            if self.yield_stress is None:
                from ..physics.basal import yield_stress_from_config
                self.yield_stress = yield_stress_from_config(cfg, self.grid)
            if self.hydrology is None:
                from ..physics.hydrology import hydrology_from_config
                self.hydrology = hydrology_from_config(self.grid, cfg)
        if self.calving is None:
            from .calving import calving_from_config
            self.calving = calving_from_config(self.grid, cfg)
        if self.frontal_melt is None:
            from ..coupler.frontalmelt import frontal_melt_from_config
            self.frontal_melt = frontal_melt_from_config(cfg)
        if self.calving is None and self.frontal_melt is not None:
            # frontal melt needs the front-retreat machinery even with no
            # calving law active
            from .calving import CalvingModel
            self.calving = CalvingModel(grid=self.grid, config=cfg,
                                        methods=("none",))
        if cfg.get_flag("ocean.always_grounded"):
            # reference ocean.always_grounded ("dry" simulations): no
            # flotation anywhere — implemented by pinning the sea level far
            # below any bed so the flotation criterion never fires
            from ..coupler.sealevel import Constant as _SLConstant
            self.sea_level = _SLConstant(value=-1e7)
        self.ssa_extrap = cfg.get_flag(
            "stress_balance.ssa.fd.extrapolate_initial_guess") \
            and sb_model in ("ssa", "ssa+sia")
        # front-retreat rate dt CFL (reference FrontRetreat::max_timestep;
        # either config alias enables it)
        self.front_retreat_cfl = self.calving is not None and (
            cfg.get_flag("calving.front_retreat.use_cfl")
            or cfg.get_flag("geometry.front_retreat.use_cfl"))
        if self.bed_deformation is None:
            from .beddef import bed_deformation_from_config
            self.bed_deformation = bed_deformation_from_config(self.grid, cfg)
        self.isochrones = None
        if cfg.get_flag("age.isochrones.enabled"):
            from .isochrones import Isochrones
            from ..cli import parse_times
            # the upstream names (isochrones.*) win when explicitly set;
            # age.isochrones.* are the rebuild's grouping
            spec = cfg.get_string("isochrones.deposition_times") \
                if cfg.is_set("isochrones.deposition_times") \
                else cfg.get_string("age.isochrones.deposition_times")
            dep = parse_times(spec, 3.15569259747e7) if spec else []
            n_layers = cfg.get_int("isochrones.bootstrapping.n_layers") \
                if cfg.is_set("isochrones.bootstrapping.n_layers") \
                else cfg.get_int("age.isochrones.n_layers")
            self.isochrones = Isochrones(
                grid=self.grid, n_layers=n_layers)
            self._iso_dep_times = dep
            import numpy as _np
            NL = self.isochrones.n_layers
            times = _np.full((NL,), _np.inf)
            times[1:1 + min(len(dep), NL - 1)] = dep[: NL - 1]
            self._iso_times_arr = jnp.asarray(times)
        self.fracture = None
        if cfg.get_flag("fracture_density.enabled"):
            from .fracture import FractureDensity
            self.fracture = FractureDensity(
                grid=self.grid, config=cfg,
                bc_mask=getattr(self.ssa, "bc_mask", None))
        self._nmm_ref = None   # (H_ref, E_ref) for regional mode
        self.age_model = None
        if cfg.get_flag("age.enabled"):
            from .age import AgeModel
            self.age_model = AgeModel(grid=self.grid, config=cfg)
        self.btu = None
        if energy_kind == "enthalpy":
            from .btu import btu_from_config
            self.btu = btu_from_config(self.grid, cfg)
        self.geothermal = cfg.get_number("bootstrapping.defaults.geothermal_flux")
        sia_law = flow_law_from_config(cfg, "sia", self.EC) \
            if "sia" in sb_model.split("+") else None
        if self.no_model_mask is not None:
            # regional mode (reference src/regional/): SIA/SSA see the strip
            nmm = jnp.asarray(self.no_model_mask, bool)
            if self.ssa is not None and hasattr(self.ssa, "no_model_mask"):
                self.ssa.no_model_mask = nmm
        if sb_model.startswith("prescribed_sliding") \
                and self.prescribed_u is None:
            path = cfg.get_string("stress_balance.prescribed_sliding.file")
            if path:
                from ..io.bootstrap import read_and_regrid
                flds = read_and_regrid(path, self.grid,
                                       ["u_ssa", "v_ssa", "ubar", "vbar"])
                self.prescribed_u = flds.get("u_ssa", flds.get("ubar"))
                self.prescribed_v = flds.get("v_ssa", flds.get("vbar"))
        self.stress_balance = StressBalance(
            grid=self.grid, config=cfg, sia_flow_law=sia_law, ssa=self.ssa,
            blatter=self.blatter, model=sb_model,
            compute_3d=self.energy_model is not None,
            no_model_mask=self.no_model_mask, sliding_mu=self.sliding_mu,
            prescribed_u=self.prescribed_u, prescribed_v=self.prescribed_v)
        self.nmm_tauc = cfg.get_number("regional.no_model_yield_stress", "Pa")

        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.Hmin = cfg.get_number("geometry.ice_free_thickness_standard")
        self.adaptive_ratio = cfg.get_number("time_stepping.adaptive_ratio")
        self.max_dt = cfg.get_number("time_stepping.maximum_time_step", "seconds")
        self.cfl_factor = cfg.get_number("time_stepping.cfl_factor")
        self.geometry_evolves = cfg.get_flag("geometry.update.enabled")
        self.use_smb = cfg.get_flag("geometry.update.use_surface_mass_balance")
        self.use_bmr = cfg.get_flag("geometry.update.use_basal_melt_rate")
        self.bmr_grounded_frac = cfg.get_flag(
            "energy.basal_melt.use_grounded_cell_fraction")
        self.part_grid = cfg.get_flag("geometry.part_grid.enabled")
        self.part_grid_iters = cfg.get_int("geometry.part_grid.max_iterations")
        self.subgl = cfg.get_flag("geometry.grounded_cell_fraction")
        self.skip_max = cfg.get_int("time_stepping.skip.max") \
            if cfg.get_flag("time_stepping.skip.enabled") else 1

        # iterative till-friction-angle optimization target (tillphi_opt)
        if getattr(self.yield_stress, "opt_enabled", False) \
                and self.tillphi_target is None:
            path = cfg.get_string(
                "basal_yield_stress.mohr_coulomb.tillphi_opt.file")
            if path:
                from ..io.bootstrap import read_and_regrid
                self.tillphi_target = read_and_regrid(
                    path, self.grid, ["usurf"])["usurf"]

        self.device_loop = cfg.get_flag("runtime.device_loop")
        self._advance_device = jax.jit(self._make_advance())
        self._step_jit = jax.jit(self._step)

    def _advance(self, state, t0, t_end):
        """One segment: on-device while_loop, or host-dispatched steps."""
        if self.device_loop:
            return self._advance_device(state, t0, t_end)
        t = jnp.float64(t0)
        stats = StepStats.zero(shape2=self.grid.shape2)
        while float(t) < float(t_end) - 1e-6:
            state, t, stats = self._step_jit(state, t, jnp.float64(t_end), stats)
        return state, t, stats

    # ------------------------------------------------------------------ step
    def _compute_dt(self, sb: StressBalanceResult, t, t_end,
                    front_retreat_dt=None):
        """Adaptive dt. With the skip mechanism, the mass-transport
        stability limits allow skip_max substeps per expensive update, so
        the step dt is skip_max times the mass limit (substeps divide it
        back down)."""
        grid = self.grid
        inf = jnp.asarray(jnp.inf, jnp.float64)
        # reference -fixed_dt / time_stepping.adaptive_timestepping: a
        # positive dt_force (or adaptive off) bypasses the stability limits
        # entirely; the segment end still truncates
        dtf = self.config.get_number("time_stepping.dt_force", "seconds")
        if dtf > 0.0 or not self.config.get_flag(
                "time_stepping.adaptive_timestepping"):
            dt = jnp.asarray(dtf if dtf > 0.0 else self.max_dt, jnp.float64)
            idx = jnp.asarray(0, jnp.int32)   # attribute to "max_dt"
            ends = t_end - t <= dt
            idx = jnp.where(ends, 8, idx)
            return jnp.minimum(dt, t_end - t), idx
        # candidate limits indexed by DT_LIMITS (inf = not applicable); the
        # argmin attributes each step to its binding restriction, the
        # analog of the per-step restriction PISM prints in its summary
        cand = [inf] * len(DT_LIMITS)
        cand[0] = jnp.asarray(self.max_dt, jnp.float64)
        # mass-transport limits allow skip_max substeps per expensive update
        if self.stress_balance.has_sia:
            cand[1] = self.skip_max * jnp.asarray(
                sia_ops.max_timestep_diffusivity(
                    sb.max_diffusivity, grid.dx, grid.dy,
                    self.adaptive_ratio), jnp.float64)
        if self.stress_balance.model not in ("sia", "none"):
            cand[2] = self.skip_max * jnp.asarray(
                self.cfl_factor * ge.max_timestep_cfl_2d(
                    sb.u_face_e, sb.v_face_n, grid.dx, grid.dy), jnp.float64)
        if sb.sia3 is not None:
            from ..ops.sia3d import max_timestep_cfl_3d
            cand[3] = jnp.asarray(self.cfl_factor * max_timestep_cfl_3d(
                sb.sia3.max_u, sb.sia3.max_v, grid.dx, grid.dy), jnp.float64)
        if self.hydrology is not None:
            lim = self.hydrology.max_timestep()
            if lim is not None:
                cand[4] = jnp.asarray(lim, jnp.float64)
        if self.surface is not None:
            lim = self.surface.max_timestep(t)
            if lim is not None and float(lim) != float(jnp.inf):
                cand[5] = jnp.asarray(lim, jnp.float64)
        if front_retreat_dt is not None:
            cand[9] = jnp.asarray(front_retreat_dt, jnp.float64)
        stack = jnp.stack(cand)
        dt = jnp.min(stack)
        idx = jnp.argmin(stack).astype(jnp.int32)
        # reference time_stepping.resolution: round dt down to a whole
        # multiple so the step sequence is reproducible and independent of
        # fp noise in the limits. Applied BEFORE hit_multiples/segment-end
        # truncation so exact landings stay exact.
        res = self.config.get_number("time_stepping.resolution", "seconds")
        if res > 0.0:
            # the 1e-3 boundary tolerance keeps the quantization from
            # amplifying reduction-order noise in the limits (psum-order
            # differences between device-mesh shapes reach ~1e-5 s on
            # day-scale dts) into whole-resolution dt differences: raw dts
            # within a millisecond-of-res below a multiple round to that
            # multiple on every mesh. The <= 1 ms round-up overshoot is
            # far inside the limits' own safety factors.
            dt_r = jnp.floor(dt / res + 1e-3) * res
            dt = jnp.where(dt_r >= res, dt_r, dt)
        # reference -timestep_hit_multiples: truncate dt so the step lands
        # exactly on integer multiples of the period (forcing-update epochs)
        hit = self.config.get_number("time_stepping.hit_multiples", "seconds")
        if hit > 0.0:
            # the +1e-9 tolerance keeps a step that landed on a multiple
            # from producing a zero-length follow-up step
            next_mult = (jnp.floor(t / hit + 1e-9) + 1.0) * hit
            truncated = next_mult - t <= dt
            dt = jnp.where(truncated, next_mult - t, dt)
            idx = jnp.where(truncated, 6, idx)
        # guards: guaranteed progress (dt floor) and NaN containment
        min_dt = self.config.get_number("time_stepping.minimum_time_step", "seconds")
        floored = ~jnp.isfinite(dt) | (dt < min_dt)
        dt = jnp.where(jnp.isfinite(dt), jnp.maximum(dt, min_dt), min_dt)
        idx = jnp.where(floored, 7, idx)
        ends = t_end - t <= dt
        idx = jnp.where(ends, 8, idx)
        return jnp.minimum(dt, t_end - t), idx

    def _step(self, state: S.ModelState, t, t_end, stats: StepStats):
        grid, sh, cfg = self.grid, self.sh, self.config

        # 0. sea-level forcing (PISM updates the sea level before dynamics
        # so the flotation mask sees the current value) --------------------
        if self.sea_level is not None:
            geom0 = state.geometry
            sl = jnp.asarray(self.sea_level(geom0, t),
                             geom0.ice_thickness.dtype)
            geom0 = S.ensure_consistency(
                geom0.replace(sea_level=jnp.broadcast_to(sl, geom0.sea_level.shape)),
                self.rho_i, self.rho_w, self.Hmin, self.subgl)
            state = state.replace(geometry=geom0)

        # 1-2. stress balance and adaptive dt ------------------------------
        tau_c = None
        if self.yield_stress is not None:
            tau_c = self.yield_stress.compute(state, t=t)
            if self.no_model_mask is not None:
                # RegionalYieldStress: a very large yield stress in the
                # no-model strip pins the sliding velocity there
                tau_c = jnp.where(jnp.asarray(self.no_model_mask, bool),
                                  jnp.asarray(self.nmm_tauc, tau_c.dtype),
                                  tau_c)
        wcp = None
        if self.ocean is not None:
            # melange back-pressure modifiers raise the front water-column
            # pressure; None = hydrostatic default inside the SSA
            wcp = self.ocean.water_column_pressure(state.geometry, t)
        sb_state = state
        if self.ssa_extrap and state.u_ssa_prev is not None \
                and state.u_ssa is not None:
            # time-extrapolated Newton warm start: u0 = u(-1) +
            # (dt(-1)/dt(-2)) (u(-1) - u(-2)); with dt quasi-constant this
            # removes the O(dt) initial residual of the plain carry. Only a
            # solver initial guess — no physics depends on it.
            r = jnp.where(state.dt_prev > 0.0, 1.0, 0.0).astype(
                state.u_ssa.dtype)
            sb_state = state.replace(
                u_ssa=state.u_ssa + r * (state.u_ssa - state.u_ssa_prev),
                v_ssa=state.v_ssa + r * (state.v_ssa - state.v_ssa_prev))
        sb = self.stress_balance.update(sb_state, tau_c,
                                        water_column_pressure=wcp, t=t)
        fr_dt = None
        if self.front_retreat_cfl:
            hB0 = None
            if "vonmises_calving" in self.calving.methods \
                    and self.ssa is not None:
                hB0 = self.ssa._hardness(state)
            fm0 = None
            if self.frontal_melt is not None:
                fm0 = self.frontal_melt(state.geometry, t, state=state)
            fr_dt = self.calving.max_timestep(
                state.geometry, sb, hardness_B=hB0, frontal_melt_rate=fm0)
        dt, dt_limit_idx = self._compute_dt(sb, t, t_end,
                                            front_retreat_dt=fr_dt)
        dt_f = dt.astype(state.geometry.ice_thickness.dtype)

        if getattr(self.surface, "stateful", False) \
                and state.snow_depth is not None:
            from ..coupler.surface import SurfaceCarry
            smb_in, carry = self.surface.update(
                state.geometry, t, dt_f,
                SurfaceCarry(snow=state.snow_depth, firn=state.firn_depth,
                             albedo=state.surface_albedo))
            state = state.replace(snow_depth=carry.snow,
                                  firn_depth=carry.firn,
                                  surface_albedo=carry.albedo)
        elif getattr(self.surface, "midpoint_sampling", False):
            # piecewise-constant file forcing: the step's value is the
            # slice covering the interval midpoint (see GivenStreamed)
            smb_in = self.surface(state.geometry, t + 0.5 * dt)
        else:
            smb_in = self.surface(state.geometry, t)

        # 3. energy (enthalpy) step ---------------------------------------
        if self.energy_model is not None:
            if state.geothermal_flux is not None:
                G = jnp.asarray(state.geothermal_flux,
                                state.geometry.ice_thickness.dtype)
            else:
                G = jnp.full(state.geometry.ice_thickness.shape,
                             self.geothermal,
                             state.geometry.ice_thickness.dtype)
            if self.btu is not None and state.bedrock_temperature is not None:
                p_b = self.EC.pressure(state.geometry.ice_thickness)
                T_base = self.EC.temperature(state.enthalpy[..., 0], p_b)
                bed_T, G = self.btu.step(state.bedrock_temperature, T_base,
                                         G, dt_f)
                state = state.replace(bedrock_temperature=bed_T)
            eres = self.energy_model.step(
                state, sb.sia3, smb_in.temperature, dt_f,
                geothermal_flux=G,
                frictional_heating=sb.basal_frictional_heating,
                tillwat=state.tillwat,
                ch_enthalpy=state.ch_enthalpy,
                surface_melt=getattr(smb_in, "melt", None))
            state = state.replace(enthalpy=eres.enthalpy,
                                  basal_melt_rate=eres.basal_melt_rate)
            if eres.ch_enthalpy is not None:
                state = state.replace(ch_enthalpy=eres.ch_enthalpy)

        # 4. age transport --------------------------------------------------
        if self.age_model is not None and state.age is not None and sb.sia3 is not None:
            state = state.replace(age=self.age_model.step(state, sb.sia3, dt_f))

        # 4b. fracture density ----------------------------------------------
        if self.fracture is not None and state.fracture_density is not None \
                and sb.u_ssa is not None:
            fr_hard = None
            if (self.fracture.max_shear or self.fracture.lefm) \
                    and self.ssa is not None:
                fr_hard = self.ssa._hardness(state)
            fres = self.fracture.step(state, sb.u_ssa, sb.v_ssa, dt_f,
                                      hardness=fr_hard)
            state = state.replace(fracture_density=fres.density,
                                  fracture_age=fres.age)

        # 5. hydrology -----------------------------------------------------
        if self.hydrology is not None:
            kw = {}
            if getattr(self.hydrology, "input_from_runoff", False):
                # reference hydrology.surface_input_from_runoff: the surface
                # model's runoff feeds the subglacial system
                kw["runoff"] = getattr(smb_in, "runoff", None)
            from ..physics.hydrology import Steady as _Steady
            if isinstance(self.hydrology, _Steady):
                kw["t"] = t + dt   # step END time (interval-crossing test)
            state = self.hydrology.step(state, dt_f, **kw)

        # 7. mass transport ------------------------------------------------
        geometry = state.geometry
        iso_on = self.isochrones is not None and state.iso_layers is not None
        iso_carry = (state.iso_layers, state.iso_top) if iso_on else None
        if self.geometry_evolves:
            def mass_substep(geometry, iso_carry, dt_sub, qe_d=None, qn_d=None):
                """One mass-continuity substep with frozen sliding
                velocities; the (cheap) SIA diffusive flux is recomputed
                from the current geometry unless supplied."""
                if qe_d is None and self.stress_balance.has_sia:
                    flux = sia_ops.diffusivity(
                        self.stress_balance.sia_flow_law, geometry,
                        state.enthalpy, grid, sh,
                        n=self.stress_balance.n_sia,
                        enhancement=self.stress_balance.e_sia,
                        rho=self.rho_i, g=self.stress_balance.g,
                        gradient_method=self.stress_balance.gradient_method,
                        d_limit=self.stress_balance.d_limit)
                    qe_d, qn_d = flux.qe, flux.qn
                elif qe_d is None:
                    qe_d = jnp.zeros_like(geometry.ice_thickness)
                    qn_d = qe_d
                qe_adv, qn_adv = ge.advective_flux(
                    sb.u_face_e, sb.v_face_n, geometry.ice_thickness, sh)
                res = ge.flow_step(geometry, dt_sub, qe_d + qe_adv,
                                   qn_d + qn_adv, grid, sh,
                                   part_grid=self.part_grid,
                                   part_grid_iterations=self.part_grid_iters)
                H = res.thickness
                if res.Href is not None:
                    geometry = geometry.replace(ice_area_specific_volume=res.Href)

                bmb = jnp.zeros_like(H)
                if state.basal_melt_rate is not None and self.use_bmr:
                    bmb = bmb + state.basal_melt_rate
                if self.ocean is not None:
                    shelf_melt = self.ocean(geometry, t)
                    if self.bmr_grounded_frac and self.subgl:
                        # reference energy.basal_melt.use_grounded_cell_
                        # fraction: sub-shelf melt acts on the floating part
                        # of partially grounded grounding-line cells
                        f = geometry.cell_grounded_fraction
                        w = jnp.where(S.floating_ice(geometry.cell_type),
                                      1.0, 1.0 - f)
                        w = jnp.where(S.icy(geometry.cell_type), w, 0.0)
                        bmb = bmb + w * shelf_melt
                    else:
                        bmb = bmb + jnp.where(
                            S.floating_ice(geometry.cell_type),
                            shelf_melt, 0.0)
                smb_eff = smb_in.smb if self.use_smb \
                    else jnp.zeros_like(H)
                H, smb_app, bmb_app, smb_field, bmb_field = ge.source_term_step(
                    H, dt_sub, smb_eff, bmb, grid.dx, grid.dy)
                if iso_carry is not None:
                    from .isochrones import IsochroneState
                    iso = IsochroneState(
                        layers=iso_carry[0], top=iso_carry[1],
                        deposition_times=jnp.asarray(self._iso_times_arr))
                    iso = self.isochrones.step(
                        iso, t, dt_sub, res.Qe, res.Qn,
                        geometry.ice_thickness, H, smb_eff, bmb)
                    iso_carry = (iso.layers, iso.top)
                geometry = geometry.replace(ice_thickness=H)
                geometry = S.ensure_consistency(
                    geometry, self.rho_i, self.rho_w, self.Hmin, self.subgl)
                div_vol = jnp.sum(res.flux_divergence) * grid.dx * grid.dy
                return geometry, iso_carry, (smb_app, bmb_app, div_vol,
                                             res.nonneg_flux, res.flow_field,
                                             smb_field, bmb_field,
                                             res.nonneg_field)

            if self.skip_max > 1:
                # PISM's "skip": several cheap mass substeps per expensive
                # stress-balance/energy update (dt here is skip_max * the
                # mass-step limit, selected in _compute_dt)
                dt_sub = dt_f / self.skip_max

                # reference parity: PISM's skip freezes the WHOLE stress
                # balance - including the SIA diffusive flux - across the
                # substeps (src/icemodel/timestepping.cc skip semantics);
                # refresh_diffusivity recomputes D(H) per substep instead
                # (more accurate at strongly-evolving fronts, ~10 extra
                # z-integral stencils per mega-step at skip 10)
                refresh = self.config.get_flag(
                    "time_stepping.skip.refresh_diffusivity")
                qe_frozen = None if refresh else sb.qe
                qn_frozen = None if refresh else sb.qn

                def body(_, carry):
                    geometry, iso_c, acc = carry
                    geometry, iso_c, vals = mass_substep(
                        geometry, iso_c, dt_sub, qe_frozen, qn_frozen)
                    return geometry, iso_c, tuple(a + v for a, v in zip(acc, vals))

                z = jnp.zeros((), self.dtype)
                z2 = jnp.zeros(geometry.ice_thickness.shape, self.dtype)
                geometry, iso_carry, vals = \
                    jax.lax.fori_loop(0, self.skip_max, body,
                                      (geometry, iso_carry,
                                       (z, z, z, z, z2, z2, z2, z2)))
                # substeps each contribute a rate over dt/skip_max; the
                # average rate over the full step is the sum / skip_max
                (smb_app, bmb_app, div_vol, nonneg, flow_2d, smb_2d, bmb_2d,
                 nonneg_2d) = tuple(v / self.skip_max for v in vals)
            else:
                geometry, iso_carry, (smb_app, bmb_app, div_vol, nonneg,
                                      flow_2d, smb_2d, bmb_2d, nonneg_2d) = \
                    mass_substep(geometry, iso_carry, dt_f, sb.qe, sb.qn)
        else:
            smb_app = bmb_app = div_vol = nonneg = jnp.zeros((), self.dtype)
            flow_2d = smb_2d = bmb_2d = nonneg_2d = \
                jnp.zeros(geometry.ice_thickness.shape, self.dtype)

        if iso_on:
            state = state.replace(iso_layers=iso_carry[0], iso_top=iso_carry[1])

        # 8. calving / front retreat --------------------------------------
        discharge_vol = jnp.zeros((), self.dtype)
        discharge_2d = jnp.zeros(geometry.ice_thickness.shape, self.dtype)
        cell_area = jnp.asarray(self.grid.dx * self.grid.dy, self.dtype)
        parts_2d = {k: discharge_2d for k in
                    ("calving", "frontal_melt", "forced_retreat")}
        if self.calving is not None:
            C_pre_calving = geometry.ice_thickness \
                + geometry.ice_area_specific_volume
            hardness_B = None
            if "vonmises_calving" in self.calving.methods \
                    and self.ssa is not None:
                hardness_B = self.ssa._hardness(state.replace(geometry=geometry))
            fm_rate = None
            if self.frontal_melt is not None:
                fm_rate = self.frontal_melt(geometry, t, state=state)
            geometry, parts_2d = self.calving.step(
                geometry, sb, dt_f, t=t, hardness_B=hardness_B,
                frontal_melt_rate=fm_rate, with_parts=True)
            geometry = S.ensure_consistency(geometry, self.rho_i, self.rho_w, self.Hmin, self.subgl)
            # discharge bookkeeping (reference GeometryEvolution: the ice
            # content removed by calving/front retreat, H + Href so partial-
            # cell conversions don't count; negative = mass loss)
            discharge_2d = geometry.ice_thickness \
                + geometry.ice_area_specific_volume - C_pre_calving
            discharge_vol = jnp.sum(discharge_2d) \
                * jnp.asarray(self.grid.dx * self.grid.dy, self.dtype)

        if self.ssa_extrap and state.u_ssa_prev is not None:
            state = state.replace(
                geometry=geometry, u_ssa=sb.u_ssa, v_ssa=sb.v_ssa,
                u_ssa_prev=state.u_ssa, v_ssa_prev=state.v_ssa,
                dt_prev=jnp.asarray(dt, state.dt_prev.dtype))
        else:
            state = state.replace(geometry=geometry, u_ssa=sb.u_ssa,
                                  v_ssa=sb.v_ssa)

        # 8b. regional mode: freeze state in the no-model strip -------------
        if self.no_model_mask is not None and self._nmm_ref is not None:
            nmm = jnp.asarray(self.no_model_mask, bool)
            H_ref, E_ref = self._nmm_ref
            geom_r = state.geometry
            geom_r = geom_r.replace(ice_thickness=jnp.where(
                nmm, H_ref, geom_r.ice_thickness))
            geom_r = S.ensure_consistency(geom_r, self.rho_i, self.rho_w,
                                          self.Hmin, self.subgl)
            state = state.replace(geometry=geom_r)
            if E_ref is not None and state.enthalpy is not None:
                state = state.replace(enthalpy=jnp.where(
                    nmm[..., None], E_ref, state.enthalpy))

        # 9. bed deformation ----------------------------------------------
        if self.bed_deformation is not None:
            state = self.bed_deformation.step(state, dt_f, t=t + dt_f)
            state = state.replace(geometry=S.ensure_consistency(
                state.geometry, self.rho_i, self.rho_w, self.Hmin))

        stats = StepStats(
            nsteps=stats.nsteps + 1,
            dt_min=jnp.minimum(stats.dt_min, dt),
            dt_max=jnp.maximum(stats.dt_max, dt),
            sum_div_flux=stats.sum_div_flux + jnp.float64(dt_f * div_vol),
            sum_smb=stats.sum_smb + jnp.float64(dt * smb_app),
            sum_bmb=stats.sum_bmb + jnp.float64(dt * bmb_app),
            sum_nonneg=stats.sum_nonneg + jnp.float64(dt * nonneg),
            sum_discharge=stats.sum_discharge + jnp.float64(discharge_vol),
            sum_calving=stats.sum_calving
            + jnp.float64(jnp.sum(parts_2d["calving"]) * cell_area),
            sum_frontal_melt=stats.sum_frontal_melt
            + jnp.float64(jnp.sum(parts_2d["frontal_melt"]) * cell_area),
            sum_forced_retreat=stats.sum_forced_retreat
            + jnp.float64(jnp.sum(parts_2d["forced_retreat"]) * cell_area),
            cell=None if stats.cell is None else CellBudget(
                flow=stats.cell.flow + jnp.float64(dt) * flow_2d,
                smb=stats.cell.smb + jnp.float64(dt) * smb_2d,
                bmb=stats.cell.bmb + jnp.float64(dt) * bmb_2d,
                nonneg=stats.cell.nonneg + jnp.float64(dt) * nonneg_2d,
                discharge=stats.cell.discharge + discharge_2d,
                calving=stats.cell.calving + parts_2d["calving"],
                frontal_melt=stats.cell.frontal_melt
                + parts_2d["frontal_melt"],
                forced_retreat=stats.cell.forced_retreat
                + parts_2d["forced_retreat"],
            ),
            limit_hits=None if stats.limit_hits is None
            else stats.limit_hits.at[dt_limit_idx].add(1),
            max_diffusivity=None if stats.max_diffusivity is None
            else jnp.maximum(stats.max_diffusivity,
                             jnp.float64(sb.max_diffusivity)),
        )
        return state, t + dt, stats

    def _make_advance(self):
        max_steps = self.config.get_int("time_stepping.max_steps_per_segment")

        def advance(state, t0, t_end):
            eps = 1e-6

            def cond(carry):
                _, t, stats = carry
                return (t < t_end - eps) & (stats.nsteps < max_steps)

            def body(carry):
                st_, t, stats = carry
                return self._step(st_, t, t_end, stats)

            stats0 = StepStats.zero(shape2=self.grid.shape2)
            return jax.lax.while_loop(cond, body, (state, jnp.float64(t0), stats0))

        return advance

    def prepare_state(self, state: S.ModelState) -> S.ModelState:
        """Fill in fields required by the enabled components (the step
        function must be pytree-structure-stable for lax.while_loop)."""
        # derived geometry honors this model's sub-grid setting (initial
        # states and checkpoints may have been built with another)
        state = state.replace(geometry=S.ensure_consistency(
            state.geometry, self.rho_i, self.rho_w, self.Hmin, self.subgl))
        H = state.geometry.ice_thickness
        z2 = jnp.zeros_like(H)
        kw = {}
        if self.hydrology is not None:
            from ..physics.hydrology import Distributed, Routing, Steady
            if state.tillwat is None:
                kw["tillwat"] = z2
            if isinstance(self.hydrology, Routing) and state.hydro_W is None:
                kw["hydro_W"] = z2
            if isinstance(self.hydrology, Distributed) and state.hydro_P is None:
                kw["hydro_P"] = self.rho_i \
                    * self.config.get_number("constants.standard_gravity") * H
            if isinstance(self.hydrology, Steady) and state.hydro_Q is None:
                kw["hydro_Q"] = z2
            if not isinstance(self.hydrology, Steady) \
                    and state.hydro_Q is not None:
                # a checkpointed steady-discharge field from a previous run
                # would otherwise shadow the live hydrology in the
                # frontal-melt coupling forever
                kw["hydro_Q"] = None
        if self.energy_model is not None and state.basal_melt_rate is None:
            kw["basal_melt_rate"] = z2
        if self.age_model is not None and state.age is None:
            # reference age.initial_value: uniform initial ice age when the
            # input file carries none
            age0 = self.config.get_number("age.initial_value", "seconds")
            kw["age"] = jnp.full(H.shape + (self.grid.Mz,), age0, H.dtype)
        if state.till_phi is None \
                and getattr(self.yield_stress, "t2p_enabled", False):
            # reference -topg_to_phi: friction angle from the INITIAL bed
            kw["till_phi"] = self.yield_stress.topg_to_phi(
                state.geometry.bed_elevation)
        if getattr(self.yield_stress, "opt_enabled", False):
            if state.till_phi is None and "till_phi" not in kw:
                kw["till_phi"] = jnp.full_like(
                    H, self.yield_stress.phi_default)
            if self.tillphi_target is None:
                # no file given: target = the initial (observed) surface
                self.tillphi_target = np.asarray(
                    state.geometry.ice_surface_elevation)
        if self.stress_balance.model not in ("sia", "none"):
            if state.u_ssa is None:
                kw["u_ssa"] = z2
            if state.v_ssa is None:
                kw["v_ssa"] = z2
        if self.ssa_extrap:
            if state.u_ssa_prev is None:
                kw["u_ssa_prev"] = kw.get("u_ssa", state.u_ssa
                                          if state.u_ssa is not None else z2)
                kw["v_ssa_prev"] = kw.get("v_ssa", state.v_ssa
                                          if state.v_ssa is not None else z2)
                kw["dt_prev"] = jnp.zeros((), jnp.float64)
        if self.fracture is not None:
            if state.fracture_density is None:
                kw["fracture_density"] = z2
            if state.fracture_age is None:
                kw["fracture_age"] = z2
        if getattr(self.surface, "stateful", False):
            if state.snow_depth is None:
                kw["snow_depth"] = z2
            if state.firn_depth is None:
                kw["firn_depth"] = z2
            if getattr(self.surface, "uses_albedo", False) \
                    and state.surface_albedo is None:
                base = self.surface
                while not hasattr(base, "initial_albedo") \
                        and getattr(base, "inner", None) is not None:
                    base = base.inner
                kw["surface_albedo"] = jnp.full(
                    H.shape, getattr(base, "initial_albedo", 0.8), H.dtype)
        if self.isochrones is not None and state.iso_layers is None:
            iso0 = self.isochrones.initialize(H, self._iso_dep_times)
            kw["iso_layers"] = iso0.layers
            kw["iso_top"] = iso0.top
            self._iso_times_arr = iso0.deposition_times
        if self.no_model_mask is not None and self._nmm_ref is None:
            self._nmm_ref = (state.geometry.ice_thickness, state.enthalpy)
            # usurfstore/thkstore (reference IceRegionalModel): default to
            # the initial geometry unless supplied (e.g. read from file)
            if self.usurf_store is None:
                self.usurf_store = state.geometry.ice_surface_elevation
            if self.thk_store is None:
                self.thk_store = state.geometry.ice_thickness
            if self.ssa is not None and hasattr(self.ssa, "stored_surface"):
                self.ssa.stored_surface = self.usurf_store
                self.ssa.stored_thickness = self.thk_store
            self.stress_balance.stored_surface = self.usurf_store
        if self.calving is not None and "ocean_kill" in self.calving.methods \
                and self.calving.ocean_kill_mask is None:
            okf = self.config.get_string("calving.ocean_kill.file")
            if okf:
                # reference -ocean_kill_file: cells with thk <= 0 and
                # ocean-depth bed in the file form the kill mask
                from ..io.bootstrap import read_and_regrid
                flds = read_and_regrid(okf, self.grid,
                                       ["thk", "land_ice_thickness"])
                thk = flds.get("thk", flds.get("land_ice_thickness"))
                if thk is None:
                    raise ValueError(f"{okf!r} has no thk variable")
                self.calving.ocean_kill_mask = jnp.asarray(
                    np.nan_to_num(np.asarray(thk)) <= 0.0)
            else:
                # PISM ocean_kill defaults its kill mask to the input file's
                # ice-free-ocean cells; here: the initial state's
                self.calving.ocean_kill_mask = \
                    state.geometry.cell_type == S.MASK_ICE_FREE_OCEAN
        if self.bed_deformation is not None and state.bed_reference is None:
            state = self.bed_deformation.initialize(state.replace(**kw))
            kw = {}
        if self.energy_model is not None and state.enthalpy is None:
            from .energy import bootstrap_enthalpy
            smb = self.surface(state.geometry, 0.0)
            G0 = state.geothermal_flux if state.geothermal_flux is not None \
                else self.config.get_number(
                    "bootstrapping.defaults.geothermal_flux")
            kw["enthalpy"] = bootstrap_enthalpy(
                self.grid, self.EC, H, smb.temperature,
                geothermal=G0).astype(H.dtype)
        if self.btu is not None and state.bedrock_temperature is None:
            E0 = state.enthalpy if state.enthalpy is not None \
                else kw.get("enthalpy")
            btf = self.config.get_string("energy.bedrock_thermal.file")
            if btf:
                # reference energy.bedrock_thermal.file: initial bedrock
                # temperature column profile (litho_temp)
                from ..io.nc4 import File as _File
                with _File(btf, "r") as f:
                    if not f.has_variable("litho_temp"):
                        raise ValueError(f"{btf!r} has no litho_temp")
                    lt = np.asarray(f.read("litho_temp"), float)
                if lt.ndim == 4:
                    lt = lt[-1]
                kw["bedrock_temperature"] = jnp.asarray(lt)
            elif E0 is not None:
                # steady conductive column from the basal ice temperature
                p_b = self.EC.pressure(H)
                T_base = self.EC.temperature(E0[..., 0], p_b)
                G0 = state.geothermal_flux \
                    if state.geothermal_flux is not None else self.geothermal
                kw["bedrock_temperature"] = self.btu.init_temperature(
                    T_base, jnp.asarray(G0))
        if self.energy_model is not None \
                and getattr(self.energy_model, "ch_enabled", False) \
                and state.ch_enthalpy is None:
            # the CH system starts in thermal equilibrium with the ice
            E0 = kw.get("enthalpy", state.enthalpy)
            if E0 is not None:
                kw["ch_enthalpy"] = E0
        return state.replace(**kw) if kw else state

    def _check_health(self, state: S.ModelState, t: float) -> None:
        """Host-side non-finite-state detection at segment boundaries: the
        reference's SSAFD convergence-failure path dumps the model state to
        ``SSAFD_failed.nc`` and aborts (``SSAFD::picard_iteration``
        failure strategies, SURVEY.md §5.3); in the traced loop a broken
        solve surfaces as NaNs, detected here."""
        H = state.geometry.ice_thickness
        bad = bool(jnp.isnan(H).any())
        if not bad and state.u_ssa is not None:
            bad = bool(jnp.isnan(state.u_ssa).any())
        if bad:
            from ..io import checkpoint as ckpt
            path = "SSAFD_failed.nc"
            try:
                ckpt.save_state(path, state, self.grid, t, config=self.config)
            except Exception:
                path = "(state dump failed)"
            raise RuntimeError(
                "non-finite model state at t = "
                f"{t / 3.15569259747e7:.3f} a (solver failure); "
                f"state dumped to {path}")
        # reference energy.minimum_allowed_temperature /
        # energy.max_low_temperature_count: too-cold ice indicates a broken
        # energy solve; tolerate a few cells, abort beyond the count
        if state.enthalpy is not None and self.energy_model is not None:
            cfg = self.config
            T_min = cfg.get_number("energy.minimum_allowed_temperature")
            n_max = cfg.get_int("energy.max_low_temperature_count")
            z = jnp.asarray(self.grid.z)
            H3 = state.geometry.ice_thickness[..., None]
            depth = jnp.maximum(H3 - z, 0.0)
            p = self.EC.pressure(depth)
            T = self.EC.temperature(state.enthalpy, p)
            in_ice = (z <= H3) & S.icy(state.geometry.cell_type)[..., None]
            n_low = int(jnp.sum(in_ice & (T < T_min)))
            if n_low > n_max:
                raise RuntimeError(
                    f"{n_low} ice cells below "
                    f"energy.minimum_allowed_temperature ({T_min:.1f} K) "
                    f"at t = {t / 3.15569259747e7:.3f} a (limit {n_max})")

    def _check_thickness(self, state: S.ModelState) -> None:
        """PISM aborts when the ice thickness reaches the top of the
        computational box (``IceModel::check_maximum_ice_thickness``): the
        column solvers' surface boundary condition needs the surface
        strictly inside the grid. Host-side check at segment boundaries."""
        Hmax = float(jnp.max(state.geometry.ice_thickness))
        # reference geometry.ice_thickness.max: plausibility cap independent
        # of the grid box (catches runaway feedbacks)
        H_cap = self.config.get_number("geometry.ice_thickness.max")
        if H_cap > 0.0 and Hmax > H_cap:
            raise RuntimeError(
                f"ice thickness ({Hmax:.1f} m) exceeds "
                f"geometry.ice_thickness.max ({H_cap:.1f} m)")
        if self.energy_model is None and self.age_model is None:
            return
        if Hmax >= self.grid.Lz:
            raise RuntimeError(
                f"ice thickness ({Hmax:.1f} m) reaches the top of the "
                f"computational box (Lz = {self.grid.Lz:.1f} m); increase "
                "grid.Lz (PISM aborts identically)")

    # ------------------------------------------------------------------ API
    def run(self, state: S.ModelState, time: Time,
            segment_seconds: Optional[float] = None,
            callback: Optional[Callable] = None,
            output: Optional[object] = None,
            signals: Optional[object] = None):
        """Advance from time.start to time.end.

        ``output``: an ``OutputManager``; segments are clamped to its next
        requested output time so snapshots/series land exactly (PISM
        ``hit_extra_times``). ``callback(state, t, stats)`` additionally runs
        at every segment boundary. ``signals``: a ``SignalMonitor`` polled
        between segments — SIGUSR1 writes a backup and continues, SIGTERM
        ends the run cleanly after the current segment (reference
        ``IceModel::process_signals``). The reached time is returned in
        ``stats.t_reached`` via the callback's ``t`` argument; callers that
        need it should capture it there.
        """
        if segment_seconds is None:
            segment_seconds = self.config.get_number("runtime.segment_years", "seconds")
        state = self.prepare_state(state)
        self._check_thickness(state)
        t = time.start
        total_stats = None
        if output is not None and hasattr(output, "start"):
            output.start(state, t, self)
        # iterative tillphi optimization: updates every opt_dt model seconds
        # at segment boundaries (the reference applies them inside its step
        # at the same multiples of tillphi_opt.dt)
        opt_on = getattr(self.yield_stress, "opt_enabled", False)
        t_opt = t + self.yield_stress.opt_dt if opt_on else np.inf
        while t < time.end - 1e-6:
            t_seg = min(t + segment_seconds, time.end)
            if output is not None:
                t_seg = min(t_seg, output.next_time(t))
            t_seg = min(t_seg, t_opt)
            state, t_dev, stats = self._advance(state, t, t_seg)
            t = float(t_dev)
            if opt_on and t >= t_opt - 1e-6:
                state = self.yield_stress.optimize_tillphi(
                    state, self.tillphi_target)
                t_opt = t + self.yield_stress.opt_dt
            self._check_thickness(state)
            self._check_health(state, t)
            # reference SIAFD max_diffusivity check: without the
            # limit_diffusivity cap, a diffusivity beyond the sanity limit
            # stops the run unless max_diffusivity_allow_unlimited
            if (self.stress_balance.has_sia
                    and self.stress_balance.d_limit is None
                    and stats.max_diffusivity is not None
                    and not self.config.get_flag(
                        "stress_balance.sia.max_diffusivity_allow_unlimited")):
                d_cap = self.config.get_number(
                    "stress_balance.sia.max_diffusivity")
                d_seen = float(stats.max_diffusivity)
                if d_seen > d_cap:
                    raise RuntimeError(
                        f"SIA diffusivity ({d_seen:.1f} m2/s) exceeds "
                        f"stress_balance.sia.max_diffusivity ({d_cap:.1f}); "
                        "set stress_balance.sia.limit_diffusivity or "
                        "max_diffusivity_allow_unlimited (PISM stops "
                        "identically)")
            total_stats = _merge_stats(total_stats, stats)
            if output is not None:
                output.process(state, t, self, stats=total_stats)
            if callback is not None:
                callback(state, t, stats)
            if signals is not None:
                if signals.take_backup_request() and output is not None:
                    output.write_backup(state, t)
                if signals.stop_requested():
                    log.message(1, "caught SIGTERM: stopping at t = %.2f a",
                                t / 3.15569259747e7)
                    break
        return state, total_stats

    def step_once(self, state: S.ModelState, t: float, dt_cap: float):
        """Advance by up to dt_cap seconds (adaptive steps inside).

        The device while_loop is bounded by
        ``time_stepping.max_steps_per_segment``; when the adaptive dt
        collapses (margin flicker at fine grids) a long advance becomes
        several device dispatches instead of one arbitrarily-long XLA
        execution, so the host regains control (output, signals, health
        checks) at a bounded interval. The trajectory is identical either
        way — dt depends on t_end, not on the dispatch split."""
        state = self.prepare_state(state)
        t_end = t + dt_cap
        total = None
        while True:
            state, t_new, stats = self._advance(state, t, t_end)
            total = _merge_stats(total, stats)
            t = float(t_new)
            if t >= t_end - 1e-6 or int(stats.nsteps) == 0:
                break
        return state, t, total


def _merge_stats(a: Optional[StepStats], b: StepStats) -> StepStats:
    if a is None:
        return b
    return StepStats(
        nsteps=a.nsteps + b.nsteps,
        dt_min=jnp.minimum(a.dt_min, b.dt_min),
        dt_max=jnp.maximum(a.dt_max, b.dt_max),
        sum_div_flux=a.sum_div_flux + b.sum_div_flux,
        sum_smb=a.sum_smb + b.sum_smb,
        sum_bmb=a.sum_bmb + b.sum_bmb,
        sum_nonneg=a.sum_nonneg + b.sum_nonneg,
        sum_discharge=a.sum_discharge + b.sum_discharge,
        sum_calving=a.sum_calving + b.sum_calving,
        sum_frontal_melt=a.sum_frontal_melt + b.sum_frontal_melt,
        sum_forced_retreat=a.sum_forced_retreat + b.sum_forced_retreat,
        cell=b.cell if a.cell is None else (
            a.cell if b.cell is None else CellBudget(
                *(x + y for x, y in zip(a.cell, b.cell)))),
        limit_hits=b.limit_hits if a.limit_hits is None
        else (a.limit_hits if b.limit_hits is None
              else a.limit_hits + b.limit_hits),
        max_diffusivity=b.max_diffusivity if a.max_diffusivity is None
        else (a.max_diffusivity if b.max_diffusivity is None
              else jnp.maximum(a.max_diffusivity, b.max_diffusivity)),
    )
