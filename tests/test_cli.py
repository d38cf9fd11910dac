"""CLI driver tests (PISM executable layer: src/pism.cc flag handling) —
verification run, EISMINT start + restart continuation, output scheduling
(snapshots), component-selection shorthands, regional strip flag."""

import glob
import os

import numpy as np
import pytest

from pism_tpu.cli import build_parser, main, parse_times

SPY = 3.15569259747e7


def test_parse_times():
    assert parse_times("0:10:30", 1.0) == [0.0, 10.0, 20.0, 30.0]
    assert parse_times("5,7", 2.0) == [10.0, 14.0]


def test_cli_halfar_run(tmp_path):
    out = tmp_path / "b.nc"
    rc = main(["-test", "B", "-Mx", "31", "-y", "100",
               "-o", str(out), "-verbose", "1"])
    assert rc == 0 and out.exists()
    from pism_tpu.io import checkpoint as ckpt
    state, t = ckpt.load_state(str(out))
    H = np.asarray(state.geometry.ice_thickness)
    assert np.isfinite(H).all() and H.max() > 1000.0


def test_cli_eismint_restart_and_outputs(tmp_path):
    os.chdir(tmp_path)
    out1 = tmp_path / "a.nc"
    rc = main(["-eisII", "A", "-Mx", "31", "-Mz", "11", "-y", "50",
               "-o", str(out1),
               "-save_times", "25", "-save_file", str(tmp_path / "snap_{kyr:.3f}.nc"),
               "-ts_file", str(tmp_path / "ts.nc"), "-ts_times", "0:10:50",
               "-max_dt", "5", "-verbose", "1"])
    assert rc == 0 and out1.exists()
    assert glob.glob(str(tmp_path / "snap_*.nc")), "snapshot not written"
    assert (tmp_path / "ts.nc").exists()

    # restart continuation (PISM: pism -i a.nc -y ...)
    out2 = tmp_path / "a2.nc"
    rc = main(["-eisII", "A", "-i", str(out1), "-y", "25",
               "-o", str(out2), "-verbose", "1"])
    assert rc == 0 and out2.exists()
    from pism_tpu.io import checkpoint as ckpt
    s1, t1 = ckpt.load_state(str(out1))
    s2, t2 = ckpt.load_state(str(out2))
    assert t2 == pytest.approx(t1 + 25 * SPY, rel=1e-9)
    # ice kept growing under the EISMINT A climate
    assert float(np.asarray(s2.geometry.ice_thickness).max()) \
        >= float(np.asarray(s1.geometry.ice_thickness).max())


def test_cli_shorthand_flags_map_to_config():
    """-stress_balance/-energy/... are PISM's manual-level flags; they must
    land in the same config parameters the long form sets."""
    args = build_parser().parse_args(
        ["-stress_balance", "ssa+sia", "-energy", "none",
         "-hydrology", "routing", "-calving", "float_kill",
         "-bed_def", "iso", "-skip_max", "7", "-no_model_strip", "30"])
    assert args.stress_balance == "ssa+sia"
    assert args.skip_max == 7 and args.no_model_strip == 30.0


def test_cli_regional_strip_runs(tmp_path):
    out = tmp_path / "r.nc"
    rc = main(["-test", "B", "-Mx", "31", "-y", "50", "-o", str(out),
               "-no_model_strip", "60", "-verbose", "1"])
    assert rc == 0 and out.exists()
    from pism_tpu.io import checkpoint as ckpt
    state, _ = ckpt.load_state(str(out))
    assert np.isfinite(np.asarray(state.geometry.ice_thickness)).all()


def test_cli_list_diagnostics(capsys):
    rc = main(["-list_diagnostics"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "velsurf_mag" in out and "ice_volume" in out


def test_cli_o_size_and_regrid(tmp_path):
    """-o_size medium appends diagnostics to the state file; -regrid_file
    overwrites a selected field from another file on restart (PISM
    -o_size / -regrid_file / -regrid_vars)."""
    from pism_tpu.io import checkpoint as ckpt
    from pism_tpu.io.nc4 import File

    a = tmp_path / "a.nc"
    rc = main(["-eisII", "A", "-Mx", "31", "-Mz", "11", "-y", "40",
               "-o", str(a), "-o_size", "medium", "-max_dt", "5",
               "-verbose", "1"])
    assert rc == 0
    with File(str(a)) as f:
        names = f.variables()
        assert "velsurf_mag" in names and "sftgif" in names  # medium extras
        assert "thk" in names                                 # state intact

    # build a "regrid source": same run with a perturbed thickness
    b = tmp_path / "b.nc"
    state, t = ckpt.load_state(str(a))
    import jax.numpy as jnp
    g2 = state.geometry.replace(
        ice_thickness=state.geometry.ice_thickness + 100.0)
    ckpt.save_state(str(b), state.replace(geometry=g2),
                    ckpt.load_grid(str(a)), t)

    out = tmp_path / "c.nc"
    rc = main(["-i", str(a), "-y", "0.1", "-o", str(out),
               "-regrid_file", str(b), "-regrid_vars", "thk",
               "-verbose", "1"])
    assert rc == 0
    s3, _ = ckpt.load_state(str(out))
    # regridded (perturbed) thickness was used, not the restart's own
    assert float(np.asarray(s3.geometry.ice_thickness).max()) > \
        float(np.asarray(state.geometry.ice_thickness).max()) + 50.0


def test_cli_inverse_smoke(tmp_path):
    """-inverse drives a tau_c inversion from observed velocities and
    writes tauc + the objective history into the output file (the
    reference pismi.py role)."""
    from pism_tpu.io import checkpoint as ckpt
    from pism_tpu.io.nc4 import File

    a = tmp_path / "fwd.nc"
    rc = main(["-eisII", "A", "-Mx", "25", "-Mz", "11", "-y", "30",
               "-stress_balance", "ssa+sia", "-o", str(a), "-max_dt", "5",
               "-verbose", "1"])
    assert rc == 0

    # synthetic observations: gentle outward sliding over the ice,
    # no-data (NaN) outside it
    grid = ckpt.load_grid(str(a))
    state, _ = ckpt.load_state(str(a))
    H = np.asarray(state.geometry.ice_thickness)
    SPY = 3.15569259747e7
    u = np.where(H > 10.0, 20.0 / SPY, np.nan)
    obs = tmp_path / "obs.nc"
    with File(str(obs), "w") as f:
        f.define_dimension("x", grid.Mx, values=np.asarray(grid.x),
                           attrs={"units": "m"})
        f.define_dimension("y", grid.My, values=np.asarray(grid.y),
                           attrs={"units": "m"})
        f.write("u_ssa", u, dims=("y", "x"), attrs={"units": "m s-1"})
        f.write("v_ssa", np.zeros_like(u), dims=("y", "x"),
                attrs={"units": "m s-1"})

    out = tmp_path / "inv.nc"
    rc = main(["-i", str(a), "-stress_balance", "ssa+sia", "-inverse",
               "-inv_data", str(obs), "-o", str(out),
               "-config", "inverse.max_iterations=2", "-verbose", "1"])
    assert rc == 0
    with File(str(out)) as f:
        assert f.has_variable("tauc")
        assert f.has_variable("inv_misfit")
        tauc = np.asarray(f.read("tauc"))
        hist = np.asarray(f.read("inv_misfit"))
    assert np.isfinite(tauc).all() and (tauc >= 0).all()
    assert np.isfinite(hist).all() and hist.size >= 1


def test_cli_pik_and_param_shorthands(tmp_path):
    """-pik enables the four marine mechanisms; the reference's common
    parameter shorthands (-sia_e, -pseudo_plastic_q, ...) land in the
    config stored in the output file."""
    out = tmp_path / "pik.nc"
    rc = main(["-eisII", "A", "-Mx", "19", "-Mz", "11", "-y", "5",
               "-pik", "-sia_e", "2.0", "-pseudo_plastic",
               "-pseudo_plastic_q", "0.4", "-plastic_phi", "25",
               "-o", str(out), "-verbose", "1"])
    assert rc in (0, None)
    from pism_tpu.io import checkpoint as ckpt
    cfg = ckpt.load_config(str(out))
    assert cfg.get_flag("stress_balance.calving_front_stress_bc")
    assert cfg.get_flag("geometry.part_grid.enabled")
    assert cfg.get_flag("geometry.remove_icebergs")
    assert cfg.get_flag("geometry.grounded_cell_fraction")
    assert cfg.get_number("stress_balance.sia.enhancement_factor") == 2.0
    assert cfg.get_flag("basal_resistance.pseudo_plastic.enabled")
    assert cfg.get_number("basal_resistance.pseudo_plastic.q") == 0.4
    assert cfg.get_number(
        "basal_yield_stress.mohr_coulomb.till_phi_default") == 25.0


def test_cli_output_without_h5py_fails_clearly(monkeypatch, capsys, tmp_path):
    """h5py is an output-only dependency: asking for NetCDF-4 output
    without it stops before any model work, with a message that names the
    package and the netcdf3 alternative."""
    from pism_tpu.io import nc4
    monkeypatch.setattr(nc4, "h5py", None)
    rc = main(["-eisII", "A", "-Mx", "5", "-My", "5", "-y", "1",
               "-o", str(tmp_path / "out.nc")])
    assert rc == 2
    err = capsys.readouterr().err
    assert "h5py" in err and "netcdf3" in err
    assert not (tmp_path / "out.nc").exists()
    with pytest.raises(ImportError, match="h5py"):
        nc4.File(str(tmp_path / "x.nc"), "w")


def test_cli_netcdf3_output_without_h5py(monkeypatch, tmp_path):
    """The alternative the message names works without h5py: classic
    NetCDF output is written through scipy and reads back."""
    from pism_tpu.io import nc4
    monkeypatch.setattr(nc4, "h5py", None)
    out = tmp_path / "out.nc"
    rc = main(["-eisII", "A", "-Mx", "5", "-My", "5", "-Mz", "5", "-y", "1",
               "-o_format", "netcdf3", "-o", str(out)])
    assert rc == 0
    with open(out, "rb") as fh:
        assert fh.read(3) == b"CDF"
    with nc4.File(str(out)) as f:
        assert f.has_variable("thk")


@pytest.mark.parametrize("flag,expected", [("cpu", "cpu"), ("gpu", "cuda")])
def test_cli_platform_names(flag, expected):
    """-platform gpu must reach JAX as a backend it can start: JAX's own
    "gpu" alias also asks for ROCm and fails where only CUDA is installed."""
    from pism_tpu.cli import jax_platforms
    assert build_parser().parse_args(["-platform", flag]).platform == flag
    assert jax_platforms(flag) == expected
