"""Runtime plumbing that differs between machines: the compile-cache
location, the matmul-precision setting, the chip smoke test's guards, and
configs stored by older versions."""

import json
import os
import sys

import jax
import numpy as np
import pytest

from pism_tpu import Config
from pism_tpu.util import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,config_dir,expected", [
    ("/elsewhere/cache", "", None),             # env set: JAX reads it
    ("/elsewhere/cache", "/cfg/cache", None),   # env wins over the config
    ("", "/cfg/cache", "/cfg/cache"),           # runtime.jit.cache_dir
    ("", "", os.path.join(REPO, ".jax_cache")),  # fixed checkout default
])
def test_compile_cache_location(monkeypatch, env, config_dir, expected):
    if env:
        monkeypatch.setenv(cc.ENV, env)
    else:
        monkeypatch.delenv(cc.ENV, raising=False)
    assert cc.cache_dir_to_set(config_dir) == expected


def test_compile_cache_env_sets_nothing(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, no jax config is touched."""
    monkeypatch.setenv(cc.ENV, "/elsewhere/cache")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    assert cc.enable_compile_cache("/cfg/cache") == "/elsewhere/cache"
    assert calls == []


@pytest.mark.parametrize("setting,expected", [
    ("highest", "HIGHEST"), ("high", "HIGH"), ("default", "DEFAULT")])
def test_matmul_precision_applied_by_model(setting, expected):
    """runtime.matmul_precision reaches the model's f32 matrix product
    (Blatter's column average) in the compiled program, for library and
    CLI runs alike, and building a model leaves JAX's process-global
    precision untouched."""
    import jax.numpy as jnp
    from pism_tpu import Grid
    from pism_tpu.coupler.surface import Uniform
    from pism_tpu.model.blatter import BlatterSolver
    from pism_tpu.model.icemodel import IceModel
    from pism_tpu.physics.rheology import IsothermalGlen

    cfg = Config({"stress_balance.model": "sia", "energy.model": "none",
                  "runtime.matmul_precision": setting})
    grid = Grid(Mx=5, My=5, Lx=10e3, Ly=10e3, Mz=4, Lz=1000.0)
    before = jax.config.jax_default_matmul_precision
    IceModel(grid=grid, config=cfg, surface=Uniform(smb=0.0))
    assert jax.config.jax_default_matmul_precision == before

    solver = BlatterSolver(grid, cfg, IsothermalGlen())
    f3 = jnp.ones((5, 5, len(solver.zeta)), jnp.float32)
    text = jax.jit(solver.vertical_average).lower(f3).as_text()
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots and all(f"precision = [{expected}, {expected}]" in line
                        for line in dots)


# keys removed with the accelerator-specific kernels and dispatch tables
REMOVED_KEYS = {
    "stress_balance.sia.pallas": "on",
    "stress_balance.ssa.fd.pallas_matvec": "on",
    "stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane",
    "runtime.pallas.interpret": True,
    "runtime.tridiag.thomas_max_n": 32,
    "runtime.tridiag.thomas_min_batch": 4096,
}


@pytest.mark.parametrize("key", sorted(REMOVED_KEYS))
def test_stored_config_with_removed_key_loads(key):
    stored = Config({"energy.model": "none"}).to_dict()
    stored[key] = REMOVED_KEYS[key]
    cfg = Config.from_json(json.dumps(stored))
    assert cfg.get_string("energy.model") == "none"
    assert key not in cfg.to_dict()


def test_restart_file_with_removed_keys_loads(tmp_path):
    """A state file written by an older version, whose stored config names
    the removed keys, restarts."""
    import jax.numpy as jnp
    from pism_tpu import Grid
    from pism_tpu.io import checkpoint as ckpt
    from pism_tpu.io.nc4 import File
    from pism_tpu.state import ModelState, new_geometry

    grid = Grid(Mx=6, My=5, Lx=10e3, Ly=8e3, Mz=3, Lz=1000.0)
    state = ModelState(geometry=new_geometry(jnp.full(grid.shape2, 100.0),
                                             jnp.zeros(grid.shape2)))
    path = str(tmp_path / "old.nc")
    cfg = Config({"energy.model": "none"})
    ckpt.save_state(path, state, grid, 0.0, config=cfg)
    stored = cfg.to_dict()
    stored.update(REMOVED_KEYS)
    with File(path, "a") as f:
        f.h5.attrs["pism_config"] = json.dumps(stored)
    loaded = ckpt.load_config(path)
    assert loaded.get_string("energy.model") == "none"
    st, t = ckpt.load_state(path, loaded)
    np.testing.assert_array_equal(np.asarray(st.geometry.ice_thickness),
                                  100.0)


# ---- chip_smoke.py guards (the script itself needs a GPU) ---------------

def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_refuses_cpu_backend():
    cs = _chip_smoke()
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.check_device(jax.devices())


def test_chip_smoke_compare_fields():
    cs = _chip_smoke()
    ref = np.array([[0.0, 100.0], [200.0, 400.0]])
    got = ref.copy()
    got[1, 1] += 0.004
    max_rel, vol_rel = cs.compare_fields(ref, got)
    assert max_rel == pytest.approx(1e-5)
    assert vol_rel == pytest.approx(0.004 / 700.0)
    cs.check_bounds(("vol", vol_rel, cs.REL_BOUND))
    with pytest.raises(cs.SmokeFailure, match="max = 2.000e-05 exceeds"):
        cs.check_bounds(("vol", vol_rel, cs.REL_BOUND),
                        ("max", 2 * max_rel, cs.REL_BOUND))
    with pytest.raises(cs.SmokeFailure, match="non-finite"):
        cs.compare_fields(ref, np.full_like(ref, np.nan))
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.compare_fields(ref, ref[:1])


def test_chip_smoke_card_label():
    cs = _chip_smoke()
    one = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert cs.short_label(one) == one
    assert cs.short_label("\n".join([one] * 4)) == one + " x4"
    mixed = one + "\n" + one.replace("700.00", "400.00")
    assert cs.short_label(mixed) == one + "; " + one.replace("700.00", "400.00")
