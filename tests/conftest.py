"""Test configuration.

Tests run on CPU with 8 virtual devices (the analog of PISM's
``mpiexec -n 1..4`` regression runs; see SURVEY.md §4): sharding/halo tests
assert the same answer on 1 device and on a 2x4 mesh. Environment must be
set before jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Hold the tests to the CPU even where a GPU is visible: the config API wins
# over any site default (must run before the first jax operation
# initializes a backend).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(seed=1234)


def pytest_collection_modifyitems(config, items):
    """Attach the ``smoke`` marker to the curated sub-minute tier listed
    in tests/smoke_tests.txt (one nodeid per line; regenerate with
    ``python tests/make_smoke_set.py`` from a --durations=0 run)."""
    import pathlib

    p = pathlib.Path(__file__).with_name("smoke_tests.txt")
    if not p.exists():
        return
    smoke = {ln.strip() for ln in p.read_text().splitlines()
             if ln.strip() and not ln.startswith("#")}
    for it in items:
        if it.nodeid in smoke:
            it.add_marker(pytest.mark.smoke)
