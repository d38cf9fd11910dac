"""Where the persistent XLA compilation cache lives.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``
and the example scripts):

1. ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it; nothing is set
   in code.
2. otherwise the ``runtime.jit.cache_dir`` config value, when given;
3. otherwise the fixed ``<checkout>/.jax_cache`` (listed in .gitignore).

The path is part of what makes the cache hit, so it is never built from a
temporary name, a process id or the time.
"""

from __future__ import annotations

import os
from typing import Optional

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir_to_set(config_dir: str = "") -> Optional[str]:
    """The directory the program must configure, or None when the
    environment variable already points JAX at one."""
    if os.environ.get(ENV):
        return None
    return config_dir or DEFAULT_DIR


def enable_compile_cache(config_dir: str = "") -> str:
    """Apply the rule above; returns the cache directory in use."""
    target = cache_dir_to_set(config_dir)
    if target is None:
        return os.environ[ENV]
    import jax
    jax.config.update("jax_compilation_cache_dir", target)
    # cache every executable that took at least 2 s to compile (the hybrid
    # chain's step functions); trivial ones are cheaper to rebuild
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return target
