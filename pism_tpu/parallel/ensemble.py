"""Ensemble runs: vmapped members, optionally sharded over a mesh axis.

The reference runs parameter ensembles as independent MPI jobs driven by
shell scripts (SURVEY.md §2.5 "data parallel"); here an ensemble is ONE SPMD
program: the member axis is vmapped over the jitted segment runner and can
be sharded over a leading "e" mesh axis, while each member's (y, x) fields
shard over the remaining mesh axes. This is the BASELINE "100-member paleo
ensemble" configuration.

Per-member parameters enter through a ``params -> surface forcing`` hook:
the surface model receives the member's parameter vector, so e.g. a
temperature-offset sweep is one extra vmapped scalar.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .. import state as S


def stack_states(states):
    """Stack a list of ModelStates into one batched state (leading member
    axis on every array leaf)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def broadcast_state(state, n_members: int):
    """Replicate one state into an n-member batch."""
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_members,) + x.shape)
        if hasattr(x, "ndim") else x, state)


@dataclass
class EnsembleRunner:
    """Run an ensemble of a model configuration.

    model: an IceModel whose surface callable accepts an extra trailing
    ``params`` argument when ``parameterized=True`` — i.e. the model was
    built with ``surface=lambda geom, t: fn(geom, t, params_ref[...])``
    closing over nothing; instead use :func:`make_parameterized_model`.
    """

    model: object

    def run_segment(self, batched_state, t0: float, t_end: float):
        """Advance every member from t0 to t_end (same wall segment).

        Members run their own adaptive dt sequences inside their own
        while_loops; vmap executes them in lockstep on the batched data.
        """
        def one(st):
            out, t, stats = self.model._advance_device(st, t0, t_end)
            return out, stats

        fn = jax.jit(jax.vmap(one))
        return fn(batched_state)

    def shard(self, batched_state, mesh):
        """Place the batch on an ("e"[, "y", "x"]) mesh.

        The combined layout — members over "e" AND each member's domain
        over ("y", "x") simultaneously — is the BASELINE config-5 layout:
        ``make_mesh(devices, shape=(ny, nx), ensemble=ne)`` with
        ne*ny*nx = device count. Validated by
        ``__graft_entry__.dryrun_multichip`` (2 members x 2x2 spatial on
        the 8-device CPU mesh, full hybrid chain)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        def spec(x):
            if not hasattr(x, "ndim"):
                return None
            names = ["e"] + [None] * (x.ndim - 1)
            if "y" in mesh.axis_names and x.ndim >= 3:
                names[1] = "y"
            if "x" in mesh.axis_names and x.ndim >= 3:
                names[2] = "x"
            return NamedSharding(mesh, P(*names))

        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, spec(x)) if hasattr(x, "ndim") else x,
            batched_state)
