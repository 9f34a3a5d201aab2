"""Multi-chip execution: sharding the solver over a device mesh.

The reference is a single-process MATLAB program (SURVEY §2.7); the
distribution axes are new capability:

  - ``model``: the matrix dimension n — Y (p, n) and the cost matrix
    are column-sharded; Y@C / U@C become local matmuls over column
    shards after XLA all-gathers the (small) factor, and every inner
    product / column reduction turns into a psum over the mesh axis.
    This is the "large n" axis (SURVEY §5.7's long-context analogue).
  - ``batch``: independent SDP instances (scenario batching,
    BASELINE.json configs item 5) — a vmapped solver with per-instance
    cost matrices, sharded one instance group per device.

Everything is expressed with jax.sharding.NamedSharding on jit inputs;
XLA inserts the collectives.  No NCCL/MPI translation — the mesh is the
communication backend.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import Problem, TROptions, make_trustregions
from ..manifolds import Oblique


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "model") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def make_mesh_2d(batch: int, model: int) -> Mesh:
    devs = np.asarray(jax.devices()[:batch * model]).reshape(batch, model)
    return Mesh(devs, ("batch", "model"))


def _maxcut_problem():
    """The production maxcut subproblem (solvers/maxcut.py) — one
    definition, shared with the single-chip driver so the sharded solve
    cannot drift from it."""
    from ..solvers.maxcut import make_maxcut_problem
    return make_maxcut_problem(dense=True)


def sharded_maxcut_solve(mesh: Mesh, tr_opts: Optional[TROptions] = None):
    """RTR inner solve with Y and C column-sharded over mesh axis
    'model'.  Returns (jitted_solve, shard_fn) where shard_fn places
    (Y, C) with the right NamedShardings."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    problem = _maxcut_problem()
    base = make_trustregions(problem, tr_opts)

    y_sh = NamedSharding(mesh, P(None, "model"))
    c_sh = NamedSharding(mesh, P(None, "model"))

    solve = jax.jit(base, in_shardings=(y_sh, c_sh, None),
                    out_shardings=None)

    def shard_fn(Y, C):
        return (jax.device_put(Y, y_sh), jax.device_put(C, c_sh))

    return solve, shard_fn


def batched_maxcut_solve(mesh: Mesh, tr_opts: Optional[TROptions] = None):
    """vmapped RTR solve over an instance batch, sharded over 'batch'
    (data parallelism over independent SDP instances)."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    problem = _maxcut_problem()
    base = make_trustregions(problem, tr_opts)
    vsolve = jax.vmap(base, in_axes=(0, 0, None))

    y_sh = NamedSharding(mesh, P("batch", None, None))
    c_sh = NamedSharding(mesh, P("batch", None, None))
    solve = jax.jit(vsolve, in_shardings=(y_sh, c_sh, None))

    def shard_fn(Ys, Cs):
        return (jax.device_put(Ys, y_sh), jax.device_put(Cs, c_sh))

    return solve, shard_fn


def batched_sharded_maxcut_solve(mesh: Mesh,
                                 tr_opts: Optional[TROptions] = None):
    """2-D (batch x model) parallelism: an instance batch sharded over
    'batch' with each instance's factor/cost column-sharded over
    'model' — DP and TP composed on one mesh (make_mesh_2d).  GSPMD
    partitions the vmapped RTR program; collectives reduce over the
    'model' axis only."""
    tr_opts = tr_opts or TROptions(maxiter=4, maxinner=10,
                                   tolgradnorm=1e-8)
    problem = _maxcut_problem()
    base = make_trustregions(problem, tr_opts)
    vsolve = jax.vmap(base, in_axes=(0, 0, None))

    y_sh = NamedSharding(mesh, P("batch", None, "model"))
    c_sh = NamedSharding(mesh, P("batch", None, "model"))
    solve = jax.jit(vsolve, in_shardings=(y_sh, c_sh, None))

    def shard_fn(Ys, Cs):
        return (jax.device_put(Ys, y_sh), jax.device_put(Cs, c_sh))

    return solve, shard_fn
