"""Multi-host execution: jax.distributed init + host-aware meshes.

The reference is a single-process MATLAB program (SURVEY §2.7); this
module is the multi-host entry point:

  - ``init_distributed()`` wraps jax.distributed.initialize (idempotent,
    env-driven: JAX coordinator variables or explicit args);
  - ``make_host_mesh()`` builds a 2-D (host, model) mesh whose OUTER
    axis follows process (host) boundaries, so 'model'-axis collectives
    (the psums of the sharded constraint operator,
    parallel/sharded_ops.py) stay among the devices of one host while
    only 'host'-axis reductions cross the network.  The sharded AL
    driver (solvers/primal_al.py, mesh=...) shards over 'model' and
    replicates over 'host';
  - ``make_batch_host_mesh()`` maps independent SDP instances one group
    per host ('batch' across hosts — embarrassingly parallel) with
    'model' inside.

The mesh-shape logic is unit-tested on the virtual CPU mesh; the
sharded-operator semantics it feeds are equivalence-tested in
tests/test_sharded_ops.py.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from jax.sharding import Mesh


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when running multi-process.

    Returns True if a multi-process runtime was initialized (or already
    was), False for single-process runs (no-op).  Arguments default to
    the standard JAX environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if coordinator_address is None or num_processes <= 1:
        return False
    if jax.process_count() > 1:          # already initialized
        return True
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return True


def _device_grid(devices: Sequence, procs: int):
    """Devices reshaped (procs, per_proc), host-major: row p holds the
    devices of process p, so axis-1 collectives stay intra-host."""
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    per_proc = len(devices) // procs
    return np.asarray(devices[:procs * per_proc]).reshape(procs, per_proc)


def make_host_mesh(devices: Optional[Sequence] = None,
                   procs: Optional[int] = None,
                   axis_names=("host", "model")) -> Mesh:
    """2-D mesh with the process (host) axis OUTERMOST.

    'model'-axis collectives (the psums of the sharded AL operator)
    then reduce over same-host devices; only 'host'-axis operations
    cross hosts.  On a single process this degenerates to
    (1, n_devices) — same program.
    """
    import jax

    devices = list(devices if devices is not None else jax.devices())
    if procs is None:
        procs = max(len({d.process_index for d in devices}), 1)
    return Mesh(_device_grid(devices, procs), axis_names)


def make_batch_host_mesh(devices: Optional[Sequence] = None,
                         procs: Optional[int] = None) -> Mesh:
    """(batch, model) mesh with one instance group per host: the
    instance axis (data parallelism over independent SDPs,
    solvers/batch.py) never communicates, so it is the right axis to
    place across hosts."""
    return make_host_mesh(devices, procs, axis_names=("batch", "model"))
