"""Multi-process scaffolding: jax.distributed init + process-local batches.

The reference's "fleet" is one ROS graph of OS processes on one machine
(SURVEY.md §2 parallelism table); here every process runs the same program
and ``jax.distributed`` stitches them together. The ``stream`` axis is pure
data parallelism over independent recordings and needs no collective in the
hot path, so the mesh lays it out process-major: each process ingests and
keeps its own streams. A ``bin`` axis, when asked for, stays inside one
process.

Single-process safe: every entry point degrades to the local mesh, so the
same program runs on one host (and in this repo's tests) without a
coordinator.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize ``jax.distributed`` when a multi-process launch is
    configured (explicit args or the standard JAX_* / cluster env vars).

    Returns True if distributed init ran, False for the single-process
    no-op. Safe to call unconditionally at program start — the moral
    equivalent of ``ros::init`` in every reference node (das.cpp:105).
    """
    configured = (coordinator_address
                  or os.environ.get("JAX_COORDINATOR_ADDRESS")
                  or (num_processes or 0) > 1)
    if not configured:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def multihost_mesh(bin_size: int = 1) -> Mesh:
    """A (stream, bin) mesh over every device of every process, with the
    stream axis process-major so each process's streams stay on its own
    devices. ``bin_size``: devices per bin group (1 = streams only); a bin
    group never spans processes."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_local = jax.local_device_count()
    if n_local % bin_size:
        raise ValueError(f"bin_size {bin_size} does not divide the "
                         f"{n_local} devices of a process")
    arr = np.asarray(devs).reshape(len(devs) // bin_size, bin_size)
    return Mesh(arr, axis_names=("stream", "bin"))


def process_local_batch(mesh: Mesh, local_batch: np.ndarray):
    """Assemble the global batch array from each process's local streams.

    Every process contributes ``local_batch`` (B_local, M, S); the result
    is a global (B_local * num_processes, M, S) array sharded P('stream')
    whose shards never leave the process that produced them.
    """
    spec = P(*(["stream"] + [None] * (local_batch.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_batch)


def process_span(mesh: Mesh) -> dict:
    """How many processes each mesh axis spans at most. The layout's
    invariant: only 'stream' may ever list more than one process."""
    out = {}
    for ax, size in zip(mesh.axis_names, mesh.devices.shape):
        moved = np.moveaxis(mesh.devices, mesh.axis_names.index(ax), 0)
        spans = {len({d.process_index for d in row})
                 for row in moved.reshape(size, -1).T}
        out[ax] = max(spans) if spans else 1
    return out
