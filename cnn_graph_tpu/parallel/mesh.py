"""Device mesh construction for multi-chip / multi-host execution.

The reference is strictly single-device (SURVEY.md §2.3: one tf.Session,
no NCCL/MPI anywhere).  This framework scales through ``jax.sharding``:
a logical mesh with axes

* ``data``  — batch data parallelism (gradients psum over this axis),
* ``nodes`` — graph-node model parallelism (Laplacian rows + activations
  edge-partitioned over this axis; see parallel/node_sharded.py).

The mesh follows the algorithm, not the wiring: the GPUs of one host are
joined all to all by NVLink at one rate, so any device order serves.
XLA hands the collectives to NCCL.  Across hosts, call
``jax.distributed.initialize()`` first; the mesh then spans all hosts'
devices, and ``nodes`` (which exchanges halos every hop) should stay
within a host while ``data`` (one gradient reduction per step) spans
hosts.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "P"]


def make_mesh(
    data: int | None = None,
    nodes: int = 1,
    devices=None,
) -> Mesh:
    """Build a ``(data, nodes)`` mesh.  Defaults: all devices on ``data``."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // nodes
    assert data * nodes == len(devices), (
        f"mesh {data}x{nodes} != {len(devices)} devices"
    )
    return Mesh(devices.reshape(data, nodes), axis_names=("data", "nodes"))


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) axis over ``data``, replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
