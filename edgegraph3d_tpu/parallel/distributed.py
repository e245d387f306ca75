"""Multi-host launch: `jax.distributed` across processes.

The reference is single-process shared memory (SURVEY.md §5
"Distributed communication backend: none"); this is the JAX-native
scale-out layer (SURVEY §2.10 item 4): each host runs one process,
`jax.distributed.initialize` wires the cluster, and the global mesh
spans every host's local devices.  Work items (refpoints / seeds /
chains / 3D points) are sharded over the global mesh exactly as in
parallel/sharded.py — within a host the collectives ride NVLink (NCCL),
across hosts the network; the only cross-device traffic in the whole
engine is the `psum` of Schur blocks in the distributed BA.

Tested without a cluster by N local processes on the CPU backend
(tests/test_multihost.py), each exposing
`--xla_force_host_platform_device_count` virtual devices.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None):
    """Join the jax.distributed cluster (idempotent per process).

    Pass the arguments explicitly (`coordinator_address` as
    "host:port"): nothing in a plain GPU or CPU cluster lets JAX infer
    them.  `local_device_count` forces the CPU backend to expose
    that many virtual devices (test rigs)."""
    import os

    import jax

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        want = f"--xla_force_host_platform_device_count={local_device_count}"
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + want).strip()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax


def global_mesh(axis: str | None = None):
    """1-D mesh over ALL devices of the cluster (every process sees the
    same global device list after initialize)."""
    import jax

    from edgegraph3d_tpu.parallel.mesh import SHARD_AXIS
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis or SHARD_AXIS,))


def shard_global(mesh, host_array: np.ndarray):
    """Build a globally-sharded jax.Array from identical host data on
    every process (axis 0 sharded over the mesh).

    Every process passes the SAME full array (our work lists are
    host-replicated numpy state); each process donates only the shards
    it owns."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def replicate_global(mesh, host_array: np.ndarray):
    """Fully-replicated global array."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    sharding = NamedSharding(mesh, PartitionSpec())
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx])


def gather_to_host(arr) -> np.ndarray:
    """Fetch a (possibly cross-process) sharded array to every host."""
    import jax
    from jax.experimental import multihost_utils

    return np.asarray(jax.device_get(
        multihost_utils.process_allgather(arr)
        if arr.is_fully_addressable is False else arr))
