"""Device mesh construction and sharding helpers.

The reference's only parallelism is shared-memory OpenMP loops over
refpoints/PLG ids with one global lock (reference:
include/edgegraph3d/utils/globals/global_switches.hpp:37 SWITCH_RUNPARALLEL,
plg_matching_from_refpoints.cpp:89-95, plg_matches_manager.cpp:42).
The JAX-native replacement is a 1-D `jax.sharding.Mesh` over a "shard"
axis: work items (refpoints, seeds, 3D points) are sharded across
devices, per-view PLG/grid tensors are replicated, and reductions are
collectives (`psum` in parallel/sharded.py; NCCL over NVLink between
the GPUs of one host).  Multi-host scale-out uses the same mesh
spanning `jax.distributed` processes.  The mesh is 1-D because the
algorithm's work axis is: it follows no interconnect topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None,
              devices: list | None = None) -> Mesh:
    """1-D mesh over the work-item axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SHARD_AXIS,))


def shard_spec() -> P:
    return P(SHARD_AXIS)


def replicated_spec() -> P:
    return P()


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad `axis` so its size divides evenly across devices."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)


def put_sharded(mesh: Mesh, arr, spec: P | None = None):
    """Device-put with a named sharding on `mesh`."""
    spec = spec if spec is not None else shard_spec()
    return jax.device_put(arr, NamedSharding(mesh, spec))
