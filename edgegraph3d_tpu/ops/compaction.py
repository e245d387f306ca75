"""Device-side stream compaction for sparse results.

The reconstruction sweeps produce big, mostly-empty result tensors
(valid fractions of a few percent).  Instead of shipping padded
[S, T, ...] buffers to the host and compacting with numpy, valid rows
are packed on device into one small f32 buffer (prefix-sum scatter)
and a single slice is transferred, with the count riding in the same
transfer.  Every blocking fetch is a host sync that drains the
dispatch queue, so fewer, smaller fetches keep the device fed; whether
the fused count+prefix form still pays on a local PCIe card is
unmeasured (ROADMAP design item 3).

No reference counterpart — the reference is single-process shared
memory (SURVEY.md §5 "Distributed communication backend": none); this
is device-host plumbing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

#: process-wide count of BLOCKING device->host fetches (each a host
#: sync; pipeline.py reports the per-run delta as device_fetches)
TRANSFER_COUNT = [0]


def count_fetch(n: int = 1) -> None:
    TRANSFER_COUNT[0] += n


def fetch(x):
    """Counted blocking fetch of a device array (np.asarray + count)."""
    import numpy as np
    count_fetch()
    return np.asarray(x)


@partial(jax.jit, static_argnames=("cap",))
def compact_rows(valid: jnp.ndarray, payload: jnp.ndarray, cap: int):
    """Scatter payload rows where `valid` into a [cap, D] buffer.

    valid [R], payload [R, D] -> (buf [cap, D], n_valid).  Rows keep
    their relative order (prefix-sum positions).  On overflow
    (n_valid > cap) the excess rows are dropped from the buffer but
    n_valid still reports the true count so callers can detect it.
    """
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    idx = jnp.where(valid & (pos < cap), pos, cap)
    buf = jnp.zeros((cap + 1, payload.shape[-1]), payload.dtype)
    buf = buf.at[idx].set(payload, mode="drop")
    return buf[:cap], jnp.sum(valid.astype(jnp.int32))


def fetch_global(x):
    """Device array -> host numpy, across process boundaries.

    Multi-process meshes produce arrays whose shards live on other
    processes; every process reconstructs the FULL value (host-side
    claiming/assembly logic is replicated-deterministic across
    processes — tests/test_multihost.py asserts the agreement)."""
    import numpy as np
    count_fetch()
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def host_count(n) -> int:
    """Fetch a device scalar count via a 1-element array.

    Counts go through `fetch_global` as [1] arrays rather than
    `int()` on a 0-d device array, so that every count is a counted
    fetch and works on cross-process shards."""
    import numpy as np
    if isinstance(n, (int, np.integer)):
        return int(n)
    return int(fetch_global(jnp.reshape(n, (1,)))[0])


@partial(jax.jit, static_argnames=("g",))
def _head_with_count(buf, n, g: int):
    """[1 + g, D] device array: row 0 carries the count, rows 1..g the
    buffer prefix — ONE transfer covers both when n <= g."""
    row0 = jnp.broadcast_to(
        jnp.reshape(n, (1, 1)).astype(buf.dtype), (1, buf.shape[1]))
    return jnp.concatenate([row0, buf[:g]], axis=0)


@partial(jax.jit, static_argnames=("g", "rows_e"))
def _head_with_count_extra(buf, n, extra, g: int, rows_e: int):
    """[1 + rows_e + g, D]: count row, then `extra` flattened and
    padded into D-wide rows, then the buffer prefix — one transfer."""
    D = buf.shape[1]
    row0 = jnp.broadcast_to(
        jnp.reshape(n, (1, 1)).astype(buf.dtype), (1, D))
    flat = jnp.ravel(extra).astype(buf.dtype)
    flat = jnp.concatenate(
        [flat, jnp.zeros((rows_e * D - flat.shape[0],), buf.dtype)])
    return jnp.concatenate([row0, flat.reshape(rows_e, D), buf[:g]],
                           axis=0)


def to_host_with_extra(buf, n, extra):
    """Like `to_host`, but also returns `extra` (any fixed-shape float
    tensor) fetched in the SAME device->host transfer — one host sync
    instead of two."""
    import numpy as np
    if not getattr(buf, "is_fully_addressable", True):
        rows, n = to_host(buf, n)
        return rows, n, fetch_global(extra)
    cap, D = buf.shape
    e_shape = tuple(extra.shape)
    e_count = int(np.prod(e_shape)) if e_shape else 1
    rows_e = -(-e_count // D)
    g = max(cap // 4, 1)
    count_fetch()
    head = np.asarray(_head_with_count_extra(buf, n, extra, g, rows_e))
    n = int(head[0, 0])
    extra_np = head[1: 1 + rows_e].reshape(-1)[:e_count].reshape(e_shape)
    if n <= g:
        return head[1 + rows_e: 1 + rows_e + n], n, extra_np
    count_fetch()
    b = min(1 << (max(n, 1) - 1).bit_length(), cap)
    return np.asarray(buf[:b])[: min(n, cap)], n, extra_np


def to_host(buf, n) -> "tuple":
    """Transfer the packed prefix with as few round trips as possible.

    One fused fetch carries the count AND the first quarter of the
    buffer (counts are exact in f32 below 2^24; caps are sized ~4x the
    typical fill, so one round trip is the common case).  Only an
    over-full buffer pays a second, bucketed fetch.  This is a
    transfer-count optimization (each fetch is a host sync), not a
    bandwidth one."""
    import numpy as np
    cap = buf.shape[0]
    if not getattr(buf, "is_fully_addressable", True):
        # cross-process shards: gather whole (slicing a global array at
        # a non-shard-aligned bound would reshard anyway)
        n = host_count(n)
        return fetch_global(buf)[: min(n, cap)], n
    g = max(cap // 4, 1)
    count_fetch()
    head = np.asarray(_head_with_count(buf, n, g))
    n = int(head[0, 0])
    if n == 0:
        return np.zeros((0, buf.shape[-1]), buf.dtype), 0
    if n <= g:
        return head[1: 1 + n], n
    count_fetch()
    b = min(1 << (max(n, 1) - 1).bit_length(), cap)
    return np.asarray(buf[:b])[: min(n, cap)], n
