"""Device-side interval claiming: the collective dedup layer.

JAX-native upgrade of the host-side `MatchesManager.resolve_and_claim`
(matches.py — itself the parallel-deterministic equivalent of the
reference's sequential interval skip + lock-guarded interval marking,
reference: src/edgegraph3d/matching/plg_matching/polyline_matching.cpp:173-190
and plg_matches_manager.cpp:54-180).  SURVEY §2.10 item 2 names the
design: "dedup becomes a device-local interval bitmap + cross-device
merge via collectives".

Semantics (identical to the host path, asserted bit-exact by
tests/test_claiming.py::test_device_claiming_matches_host):

    seeds processed in GLOBAL INDEX ORDER; a successful seed is
    accepted iff its starting sample's bucket on the starting view is
    not covered by (a) a claim from earlier chunks or (b) the claimed
    arcs of an earlier ACCEPTED seed; accepted seeds claim their swept
    arcs on all 3 tuple views in both directions.

Device formulation: an OWNER raster [V, P, B] int32 holds the smallest
seed index whose accepted span covers each bucket (-1 = claimed by an
earlier chunk, INF = free).  A fixpoint loop alternates

    accept  = success & ~(owner[start] < my_index)
    owner   = scatter-min of accepted spans

starting from the optimistic all-accepted state; each round re-derives
the owner raster from scratch, so a seed unblocked by a higher-priority
rejection is re-accepted.  The loop converges to the unique sequential
solution in at most chain-depth rounds (a lexicographic greedy
independent set).  In the sharded variant the seed axis is split over
the mesh and the owner raster is min-reduced with `lax.pmin` every
round — the cross-device interval merge (NCCL over NVLink on
GPUs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.int32(2 ** 30)


def _span_masks(b_seed, b_fwd, b_bwd, B: int):
    """Per (seed, view) claimed bucket span mask [S, 3, B]: from the
    seed bucket out to each direction's final bucket (both inclusive),
    mirroring MatchesManager.mark_spans for the fwd and bwd arcs."""
    lo = jnp.minimum(jnp.minimum(b_seed, b_fwd), b_bwd)
    hi = jnp.maximum(jnp.maximum(b_seed, b_fwd), b_bwd)
    rng = jnp.arange(B)
    return (rng[None, None, :] >= lo[..., None]) & \
        (rng[None, None, :] <= hi[..., None])


@partial(jax.jit, static_argnames=("skip_start_check", "max_rounds"))
def resolve_and_claim_device(owner0, success, index, cams, pl,
                             b_start, span_mask,
                             skip_start_check: bool = False,
                             max_rounds: int = 64):
    """owner0 [V,P,B] int32 (INF free / -1 earlier chunks), success [S],
    index [S] global seed order, cams/pl [S,3], b_start [S],
    span_mask [S,3,B].  Returns (accept [S], owner [V,P,B])."""
    V, P, B = owner0.shape
    S = success.shape[0]
    idx_col = jnp.where(success, index, INF)

    def claim(accept):
        o = owner0
        w = jnp.where((accept[:, None, None]) & span_mask,
                      idx_col[:, None, None], INF)      # [S,3,B]
        return o.at[cams, pl].min(w, mode="drop")

    def blocked(owner, accept):
        if skip_start_check:
            return jnp.zeros_like(accept)
        own = owner[cams[:, 0], pl[:, 0], b_start]
        return own < index

    def body(carry):
        accept, _, i = carry
        owner = claim(accept)
        new_accept = success & ~blocked(owner, accept)
        changed = jnp.any(new_accept != accept)
        return new_accept, changed, i + 1

    def cond(carry):
        _, changed, i = carry
        return changed & (i < max_rounds)

    accept0 = success
    accept, changed, _ = jax.lax.while_loop(
        cond, body, (accept0, jnp.bool_(True), jnp.int32(0)))
    # converged iff the loop exited because nothing changed (a True
    # `changed` at exit means max_rounds truncated the fixpoint)
    return accept, claim(accept), ~changed


def sharded_resolve_and_claim(mesh, owner0, success, index, cams, pl,
                              b_start, span_mask,
                              skip_start_check: bool = False,
                              max_rounds: int = 64):
    """Seed axis sharded over the mesh; the owner raster is min-reduced
    across devices every fixpoint round (`lax.pmin` between devices) — the
    cross-device interval merge of SURVEY §2.10 item 2.  Inputs padded
    to a device multiple with success=False rows."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P_

    from edgegraph3d_tpu.parallel.mesh import SHARD_AXIS

    sh = P_(SHARD_AXIS)
    rep = P_()

    def local(owner0, success, index, cams, pl, b_start, span_mask):
        idx_col = jnp.where(success, index, INF)

        def claim(accept):
            w = jnp.where((accept[:, None, None]) & span_mask,
                          idx_col[:, None, None], INF)
            o = owner0.at[cams, pl].min(w, mode="drop")
            # cross-device merge: global owner = min over devices
            return jax.lax.pmin(o, SHARD_AXIS)

        def body(carry):
            accept, _, i = carry
            owner = claim(accept)
            if skip_start_check:
                blk = jnp.zeros_like(accept)
            else:
                blk = owner[cams[:, 0], pl[:, 0], b_start] < index
            new_accept = success & ~blk
            # convergence is a GLOBAL property
            changed = jax.lax.pmax(
                jnp.any(new_accept != accept).astype(jnp.int32),
                SHARD_AXIS) > 0
            return new_accept, changed, i + 1

        def cond(carry):
            _, changed, i = carry
            return changed & (i < max_rounds)

        accept, changed, _ = jax.lax.while_loop(
            cond, body, (success, jnp.bool_(True), jnp.int32(0)))
        return accept, claim(accept), ~changed

    # build + jit ONCE per (mesh, statics) — a bare shard_map re-traces
    # on every chunk call (see parallel/sharded.py module docstring)
    from edgegraph3d_tpu.parallel.sharded import _cached

    def build():
        return shard_map(local, mesh=mesh,
                         in_specs=(rep, sh, sh, sh, sh, sh, sh),
                         out_specs=(sh, rep, rep), check_vma=False)

    fn = _cached(mesh, ("claim", bool(skip_start_check), max_rounds),
                 build)
    return fn(owner0, success, index, cams, pl, b_start, span_mask)


def owner_from_bool(raster: np.ndarray) -> np.ndarray:
    """Bool claim raster (earlier chunks) -> int32 owner raster."""
    return np.where(raster, np.int32(-1), np.int32(2 ** 30))


def apply_device_claiming(manager, success, cams, pl, seg, t,
                          fwd_seg, fwd_t, bwd_seg, bwd_t,
                          skip_start_check: bool = False,
                          mesh=None) -> np.ndarray:
    """Drop-in device-backed equivalent of
    `MatchesManager.resolve_and_claim` (same argument contract): builds
    the owner raster from the manager's bool raster, resolves the chunk
    on device, and writes the accepted claims back."""
    S = len(success)
    if S == 0:
        return np.zeros(0, bool)
    B = manager.B
    b_seed = np.stack([manager.bucket(cams[:, k], pl[:, k], seg[:, k],
                                      t[:, k]) for k in range(3)], axis=1)
    b_fwd = np.stack([manager.bucket(cams[:, k], pl[:, k],
                                     fwd_seg[:, k], fwd_t[:, k])
                      for k in range(3)], axis=1)
    b_bwd = np.stack([manager.bucket(cams[:, k], pl[:, k],
                                     bwd_seg[:, k], bwd_t[:, k])
                      for k in range(3)], axis=1)
    span = np.asarray(_span_masks(jnp.asarray(b_seed), jnp.asarray(b_fwd),
                                  jnp.asarray(b_bwd), B))
    owner0 = jnp.asarray(owner_from_bool(manager.raster))
    args = (jnp.asarray(np.asarray(success, bool)),
            jnp.asarray(np.arange(S, dtype=np.int32)),
            jnp.asarray(cams.astype(np.int32)),
            jnp.asarray(pl.astype(np.int32)),
            jnp.asarray(b_seed[:, 0].astype(np.int32)),
            jnp.asarray(span))
    from edgegraph3d_tpu.ops.compaction import fetch_global
    if mesh is not None:
        nd = mesh.size
        Sp = -(-S // nd) * nd
        pad = Sp - S

        def padit(a, fill=0):
            return jnp.asarray(np.pad(
                np.asarray(a), ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                constant_values=fill))
        args = tuple(padit(a) for a in args)
        accept, owner, converged = sharded_resolve_and_claim(
            mesh, owner0, *args, skip_start_check=skip_start_check)
        # accept is sharded over the mesh — gather across processes
        accept = fetch_global(accept)[:S]
    else:
        accept, owner, converged = resolve_and_claim_device(
            owner0, *args, skip_start_check=skip_start_check)
        accept = np.asarray(accept)
    if not bool(fetch_global(jnp.reshape(converged, (1,)))[0]):
        # max_rounds truncated the fixpoint (dependency chains deeper
        # than 64 alternations) — fall back to the exact host pass so
        # the accept set never silently diverges from the sequential
        # semantics; counted for observability
        manager.counters["device_claiming_fallback"] = \
            manager.counters.get("device_claiming_fallback", 0) + 1
        return manager.resolve_and_claim(
            success, cams, pl, seg, t, fwd_seg, fwd_t, bwd_seg, bwd_t,
            skip_start_check=skip_start_check)
    # keep the manager raster a NUMPY array (comparing against the jnp
    # INF scalar would promote the result — and the raster — to a jax
    # Array, breaking the host path's in-place span marking)
    manager.raster |= fetch_global(owner) < np.int32(2 ** 30)
    n_skipped = int((np.asarray(success, bool) & ~accept).sum())
    manager.counters["seeds_skipped_claimed"] += n_skipped
    return accept.astype(bool)
