"""Device-side community detection: weighted label propagation.

JAX-native replacement for the reference's grappolo (PNNL parallel
Louvain) invoked through a DIMACS file round-trip (reference:
external/grappolo-05-2014/driverForGraphClustering_edited.cpp:50-170,
src/edgegraph3d/matching/polyline_matching/community_detection_interface.cpp:42-73,
src/edgegraph3d/plgs/graph_adjacency_set_undirected_no_type_weighted.cpp:38-74).
BASELINE.json names label propagation as the designated device-side
replacement; community quality only affects stage-1 recall (SURVEY.md
"Grappolo replacement quality"), so exact Louvain parity is not
required — grappolo is thread-nondeterministic anyway.

Algorithm: synchronous weighted label propagation over an edge list,
`n_iters` rounds, ties broken toward the smaller label (deterministic).
Runs jitted on device: each round is one segment-sum + argmax.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


#: dense-scoreboard LP bound: below this node count each round is one
#: [n, n] scatter-add + row argmax (~0.6 GB at 12k nodes — milliseconds
#: on device) instead of an O(E log E) sort of the 2E directed
#: contributions (measured ~1.5 s/round on the full-scale 8M-entry
#: graph); above it the sparse lexsort formulation takes over
LP_DENSE_MAX_NODES = 16384


@partial(jax.jit, static_argnames=("n_nodes", "n_iters"))
def _label_propagation_dense(edges: jnp.ndarray, weights: jnp.ndarray,
                             n_nodes: int, n_iters: int) -> jnp.ndarray:
    """Dense-scoreboard weighted LP (same fixed point and tie rule as
    the sparse path: best neighbour-label weight sum, ties toward the
    smaller label — jnp.argmax returns the first maximum)."""
    valid = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    w = jnp.where(valid, weights, 0.0).astype(jnp.float32)
    src = jnp.concatenate([edges[:, 0], edges[:, 1]])
    dst = jnp.concatenate([edges[:, 1], edges[:, 0]])
    ww = jnp.concatenate([w, w])
    src = jnp.maximum(src, 0).astype(jnp.int32)
    dst = jnp.maximum(dst, 0).astype(jnp.int32)

    def step(labels):
        score = jnp.zeros((n_nodes, n_nodes), jnp.float32)
        score = score.at[src, labels[dst]].add(ww)
        best = jnp.max(score, axis=1)
        new = jnp.argmax(score, axis=1).astype(jnp.int32)
        return jnp.where(best > 0, new, labels)

    def cond(carry):
        i, _, changed = carry
        return (i < n_iters) & changed

    def body(carry):
        i, labels, _ = carry
        new = step(labels)
        return i + 1, new, jnp.any(new != labels)

    labels0 = jnp.arange(n_nodes, dtype=jnp.int32)
    _, labels, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), labels0, jnp.bool_(True)))
    return labels


@partial(jax.jit, static_argnames=("n_nodes", "n_iters"))
def label_propagation(edges: jnp.ndarray, weights: jnp.ndarray,
                      n_nodes: int, n_iters: int = 30) -> jnp.ndarray:
    """edges [E,2] int32 (undirected), weights [E] -> labels [n_nodes].

    Invalid edges are marked with node id -1 and ignored.
    Dispatches to the dense scoreboard below LP_DENSE_MAX_NODES.

    Sparse formulation: per round, directed-edge contributions are
    grouped by (receiver, sender-label) with a two-key lexsort +
    segment-sum, then reduced per receiver with scatter-max (score) and
    scatter-min (tie-break toward the smaller label).  O(E log E) per
    round above the dense bound, no packed sort key (the round-4
    int32 key capped n_nodes at ~46k; lexsort removes the limit for
    multi-device-scale graphs).
    """
    if n_nodes <= LP_DENSE_MAX_NODES:
        return _label_propagation_dense(edges, weights, n_nodes,
                                        n_iters)
    valid = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    w = jnp.where(valid, weights, 0.0)
    src = jnp.concatenate([edges[:, 0], edges[:, 1]])
    dst = jnp.concatenate([edges[:, 1], edges[:, 0]])
    ww = jnp.concatenate([w, w]).astype(jnp.float32)
    src = jnp.maximum(src, 0).astype(jnp.int32)
    dst = jnp.maximum(dst, 0).astype(jnp.int32)
    E2 = src.shape[0]
    NEG = jnp.float32(-1.0)

    def step(labels):
        lab_v = labels[dst]
        order = jnp.lexsort((lab_v, src))
        g_src_all = src[order]
        g_lab_all = lab_v[order]
        ws = ww[order]
        start = jnp.concatenate(
            [jnp.ones((1,), bool),
             (g_src_all[1:] != g_src_all[:-1])
             | (g_lab_all[1:] != g_lab_all[:-1])])
        gid = jnp.cumsum(start) - 1                       # group index
        gsum = jax.ops.segment_sum(ws, gid, num_segments=E2)
        # representative (src, label) per group, read at group starts
        g_src = jnp.where(start, g_src_all, 0)
        g_lab = jnp.where(start, g_lab_all, 0)
        g_score = gsum[gid] * start                       # score at starts
        # best score per receiver
        best = jnp.full((n_nodes,), NEG).at[g_src].max(
            jnp.where(start, g_score, NEG))
        # among groups hitting the best score: smallest label
        is_best = start & (g_score >= best[g_src] - 1e-12) & (g_score > 0)
        new = jnp.full((n_nodes,), n_nodes, jnp.int32).at[
            jnp.where(is_best, g_src, n_nodes - 1)].min(
            jnp.where(is_best, g_lab, n_nodes))
        has = best > 0
        return jnp.where(has & (new < n_nodes), new, labels)

    # early-exit while_loop: LP typically converges well before
    # n_iters (measured ~4 s/iteration on an 8M-entry graph on the CPU
    # backend — running converged iterations is pure waste); identical
    # fixed point, the loop stops when a round changes no label
    def cond(carry):
        i, _, changed = carry
        return (i < n_iters) & changed

    def body(carry):
        i, labels, _ = carry
        new = step(labels)
        return i + 1, new, jnp.any(new != labels)

    labels0 = jnp.arange(n_nodes, dtype=jnp.int32)
    _, labels, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), labels0, jnp.bool_(True)))
    return labels


def modularity(edges: np.ndarray, weights: np.ndarray,
               labels: np.ndarray) -> float:
    """Weighted Newman modularity Q of a partition (host-side scorer).

    Q = (1/2m) sum_ij (A_ij - k_i k_j / 2m) delta(c_i, c_j), the
    objective grappolo's Louvain maximizes (reference:
    external/grappolo-05-2014/louvainMultiPhaseRun.cpp; quality
    printed by driverForGraphClustering_edited.cpp:148-170).  Used to
    measure the label-propagation replacement against a modularity
    baseline (tools/community_ab.py, tests/test_communities.py)."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    labels = np.asarray(labels)
    if len(edges) == 0:
        return 0.0
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    e, w = edges[ok], weights[ok]
    # self-loops: A_ii appears ONCE in Newman's sum over ij (and once
    # in 2m / k_i), while an undirected non-self edge contributes twice
    # — counting loop weight at full doubled weight over-credits w_in
    # (louvain_host's aggregation phases emit self-loops, so the scorer
    # must handle them; same convention as its two_m/deg bookkeeping)
    sl = e[:, 0] == e[:, 1]
    w_self = w[sl].sum()
    two_m = 2.0 * w[~sl].sum() + w_self
    if two_m <= 0:
        return 0.0
    deg = np.zeros(labels.shape[0])
    np.add.at(deg, e[~sl, 0], w[~sl])
    np.add.at(deg, e[~sl, 1], w[~sl])
    np.add.at(deg, e[sl, 0], w[sl])
    same = (labels[e[:, 0]] == labels[e[:, 1]]) & ~sl
    w_in = 2.0 * w[same].sum() + w_self       # intra weight, Newman count
    n_comm = labels.max() + 1
    sum_tot = np.zeros(int(n_comm) + 1)
    np.add.at(sum_tot, labels, deg)
    return float(w_in / two_m - np.sum((sum_tot / two_m) ** 2))


def _louvain_one_level(indptr: np.ndarray, nbr: np.ndarray,
                       w: np.ndarray, deg: np.ndarray,
                       two_m: float) -> np.ndarray:
    """One sequential local-moving pass over a CSR adjacency: greedily
    move nodes to the neighbouring community with the best modularity
    gain until no move improves.  Active-queue scheduling (a node is
    revisited only when a neighbour moved) with numpy group-bys per
    node — the similarity graphs reach millions of edges (2.3M at the
    49-view workload), where the earlier dict-of-lists formulation
    cost 60+ s of pure Python.  Deterministic: fixed node order, ties
    toward the smaller community label."""
    n = len(deg)
    labels = np.arange(n)
    sum_tot = deg.copy()                       # per-community degree
    active = np.ones(n, dtype=bool)
    for _ in range(64):
        idx = np.flatnonzero(active)
        if len(idx) == 0:
            break
        active[:] = False
        moved = False
        for i in idx:
            s, t = indptr[i], indptr[i + 1]
            if s == t:
                continue
            ln = labels[nbr[s:t]]
            o = np.argsort(ln, kind="stable")
            lx, wx = ln[o], w[s:t][o]
            starts = np.flatnonzero(
                np.concatenate(([True], lx[1:] != lx[:-1])))
            comms = lx[starts]                 # ascending
            wc = np.add.reduceat(wx, starts)
            ci = labels[i]
            sum_tot[ci] -= deg[i]
            gains = wc - deg[i] * sum_tot[comms] / two_m
            p = np.searchsorted(comms, ci)
            stay = (gains[p] if p < len(comms) and comms[p] == ci
                    else -deg[i] * sum_tot[ci] / two_m)
            j = int(np.argmax(gains))          # first max = smallest c
            best_c, best_g = int(comms[j]), float(gains[j])
            move = (best_g > stay + 1e-12
                    or (abs(best_g - stay) <= 1e-12 and best_c < ci))
            new_c = best_c if move else ci
            labels[i] = new_c
            sum_tot[new_c] += deg[i]
            if new_c != ci:
                moved = True
                active[nbr[s:t]] = True
        if not moved:
            break
    return labels


def _louvain_one_level_parallel(indptr: np.ndarray, nbr: np.ndarray,
                                w: np.ndarray, deg: np.ndarray,
                                two_m: float, n_batches: int = 16,
                                max_sweeps: int = 24) -> np.ndarray:
    """Batch-parallel local moving — the vectorized stand-in for
    grappolo's PARALLEL Louvain (reference:
    external/grappolo-05-2014/parallelLouvainWithColoring.cpp,
    parallelLouvainMethod.cpp): nodes are processed in deterministic
    batches; within a batch every node evaluates its best move against
    the labels at batch start and all moves apply simultaneously
    (grappolo's coloring serves the same purpose — bounded staleness;
    its threaded updates are nondeterministic, this is reproducible).
    Fully vectorized numpy — no per-node Python loop, so the
    2-host-core sequential pass (112 s on the 3M-edge full-scale
    similarity graph) becomes a few group-by sweeps (~1 s).

    Same move rule as the sequential pass: gain = wc - k_i*sum_tot[c]/2m
    with the node's own degree removed from its community, move on
    strictly better gain (ties toward the smaller community id)."""
    n = len(deg)
    labels = np.arange(n)
    sum_tot = deg.copy()
    counts = np.diff(indptr)
    flat_node = np.repeat(np.arange(n), counts)       # [F]
    rng = np.random.default_rng(0)
    batch_of = rng.integers(0, n_batches, n)          # deterministic
    active = np.ones(n, dtype=bool)
    for _ in range(max_sweeps):
        if not active.any():
            break
        moved_any = False
        for b in range(n_batches):
            sel = active & (batch_of == b)
            idx = np.flatnonzero(sel)
            if len(idx) == 0:
                continue
            # flat adjacency rows of the batch
            rs = indptr[idx]
            re = indptr[idx + 1]
            ln = re - rs
            F = int(ln.sum())
            if F == 0:
                active[idx] = False
                continue
            node_of = np.repeat(np.arange(len(idx)), ln)
            flat = _flat_ranges(rs, re, F)
            lab_n = labels[nbr[flat]]
            wv = w[flat]
            # group by (batch-node, neighbour label)
            key = node_of.astype(np.int64) * n + lab_n
            uk, inv = np.unique(key, return_inverse=True)
            wc = np.bincount(inv, weights=wv)
            g_node = (uk // n).astype(np.int64)
            g_lab = (uk % n).astype(np.int64)
            gi = idx[g_node]
            ci = labels[gi]
            st_adj = sum_tot[g_lab] - deg[gi] * (g_lab == ci)
            gains = wc - deg[gi] * st_adj / two_m
            # stay gain per batch node (0 when ci absent from nbrs)
            stay = -deg[idx] * (sum_tot[ci_b := labels[idx]]
                                - deg[idx]) / two_m
            own = g_lab == ci
            stay_present = np.zeros(len(idx))
            stay_present[g_node[own]] = gains[own]
            has_own = np.zeros(len(idx), dtype=bool)
            has_own[g_node[own]] = True
            stay = np.where(has_own, stay_present, stay)
            # best move per batch node: max gain, ties -> smaller label
            order = np.lexsort((g_lab, -gains, g_node))
            first = np.concatenate(
                [[True], g_node[order][1:] != g_node[order][:-1]])
            top = order[first]
            bn = g_node[top]
            best_c = g_lab[top]
            best_g = gains[top]
            mv = (best_g > stay[bn] + 1e-12) \
                | ((np.abs(best_g - stay[bn]) <= 1e-12)
                   & (best_c < ci_b[bn]))
            mv &= best_c != ci_b[bn]
            movers = idx[bn[mv]]
            if len(movers):
                moved_any = True
                newc = best_c[mv]
                np.subtract.at(sum_tot, labels[movers], deg[movers])
                np.add.at(sum_tot, newc, deg[movers])
                labels[movers] = newc
                # wake the movers' neighbours
                ms, me = indptr[movers], indptr[movers + 1]
                wake = _flat_ranges(ms, me, int((me - ms).sum()))
                active[nbr[wake]] = True
            active[idx] = False
        if not moved_any:
            break
    return labels


def _flat_ranges(starts: np.ndarray, ends: np.ndarray,
                 total: int) -> np.ndarray:
    """Concatenate integer ranges [starts[i], ends[i]) — vectorized."""
    ln = ends - starts
    out = np.repeat(starts, ln)
    off = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(ln)[:-1]]), ln)
    return out + off


def louvain_host(edges: np.ndarray, weights: np.ndarray,
                 n_nodes: int, max_phases: int = 10,
                 parallel: bool | None = None) -> np.ndarray:
    """Multi-phase Louvain (host-side), the union's modularity arm.

    Stands in for grappolo's runMultiPhaseLouvainAlgorithm (reference:
    external/grappolo-05-2014/louvainMultiPhaseRun.cpp,
    parallelLouvainMethod.cpp): local moving to a modularity local
    optimum, aggregate communities into super-nodes, repeat until no
    phase merges anything.  `parallel` picks the local-moving pass:
    False = exact sequential (`_louvain_one_level`, the measurement
    baseline; O(n) Python loop per sweep — 112 s on the full-scale
    3M-edge graph), True = deterministic batch-parallel
    (`_louvain_one_level_parallel`, grappolo's actual parallel design,
    fully vectorized — the production path at scale), None/auto =
    sequential below LOUVAIN_MAX_NODES, parallel above."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0) \
        if len(edges) else np.zeros(0, bool)
    e, w = edges[ok].astype(np.int64), weights[ok]
    if parallel is None:
        # node count drives the sequential pass's Python-loop cost
        # (measured: 6.8 s at 12k nodes / 3M edges — fine; it is the
        # O(n) per-sweep node loop that dies at multi-device scale, not E)
        parallel = n_nodes > LOUVAIN_MAX_NODES
    total_map = np.arange(n_nodes)
    n = n_nodes
    self_w = np.zeros(n)
    for _ in range(max_phases):
        two_m = 2.0 * w.sum() + self_w.sum()
        if two_m <= 0:
            break
        deg = self_w.copy()
        np.add.at(deg, e[:, 0], w)
        np.add.at(deg, e[:, 1], w)
        # CSR adjacency (self-loops excluded; they live in deg/self_w)
        ns = e[:, 0] != e[:, 1]
        src = np.concatenate([e[ns, 0], e[ns, 1]])
        dst = np.concatenate([e[ns, 1], e[ns, 0]])
        ww2 = np.concatenate([w[ns], w[ns]])
        order = np.argsort(src, kind="stable")
        indptr = np.searchsorted(src[order], np.arange(n + 1))
        level = _louvain_one_level_parallel if parallel \
            else _louvain_one_level
        lab = level(indptr, dst[order], ww2[order], deg, two_m)
        uniq, lab_c = np.unique(lab, return_inverse=True)
        total_map = lab_c[total_map]
        if len(uniq) == n:
            break
        # aggregate: communities become super-nodes (vectorized
        # group-by on packed pair keys)
        n2 = len(uniq)
        self2 = np.zeros(n2)
        np.add.at(self2, lab_c, self_w)
        ec = lab_c[e]
        lo = np.minimum(ec[:, 0], ec[:, 1])
        hi = np.maximum(ec[:, 0], ec[:, 1])
        self_m = lo == hi
        np.add.at(self2, lo[self_m], 2.0 * w[self_m])
        key = lo[~self_m] * n2 + hi[~self_m]
        uk, inv = np.unique(key, return_inverse=True)
        ws = np.zeros(len(uk))
        np.add.at(ws, inv, w[~self_m])
        e = np.stack([uk // n2, uk % n2], axis=1)
        w = ws
        self_w = self2
        n = n2
    return total_map


def refine_labels_by_modularity(edges: np.ndarray, weights: np.ndarray,
                                labels: np.ndarray) -> np.ndarray:
    """LP-then-merge: aggregate the LP communities into super-nodes and
    run host Louvain on the (tiny) community graph.  Merges over-split
    communities toward the modularity optimum; cannot split.  Measured
    (tests/test_communities.py, tools/community_ab.py): recovers the
    modularity Louvain reaches on planted-partition graphs where plain
    LP over-splits, at negligible host cost (the aggregate graph has
    one node per LP community)."""
    edges = np.asarray(edges)
    weights = np.asarray(weights, np.float64)
    ok = (edges[:, 0] >= 0) & (edges[:, 1] >= 0) \
        if len(edges) else np.zeros(0, bool)
    e, w = edges[ok], weights[ok]
    uniq, lab_c = np.unique(labels, return_inverse=True)
    n_c = len(uniq)
    if n_c <= 1 or len(e) == 0:
        return np.asarray(labels)
    ec = lab_c[e]
    lo = np.minimum(ec[:, 0], ec[:, 1]).astype(np.int64)
    hi = np.maximum(ec[:, 0], ec[:, 1]).astype(np.int64)
    key = lo * n_c + hi
    uk, inv = np.unique(key, return_inverse=True)
    w2 = np.zeros(len(uk))
    np.add.at(w2, inv, w)
    e2 = np.stack([uk // n_c, uk % n_c], axis=1)
    merged = louvain_host(e2, w2, n_c)
    return merged[lab_c]


#: graphs at or below this node count take the exact host Louvain in
#: method="auto" (the similarity graphs of real scenes are hundreds to
#: thousands of nodes; LP is the formulation that scales past host
#: memory, same policy as filtering/density.py's sequential fast path)
LOUVAIN_MAX_NODES = 20_000


def communities_from_edges(edges: np.ndarray, weights: np.ndarray,
                           n_nodes: int, n_iters: int = 30,
                           min_size: int = 2,
                           method: str = "auto") -> list[np.ndarray]:
    """Edge list -> list of node-id arrays (communities of >= min_size).

    Mirrors the reference call contract (compute_communities,
    community_detection_interface.cpp:57-73: cluster id per node).

    Methods, measured in COMMUNITIES.md / tests/test_communities.py:
      * "louvain"  — host Louvain (grappolo-quality partition;
        sequential local moving on small graphs, deterministic
        batch-parallel — grappolo's own parallel design — above
        LOUVAIN_MAX_NODES, so the arm survives multi-device-scale graphs)
      * "lp"       — device label propagation (scales to multi-device-size
        graphs; over-merges on ~1/4 of real similarity graphs, but its
        raw partition WINS on some cluttered scenes — COMMUNITIES.md
        scene 0: raw-LP coverage 0.724 vs union's 0.591)
      * "lp+merge" — LP + host modularity merge (fixes LP's
        over-SPLITS; cannot fix over-merges)
      * "union"    — union of the "lp+merge" and "louvain" partitions'
        communities (deduplicated).  Neither partitioner dominates:
        LP can collapse a similarity graph to one community (stage-1
        recall lost), Louvain's resolution limit can merge small true
        communities whose bigger merged match sets then kill seeds
        through the downstream uniqueness test.  Sweeping BOTH
        partitions recovers each one's misses; the interval claims
        dedup the overlap (measured in COMMUNITIES.md).
      * "union3"   — union + the raw-LP partition as a third arm
        (production default via "auto"; closes the measured raw-LP
        gap above at the cost of one more swept partition — overlap
        still deduped by the interval claims)
      * "auto"     — union3 at every scale (the Louvain arm switches
        to the batch-parallel pass on big graphs)
    """
    if len(edges) == 0 or n_nodes == 0:
        return []
    if method == "auto":
        method = "union3"

    def run_lp():
        # pad shapes to powers of two so compiled executables are
        # reused across scenes (and across the persistent compile cache)
        E_pad = 1 << int(np.ceil(np.log2(max(len(edges), 1))))
        n_pad = 1 << int(np.ceil(np.log2(max(n_nodes, 1))))
        edges_p = np.full((E_pad, 2), -1, dtype=np.int32)
        edges_p[: len(edges)] = edges
        weights_p = np.zeros(E_pad, dtype=np.float32)
        weights_p[: len(weights)] = weights
        return np.asarray(label_propagation(
            jnp.asarray(edges_p), jnp.asarray(weights_p),
            n_pad, n_iters))[:n_nodes]

    def to_comms(labels):
        out = []
        for lab in np.unique(labels):
            members = np.flatnonzero(labels == lab)
            if len(members) >= min_size:
                out.append(members)
        return out

    if method in ("union", "union3"):
        # one LP run feeds both the lp+merge arm and (union3) the
        # raw-LP arm — LP is the expensive device pass at scale
        lp_labels = run_lp()
        a = to_comms(refine_labels_by_modularity(edges, weights,
                                                 lp_labels))
        b = to_comms(louvain_host(edges, weights, n_nodes))
        if method == "union3":
            b = b + to_comms(lp_labels)
        seen = {frozenset(int(x) for x in c) for c in a}
        out3 = list(a)
        for c in b:
            key = frozenset(int(x) for x in c)
            if key not in seen:
                seen.add(key)
                out3.append(c)
        return out3
    if method == "louvain":
        labels = louvain_host(edges, weights, n_nodes)
    else:
        labels = run_lp()
        if method == "lp+merge":
            labels = refine_labels_by_modularity(edges, weights, labels)
    return to_comms(labels)
