"""Community-detection quality vs a modularity (Louvain) baseline.

SURVEY §7 set the validation bar for the grappolo replacement:
"validate by comparing stage-level point counts and final accuracy" —
round 3's verdict flagged that label propagation had never been
measured against ANY modularity baseline.  These tests plant
ground-truth partitions, score all three partitioners with the shared
modularity scorer, and pin the measured result: LP + the host
modularity merge (the production default) reaches the sequential
Louvain's modularity on every seed (tools/community_ab.py records the
full-pipeline stage-level A/B).

Baseline stand-in for grappolo (reference:
external/grappolo-05-2014/driverForGraphClustering_edited.cpp:50-170,
louvainMultiPhaseRun.cpp): communities.louvain_host.
"""

import numpy as np
import pytest

from edgegraph3d_tpu.matching import communities as cm


def planted(k_comm=6, size=12, p_in=0.8, p_out=0.03, seed=0):
    rng = np.random.default_rng(seed)
    n = k_comm * size
    gt = np.repeat(np.arange(k_comm), size)
    es, ws = [], []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < (p_in if gt[i] == gt[j] else p_out):
                es.append((i, j))
                ws.append(rng.uniform(0.5, 1.5))
    return np.asarray(es), np.asarray(ws), n, gt


def _labels_of(comms, n):
    lab = np.full(n, -1)
    for i, c in enumerate(comms):
        lab[c] = i
    stragglers = np.flatnonzero(lab < 0)
    lab[stragglers] = len(comms) + np.arange(len(stragglers))
    return lab


def test_modularity_scorer_known_value():
    # two triangles joined by one edge; Q of the 2-clique split by the
    # definition: Q = sum_c [L_c/m - (d_c/2m)^2], m=7, L_c=3, d_c=7
    e = np.asarray([[0, 1], [1, 2], [0, 2], [3, 4], [4, 5], [3, 5],
                    [2, 3]])
    w = np.ones(7)
    labels = np.asarray([0, 0, 0, 1, 1, 1])
    expect = 6 / 7 - ((7 / 14) ** 2 + (7 / 14) ** 2)
    assert abs(cm.modularity(e, w, labels) - expect) < 1e-12
    # the merged partition scores worse
    assert cm.modularity(e, w, np.zeros(6, np.int64)) < expect


def test_louvain_recovers_planted_partition():
    for seed in range(3):
        e, w, n, gt = planted(seed=seed)
        lab = cm.louvain_host(e, w, n)
        assert abs(cm.modularity(e, w, lab)
                   - cm.modularity(e, w, gt)) < 1e-9


def test_lp_with_merge_matches_louvain_modularity():
    """The multi-device-scale fallback (LP + modularity merge) reaches
    Louvain's modularity on every planted seed (plain LP over-splits
    on some)."""
    rows = []
    for seed in range(5):
        e, w, n, gt = planted(seed=seed)
        q_lv = cm.modularity(e, w, cm.louvain_host(e, w, n))
        lab_m = _labels_of(
            cm.communities_from_edges(e, w, n, method="lp+merge"), n)
        lab_0 = _labels_of(
            cm.communities_from_edges(e, w, n, method="lp"), n)
        rows.append((seed, cm.modularity(e, w, lab_0),
                     cm.modularity(e, w, lab_m), q_lv))
    print("seed, Q_lp, Q_lp+merge, Q_louvain")
    for r in rows:
        print("  %d  %.4f  %.4f  %.4f" % r)
    for seed, q0, qm, q_lv in rows:
        assert qm >= q_lv - 1e-6, (seed, qm, q_lv)


def test_merge_cannot_split():
    e, w, n, _ = planted(seed=2)
    lab0 = _labels_of(
        cm.communities_from_edges(e, w, n, method="lp"), n)
    lab1 = cm.refine_labels_by_modularity(e, w, lab0)
    # every pre-merge community maps into exactly one merged community
    for c in np.unique(lab0):
        assert len(np.unique(lab1[lab0 == c])) == 1


def test_auto_is_union_at_small_scale():
    """Production default: small graphs sweep the UNION of the
    lp+merge and Louvain partitions.  COMMUNITIES.md measured each
    partitioner failing where the other succeeds (LP collapses one
    real similarity graph to a single community; Louvain's resolution
    limit merges cube-edge match sets and the merged sets kill seeds
    via the uniqueness test, coverage 0.92 vs LP's 1.00) — the union
    recovers both, and downstream interval claiming dedups overlap."""
    e, w, n, gt = planted(seed=2)
    auto = {frozenset(int(x) for x in c)
            for c in cm.communities_from_edges(e, w, n)}
    for method in ("lp+merge", "louvain"):
        for c in cm.communities_from_edges(e, w, n, method=method):
            assert frozenset(int(x) for x in c) in auto, method
