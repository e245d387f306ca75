"""DIMACS-9 weighted-graph interop.

The reference exchanges its polyline-similarity graph with grappolo
through DIMACS shortest-path files: `p sp N M` header and 1-indexed
`a u v w` arc lines (reference:
src/edgegraph3d/plgs/graph_adjacency_set_undirected_no_type_weighted.cpp:38-74,
consumed by external/grappolo-05-2014 with ftype 2).  This engine
clusters on-device (matching/communities.py) and never round-trips
through files, but this module keeps the format available for
interop/debugging against external Louvain tools.
"""

from __future__ import annotations

import numpy as np


def write_dimacs(path: str, edges: np.ndarray, weights: np.ndarray,
                 n_nodes: int) -> None:
    """edges [M,2] 0-indexed undirected, weights [M]."""
    edges = np.asarray(edges)
    weights = np.asarray(weights)
    with open(path, "w") as f:
        f.write(f"p sp {n_nodes} {len(edges)}\n")
        for (a, b), w in zip(edges, weights):
            f.write(f"a {int(a) + 1} {int(b) + 1} {float(w):g}\n")


def read_dimacs(path: str):
    """Returns (edges [M,2] 0-indexed, weights [M], n_nodes)."""
    edges, weights, n_nodes = [], [], 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "p":
                n_nodes = int(parts[2])
            elif parts[0] == "a":
                edges.append((int(parts[1]) - 1, int(parts[2]) - 1))
                weights.append(float(parts[3]))
    return (np.asarray(edges, dtype=np.int64).reshape(-1, 2),
            np.asarray(weights, dtype=np.float64), n_nodes)


def read_clustering(path: str) -> np.ndarray:
    """Cluster id per node, one integer per line (the grappolo output
    format read back by community_detection_interface.cpp:42-55)."""
    with open(path) as f:
        return np.asarray([int(x) for x in f.read().split()],
                          dtype=np.int64)


def write_clustering(path: str, labels: np.ndarray) -> None:
    with open(path, "w") as f:
        for x in np.asarray(labels):
            f.write(f"{int(x)}\n")
