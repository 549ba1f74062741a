"""Plain-numpy oracles for the five graph problems (paper Sect. 2.1).

These define *correct outputs* (BFS levels, shortest distances, component
labels, SpMV product, PageRank) independent of any accelerator execution
strategy; the engines are validated against them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph

INF = np.iinfo(np.int64).max // 4


def bfs(g: Graph, root: int) -> np.ndarray:
    """BFS levels (iteration index per the paper's definition)."""
    level = np.full(g.n, INF, dtype=np.int64)
    level[root] = 0
    frontier = np.array([root])
    it = 0
    # CSR for efficiency
    order = np.argsort(g.src, kind="stable")
    dst_sorted = g.dst[order]
    ptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(g.src, minlength=g.n), out=ptr[1:])
    while len(frontier):
        it += 1
        nbrs = np.concatenate(
            [dst_sorted[ptr[v]:ptr[v + 1]] for v in frontier]
        ) if len(frontier) else np.empty(0, dtype=np.int64)
        nbrs = np.unique(nbrs)
        new = nbrs[level[nbrs] == INF]
        level[new] = it
        frontier = new
    return level


def sssp(g: Graph, root: int) -> np.ndarray:
    """Bellman-Ford (synchronous relaxation to fixpoint)."""
    w = (g.weights if g.weights is not None
         else np.ones(g.m, dtype=np.int64)).astype(np.int64)
    dist = np.full(g.n, INF, dtype=np.int64)
    dist[root] = 0
    for _ in range(g.n):
        cand = dist[g.src] + w
        new = dist.copy()
        np.minimum.at(new, g.dst, np.where(dist[g.src] >= INF, INF, cand))
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def wcc(g: Graph) -> np.ndarray:
    """Weakly-connected components as min-vertex-id labels (undirected
    closure; the paper notes WCC is only correct on undirected graphs)."""
    label = np.arange(g.n, dtype=np.int64)
    src = np.concatenate([g.src, g.dst])
    dst = np.concatenate([g.dst, g.src])
    while True:
        new = label.copy()
        np.minimum.at(new, dst, label[src])
        if np.array_equal(new, label):
            return label
        label = new


def spmv(g: Graph, x: np.ndarray, iterations: int = 1) -> np.ndarray:
    """y = A x repeated; A given by the (weighted) edge list."""
    w = (g.weights if g.weights is not None
         else np.ones(g.m, dtype=np.float64)).astype(np.float64)
    y = np.asarray(x, dtype=np.float64)
    for _ in range(iterations):
        out = np.zeros(g.n, dtype=np.float64)
        np.add.at(out, g.dst, w * y[g.src])
        y = out
    return y


def pagerank(g: Graph, iterations: int = 1, d: float = 0.85) -> np.ndarray:
    """p(i) = (1-d)/|V| + d * sum_{j in N(i)} p(j)/deg(j) (paper formula;
    damping applied to the sum as in the standard formulation)."""
    deg = np.maximum(np.bincount(g.src, minlength=g.n), 1)
    p = np.full(g.n, 1.0 / g.n)
    for _ in range(iterations):
        contrib = p[g.src] / deg[g.src]
        acc = np.zeros(g.n, dtype=np.float64)
        np.add.at(acc, g.dst, contrib)
        p = (1.0 - d) / g.n + d * acc
    return p
