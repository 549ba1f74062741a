"""Graph containers, CSR, and horizontal partitioning (paper Fig. 3).

Horizontal partitioning divides the vertex set into ``p`` contiguous
intervals of size ``q`` and assigns each edge to the partition containing
its *source* vertex (Fig. 3a, HitGraph's edge lists).  AccuGraph stores the
*inverted* edges as per-partition CSR (Fig. 3b): partition k holds the
in-edges whose source lies in interval k (the interval whose values are
prefetched to BRAM), addressed by destination vertex.

Host-side NumPy, as in the JAX package: graphs are built and partitioned
on the host and only the algorithm engines move them to a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed graph as an edge list (+ optional weights)."""

    n: int
    src: np.ndarray                 # int64[m]
    dst: np.ndarray                 # int64[m]
    weights: Optional[np.ndarray] = None
    directed: bool = True
    name: str = "graph"

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        if self.weights is not None:
            self.weights = np.asarray(self.weights)

    @property
    def m(self) -> int:
        return len(self.src)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int64)

    def with_unit_weights(self) -> "Graph":
        """Paper §4.1: HitGraph weights undisclosed; we initialize to 1."""
        return dataclasses.replace(
            self, weights=np.ones(self.m, dtype=np.int32)
        )

    def undirected_view(self) -> "Graph":
        """Symmetrize (for WCC, which is only correct on undirected)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = (np.concatenate([self.weights, self.weights])
             if self.weights is not None else None)
        return Graph(self.n, src, dst, w, directed=False,
                     name=self.name + "_undir")

    def inverted(self) -> "Graph":
        return Graph(self.n, self.dst.copy(), self.src.copy(),
                     None if self.weights is None else self.weights.copy(),
                     self.directed, self.name + "_inv")

    @property
    def fingerprint(self) -> str:
        """Content hash of the graph (structure + weights + name): the
        identity the sweep engine keys its per-graph sessions on, so two
        equal graphs built apart share algorithm runs, models and packed
        programs.  Equal to the JAX package's digest of the same graph.
        Cached after the first call."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{self.n}|{int(self.directed)}|{self.name}|"
                     .encode())
            h.update(self.src.tobytes())
            h.update(self.dst.tobytes())
            if self.weights is not None:
                h.update(str(self.weights.dtype).encode())
                h.update(np.ascontiguousarray(self.weights).tobytes())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()
        return fp


@dataclasses.dataclass
class CSR:
    """Compressed sparse row: ``pointers[i]..pointers[i+1]`` delimit the
    neighbors of vertex ``i`` (paper Fig. 3b)."""

    n: int
    pointers: np.ndarray            # int64[n+1]
    neighbors: np.ndarray           # int64[m]
    weights: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return len(self.neighbors)

    @staticmethod
    def from_graph(g: Graph) -> "CSR":
        order = np.argsort(g.src, kind="stable")
        neighbors = g.dst[order]
        w = None if g.weights is None else g.weights[order]
        counts = np.bincount(g.src, minlength=g.n)
        pointers = np.zeros(g.n + 1, dtype=np.int64)
        np.cumsum(counts, out=pointers[1:])
        return CSR(g.n, pointers, neighbors, w)

    def degrees(self) -> np.ndarray:
        return np.diff(self.pointers)


def partition_intervals(n: int, q: int) -> List[Tuple[int, int]]:
    """Contiguous vertex intervals of size ``q`` (last may be short)."""
    return [(s, min(s + q, n)) for s in range(0, max(n, 1), q)]


@dataclasses.dataclass
class CSRPartitions:
    """AccuGraph layout: inverse-CSR blocks.

    Partition k holds, for *every* destination vertex, its in-neighbors
    whose (source) id lies in interval k — the interval whose values are
    resident in BRAM while the block is processed.
    """

    n: int
    q: int
    intervals: List[Tuple[int, int]]
    blocks: List[CSR]                    # one CSR over all n dsts per block

    @staticmethod
    def build(g: Graph, q: int) -> "CSRPartitions":
        inv = g.inverted()               # neighbors = in-neighbors
        intervals = partition_intervals(g.n, q)
        blocks = []
        part_of_nbr = inv.dst // q
        for k in range(len(intervals)):
            mask = part_of_nbr == k
            sub = Graph(inv.n, inv.src[mask], inv.dst[mask])
            blocks.append(CSR.from_graph(sub))
        return CSRPartitions(g.n, q, intervals, blocks)

    @property
    def p(self) -> int:
        return len(self.intervals)
