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
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from repro_torch import spans


class GraphParseError(ValueError):
    """A graph file could not be parsed; names the file, the 1-based
    line, and what was wrong — malformed corpus inputs must fail loudly,
    not produce a silently truncated graph."""

    def __init__(self, path, line_no: Optional[int], msg: str):
        self.path = str(path)
        self.line_no = line_no
        where = (f"{self.path}:{line_no}" if line_no is not None
                 else self.path)
        super().__init__(f"{where}: {msg}")


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

    @property
    def avg_degree(self) -> float:
        return self.m / max(self.n, 1)

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

    def relabeled(self, perm: np.ndarray, name: Optional[str] = None
                  ) -> "Graph":
        """Vertex relabeling: ``perm[v]`` is the new id of old vertex
        ``v`` (``perm`` must be a permutation of ``range(n)``).  Edge
        *order* and weights are untouched, so the edge multiset is
        preserved up to the relabeling — the invariant the corpus
        transforms (degree sort, BFS reorder) are property-tested on."""
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.n,):
            raise ValueError(
                f"perm must have shape ({self.n},), got {perm.shape}")
        return Graph(
            self.n, perm[self.src], perm[self.dst],
            None if self.weights is None else self.weights.copy(),
            self.directed, name or self.name,
        )

    @property
    def fingerprint(self) -> str:
        """Content hash of the graph (structure + weights + name): the
        identity the sweep engine keys its per-graph sessions on, so two
        equal graphs built apart share algorithm runs, models and packed
        programs.  Equal to the JAX package's digest of the same graph.
        Cached after the first call."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            with spans.span("graph.fingerprint"):
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

    def sorted_by(self, key: str = "dst") -> "Graph":
        """Stable sort of the edge list (HitGraph sorts each partition's
        edges by destination to enable update merging)."""
        order = np.argsort(self.dst if key == "dst" else self.src,
                           kind="stable")
        return Graph(
            self.n, self.src[order], self.dst[order],
            None if self.weights is None else self.weights[order],
            self.directed, self.name,
        )


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


@dataclasses.dataclass
class EdgeListPartitions:
    """HitGraph layout: per-partition edge lists, sorted by destination."""

    g: Graph
    q: int
    intervals: List[Tuple[int, int]]
    edge_index: List[np.ndarray]         # indices into g per partition

    @staticmethod
    def build(g: Graph, q: int) -> "EdgeListPartitions":
        intervals = partition_intervals(g.n, q)
        part_of_src = g.src // q
        edge_index = []
        order = np.argsort(g.dst, kind="stable")  # dst-sorted (opt. 1)
        part_sorted = part_of_src[order]
        for k in range(len(intervals)):
            edge_index.append(order[part_sorted == k])
        return EdgeListPartitions(g, q, intervals, edge_index)

    @property
    def p(self) -> int:
        return len(self.intervals)

    def edges_in(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = self.edge_index[k]
        return self.g.src[idx], self.g.dst[idx]


# ---------------------------------------------------------------------------
# File parsers (the corpus ingestion path): SNAP edge lists and
# MatrixMarket coordinate files.  Both fail loudly on malformed input
# with file:line context (GraphParseError) instead of skipping rows.
# ---------------------------------------------------------------------------


def _parse_id(tok: str, path, line_no: int) -> int:
    try:
        v = int(tok)
    except ValueError:
        raise GraphParseError(
            path, line_no, f"vertex id {tok!r} is not an integer") \
            from None
    return v


def load_snap_edgelist(path: Union[str, Path], directed: bool = True,
                       name: Optional[str] = None) -> Graph:
    """Parse a SNAP-style edge list: one ``src dst [weight]`` pair per
    line, ``#`` comment lines, 0-based vertex ids (the format of the
    paper's live-journal / orkut / roadnet-ca downloads).

    ``n`` is ``max(id) + 1``.  Raises :class:`GraphParseError` on
    non-integer ids, negative ids, lines with the wrong column count,
    inconsistent weight columns, or an empty edge set.
    """
    path = Path(path)
    src, dst, weights = [], [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line_no, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            if len(toks) not in (2, 3):
                raise GraphParseError(
                    path, line_no,
                    f"expected 'src dst [weight]', got {len(toks)} "
                    f"columns ({line[:40]!r})")
            u = _parse_id(toks[0], path, line_no)
            v = _parse_id(toks[1], path, line_no)
            if u < 0 or v < 0:
                raise GraphParseError(
                    path, line_no, f"negative vertex id ({u}, {v})")
            if len(toks) == 3:
                if src and not weights:
                    raise GraphParseError(
                        path, line_no,
                        "inconsistent columns: earlier lines had no "
                        "weight, this one does")
                try:
                    weights.append(float(toks[2]))
                except ValueError:
                    raise GraphParseError(
                        path, line_no,
                        f"weight {toks[2]!r} is not a number") from None
            elif weights:
                raise GraphParseError(
                    path, line_no,
                    "inconsistent columns: earlier lines carried a "
                    "weight, this one does not")
            src.append(u)
            dst.append(v)
    if not src:
        raise GraphParseError(path, None, "no edges found")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n = int(max(src.max(), dst.max())) + 1
    w = np.asarray(weights) if weights else None
    return Graph(n, src, dst, w, directed=directed,
                 name=name or path.stem)


def load_matrix_market(path: Union[str, Path],
                       name: Optional[str] = None) -> Graph:
    """Parse a MatrixMarket ``coordinate`` file as a graph (rows are
    sources, columns destinations; the SuiteSparse distribution format).

    Handles ``%`` comments, the banner line, 1-based indexing,
    ``pattern`` / ``real`` / ``integer`` fields, and ``symmetric``
    (off-diagonal entries mirrored) vs ``general`` symmetry.  Raises
    :class:`GraphParseError` on a missing or unsupported banner, a
    malformed size line, out-of-range 1-based indices, or an entry
    count that does not match the declared ``nnz``.
    """
    path = Path(path)
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        banner = f.readline()
        if not banner.startswith("%%MatrixMarket"):
            raise GraphParseError(
                path, 1, "missing '%%MatrixMarket' banner")
        parts = banner.strip().split()
        if len(parts) < 5:
            raise GraphParseError(
                path, 1, f"malformed banner {banner.strip()!r}")
        _, obj, fmt, field, symmetry = parts[:5]
        if obj.lower() != "matrix" or fmt.lower() != "coordinate":
            raise GraphParseError(
                path, 1,
                f"only 'matrix coordinate' is supported, got "
                f"'{obj} {fmt}'")
        field = field.lower()
        if field not in ("real", "integer", "pattern"):
            raise GraphParseError(
                path, 1, f"unsupported field {field!r} (complex "
                "matrices are not graphs)")
        symmetry = symmetry.lower()
        if symmetry not in ("general", "symmetric"):
            raise GraphParseError(
                path, 1, f"unsupported symmetry {symmetry!r}")
        size = None
        src, dst, weights = [], [], []
        line_no = 1
        for line_no, line in enumerate(f, start=2):
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            toks = line.split()
            if size is None:
                if len(toks) != 3:
                    raise GraphParseError(
                        path, line_no,
                        f"size line must be 'rows cols nnz', got "
                        f"{line[:40]!r}")
                rows = _parse_id(toks[0], path, line_no)
                cols = _parse_id(toks[1], path, line_no)
                nnz = _parse_id(toks[2], path, line_no)
                if rows <= 0 or cols <= 0 or nnz < 0:
                    raise GraphParseError(
                        path, line_no,
                        f"non-positive dimensions {rows}x{cols}, "
                        f"nnz={nnz}")
                size = (rows, cols, nnz)
                continue
            want = 2 if field == "pattern" else 3
            if len(toks) != want:
                raise GraphParseError(
                    path, line_no,
                    f"expected {want} columns for field "
                    f"'{field}', got {len(toks)}")
            i = _parse_id(toks[0], path, line_no)
            j = _parse_id(toks[1], path, line_no)
            rows, cols, nnz = size
            if not (1 <= i <= rows and 1 <= j <= cols):
                raise GraphParseError(
                    path, line_no,
                    f"index ({i}, {j}) out of range for a "
                    f"{rows}x{cols} matrix (MatrixMarket is 1-based)")
            if len(src) >= nnz:
                raise GraphParseError(
                    path, line_no,
                    f"more than the declared nnz={nnz} entries")
            src.append(i - 1)
            dst.append(j - 1)
            if field != "pattern":
                try:
                    weights.append(float(toks[2]))
                except ValueError:
                    raise GraphParseError(
                        path, line_no,
                        f"value {toks[2]!r} is not a number") from None
        if size is None:
            raise GraphParseError(path, None, "missing size line")
        rows, cols, nnz = size
        if len(src) != nnz:
            raise GraphParseError(
                path, None,
                f"declared nnz={nnz} but found {len(src)} entries")
        if not src:
            raise GraphParseError(path, None, "no edges found")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(weights) if weights else None
    directed = symmetry == "general"
    if symmetry == "symmetric":
        # mirror off-diagonal entries (each stored once in the file)
        off = src != dst
        src, dst = (np.concatenate([src, dst[off]]),
                    np.concatenate([dst, src[off]]))
        if w is not None:
            w = np.concatenate([w, w[off]])
    n = max(rows, cols)
    return Graph(n, src, dst, w, directed=directed,
                 name=name or path.stem)


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
