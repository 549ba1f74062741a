"""The benchmark's graphs, made from ``--seed``.

A frozen copy of the degree-matched stand-in generator of the program
(``graphs/generators.py::degree_matched``) and of its undirected view, so
that a later change to the program cannot change the yardstick's inputs.
The configuration file gives the Tab. 1 row (vertices, edges, skew) and
the seed of the graph's structure; ``--seed`` orders its edge list.

The structure does not follow ``--seed``: on this graph the number of
WCC iterations, and with it the work of a grid point, moves by an
iteration (about 15 % of the requests) between structure seeds and
between relabellings of one structure.  The order of the edge list, as
any file of the graph may hold it, leaves every request count as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphArrays:
    """An edge list: ``src[i] -> dst[i]`` over ``n`` vertices."""

    n: int
    src: np.ndarray      # int64[m], read-only
    dst: np.ndarray      # int64[m], read-only
    name: str
    directed: bool

    @property
    def m(self) -> int:
        return len(self.src)


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """Stream ``stream`` of a NumPy generator for any whole-number seed
    (negative ones wrap into 64 bits)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def degree_matched(n: int, m: int, skew: float, seed: int):
    """``(src, dst)``: both endpoints drawn from a truncated Zipf(skew)
    over a random permutation of the vertex ids (the program's generator,
    draw for draw; a skew of 0.01 or less is uniform)."""
    rng = np.random.default_rng(seed)
    if skew <= 0.01:
        return rng.integers(0, n, m), rng.integers(0, n, m)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    perm = rng.permutation(n)
    src = perm[np.searchsorted(cdf, rng.random(m))]
    dst = perm[np.searchsorted(cdf, rng.random(m))]
    return src.astype(np.int64), dst.astype(np.int64)


def make_graph(spec: dict, seed: int) -> GraphArrays:
    """The configuration's ``graph`` block: the stand-in for
    ``spec["dataset"]`` at ``spec["vertices"]`` vertices and
    ``spec["edges"]`` edges from the structure seed ``spec["seed"]``,
    symmetrised (every edge in both directions) when
    ``spec["undirected"]``, its edge list in the order ``seed`` draws."""
    if spec["generator"] != "degree_matched":
        raise ValueError(f"unknown graph generator {spec['generator']!r}")
    n, m = int(spec["vertices"]), int(spec["edges"])
    src, dst = degree_matched(n, m, float(spec["skew"]), int(spec["seed"]))
    name = spec["dataset"]
    if spec["undirected"]:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        name += "_undir"
    order = rng_for(seed, 0).permutation(len(src))
    src, dst = src[order], dst[order]
    for a in (src, dst):
        a.flags.writeable = False
    return GraphArrays(n, src, dst, name, not spec["undirected"])
