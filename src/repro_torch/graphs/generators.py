"""Synthetic graph generators.

Seeded and deterministic, with the same NumPy ``default_rng`` call order
as the JAX package's generators, so a seed gives the same graph in both
packages (the port's tests hold them equal).
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph

GRAPH500_ABCD = (0.57, 0.19, 0.19, 0.05)


def rmat(
    scale: int,
    avg_degree: int,
    seed: int = 0,
    abcd=GRAPH500_ABCD,
    name: str | None = None,
    permute: bool = True,
) -> Graph:
    """R-MAT generator (Graph500 parameters by default).

    ``n = 2**scale`` vertices, ``m = n * avg_degree`` edges, bit-recursive
    quadrant sampling, vectorized over all edges at once.  ``permute``
    applies the standard Graph500 vertex-label shuffle.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * avg_degree
    a, b, c, d = abcd
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant: 0 -> (0,0), 1 -> (0,1), 2 -> (1,0), 3 -> (1,1)
        quad = np.where(
            r < a, 0, np.where(r < a + b, 1, np.where(r < a + b + c, 2, 3))
        )
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    if permute:
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    return Graph(n, src, dst, name=name or f"rmat-{scale}-{avg_degree}")


def kronecker(
    scale: int,
    avg_degree: int,
    initiator=None,
    noise: float = 0.1,
    seed: int = 0,
    name: str | None = None,
) -> Graph:
    """Noisy stochastic-Kronecker generator (SKG).

    Like :func:`rmat` this samples each edge's ``scale`` address bits
    from a 2x2 initiator, but perturbs the initiator *per level* with a
    seeded symmetric noise term — the standard fix (Seshadhri et al.)
    for plain SKG's oscillating degree distribution, and what makes the
    family a distinct corpus scenario rather than an R-MAT alias.
    All draws come from one seeded generator; fully deterministic.
    """
    rng = np.random.default_rng(seed)
    a, b, c, d = initiator if initiator is not None else (0.45, 0.22,
                                                          0.22, 0.11)
    n = 1 << scale
    m = n * avg_degree
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _bit in range(scale):
        mu = rng.uniform(-noise, noise)
        # perturb a and d in opposition, renormalize b=c to keep the
        # initiator a distribution
        ai = max(a + mu * a, 1e-6)
        di = max(d - mu * d, 1e-6)
        rest = max(1.0 - ai - di, 2e-6)
        bi = ci = rest / 2.0
        r = rng.random(m)
        quad = np.where(
            r < ai, 0,
            np.where(r < ai + bi, 1, np.where(r < ai + bi + ci, 2, 3)))
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    perm = rng.permutation(n)
    return Graph(n, perm[src], perm[dst],
                 name=name or f"kron-{scale}-{avg_degree}")


def uniform_random(n: int, m: int, seed: int = 0,
                   name: str = "uniform") -> Graph:
    rng = np.random.default_rng(seed)
    return Graph(n, rng.integers(0, n, m), rng.integers(0, n, m), name=name)


def degree_matched(
    n: int, m: int, skew: float = 1.0, seed: int = 0, name: str = "matched",
) -> Graph:
    """Power-law-ish stand-in: sample endpoints ~ Zipf(skew) over a random
    permutation of vertex ids.  ``skew``≈0 -> uniform; larger -> heavier
    hubs (social-network-like)."""
    rng = np.random.default_rng(seed)
    if skew <= 0.01:
        return uniform_random(n, m, seed, name)
    # inverse-CDF sampling of a truncated zipf
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    perm = rng.permutation(n)
    src = perm[np.searchsorted(cdf, rng.random(m))]
    dst = perm[np.searchsorted(cdf, rng.random(m))]
    return Graph(n, src, dst, name=name)


def grid_road(side: int, seed: int = 0, name: str = "grid") -> Graph:
    """2-D grid with 4-neighborhood: high diameter, avg degree ~2-3,
    roadnet-ca-like (paper: 'high diameter, constant degree graphs')."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right_s = idx[:, :-1].ravel()
    right_d = idx[:, 1:].ravel()
    down_s = idx[:-1, :].ravel()
    down_d = idx[1:, :].ravel()
    src = np.concatenate([right_s, down_s])
    dst = np.concatenate([right_d, down_d])
    # roadnet-ca is (treated as) undirected in the originals
    return Graph(n, np.concatenate([src, dst]),
                 np.concatenate([dst, src]), directed=False, name=name)


def chain(n: int, name: str = "chain") -> Graph:
    """Path graph — worst-case diameter; used by property tests."""
    src = np.arange(n - 1, dtype=np.int64)
    return Graph(n, src, src + 1, name=name)
