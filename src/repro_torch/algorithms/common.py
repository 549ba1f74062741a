"""Shared problem definitions and per-iteration statistics containers."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from repro_torch.graphs.formats import Graph

INF32 = np.int32(2**31 - 2**24)     # large sentinel, headroom for +w

#: PageRank's damping factor
DAMPING = 0.85


class Problem(str, enum.Enum):
    BFS = "bfs"
    SSSP = "sssp"
    WCC = "wcc"
    SPMV = "spmv"
    PR = "pr"

    @property
    def stationary(self) -> bool:
        """SpMV and PR execute a fixed number of iterations over all
        vertices; BFS/SSSP/WCC iterate on active sets until convergence."""
        return self in (Problem.SPMV, Problem.PR)


@dataclasses.dataclass
class IterStats:
    """Per-iteration execution statistics driving trace generation."""

    active_before: np.ndarray              # bool[n]: sources active
    changed: np.ndarray                    # bool[n]: values written
    changed_per_block: Optional[List[np.ndarray]] = None  # vertex-centric


@dataclasses.dataclass
class RunResult:
    values: np.ndarray
    iterations: int
    per_iter: List[IterStats]

    @property
    def total_changed(self) -> int:
        return int(sum(s.changed.sum() for s in self.per_iter))


def stationary_inputs(g: Graph, problem: Problem,
                      x0: Optional[np.ndarray] = None):
    """The per-edge factor ``w`` and the start values of PR or SpMV, as
    the JAX package makes them: SpMV's edge weights (ones without) and
    ``x0`` (ones without); PR's ``1 / max(outdeg(src), 1)``, divided in
    float64 and rounded to float32, and ``1 / n``."""
    n = g.n
    if problem == Problem.SPMV:
        w = (g.weights if g.weights is not None
             else np.ones(g.m, dtype=np.float32))
        values = x0 if x0 is not None else np.ones(n, dtype=np.float32)
        return (np.asarray(w, dtype=np.float32),
                np.asarray(values, dtype=np.float32))
    inv_deg = (1.0 / np.maximum(g.out_degrees(), 1)).astype(np.float32)
    return inv_deg[g.src], np.full(n, 1.0 / n, dtype=np.float32)
