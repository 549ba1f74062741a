"""Shared problem definitions and per-iteration statistics containers."""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

INF32 = np.int32(2**31 - 2**24)     # large sentinel, headroom for +w


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
