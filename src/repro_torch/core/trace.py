"""Request-trace container and builders.

A :class:`Trace` is the vectorized counterpart of the paper's request
streams: arrays of cache-line addresses + write flags + issue-cycle lower
bounds, in *program order*.  Accelerator models build a whole run's
phases up front as one :class:`SegmentedTrace`.  Host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.dram import CACHE_LINE_BYTES


@dataclasses.dataclass
class Trace:
    """A request trace in program order (cache-line granularity)."""

    line_addr: np.ndarray          # int64[n]
    is_write: np.ndarray           # bool[n]
    issue: np.ndarray              # int64[n], memory-clock cycles

    def __post_init__(self) -> None:
        self.line_addr = np.asarray(self.line_addr, dtype=np.int64)
        self.is_write = np.asarray(self.is_write, dtype=bool)
        self.issue = np.asarray(self.issue, dtype=np.int64)
        if not len(self.line_addr) == len(self.is_write) == len(self.issue):
            raise ValueError("trace arrays differ in length")

    def __len__(self) -> int:
        return len(self.line_addr)


@dataclasses.dataclass
class SegmentedTrace:
    """A whole-run request program: concatenated phase traces plus phase
    boundary markers.

    ``offsets[p] .. offsets[p+1]`` delimit phase ``p`` (program order
    within a phase; phases separated by barriers), ``issue`` is
    *phase-relative* (each phase restarts at cycle 0).  Empty phases are
    dropped at construction.
    """

    line_addr: np.ndarray          # int64[N]
    is_write: np.ndarray           # bool[N]
    issue: np.ndarray              # int64[N], phase-relative memory cycles
    offsets: np.ndarray            # int64[P+1]
    names: List[str]               # [P]

    def __len__(self) -> int:
        return len(self.line_addr)

    @property
    def n_phases(self) -> int:
        return len(self.names)

    def phase(self, p: int) -> Trace:
        s, e = int(self.offsets[p]), int(self.offsets[p + 1])
        return Trace(self.line_addr[s:e], self.is_write[s:e],
                     self.issue[s:e])

    @staticmethod
    def from_phases(phases: Sequence) -> "SegmentedTrace":
        """Build from ``[(name, line_addr, is_write, issue), ...]``
        (or ``(name, Trace)`` pairs); empty phases are dropped."""
        names: List[str] = []
        lines, writes, issues = [], [], []
        for entry in phases:
            if len(entry) == 2:
                name, tr = entry
                la, wr, iss = tr.line_addr, tr.is_write, tr.issue
            else:
                name, la, wr, iss = entry
            if len(la) == 0:
                continue
            names.append(name)
            lines.append(np.asarray(la, dtype=np.int64))
            writes.append(np.asarray(wr, dtype=bool))
            issues.append(np.asarray(iss, dtype=np.int64))
        if not names:
            z = np.empty(0, dtype=np.int64)
            return SegmentedTrace(z, z.astype(bool), z,
                                  np.zeros(1, dtype=np.int64), [])
        offsets = np.zeros(len(names) + 1, dtype=np.int64)
        np.cumsum([len(a) for a in lines], out=offsets[1:])
        return SegmentedTrace(
            np.concatenate(lines), np.concatenate(writes),
            np.concatenate(issues), offsets, names)


# ---------------------------------------------------------------------------
# Vectorized ragged builders: the segment-offset constructions the trace
# models use to emit all partitions' streams without per-partition loops.
# ---------------------------------------------------------------------------

def ragged_arange(counts: np.ndarray) -> np.ndarray:
    """``concat([arange(c) for c in counts])`` without the loop."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def span_counts(byte_start: np.ndarray, nbytes: np.ndarray):
    """Vectorized line-span extents: (first_line, n_lines) per span."""
    byte_start = np.asarray(byte_start, dtype=np.int64)
    nbytes = np.asarray(nbytes, dtype=np.int64)
    first = byte_start // CACHE_LINE_BYTES
    last = (byte_start + np.maximum(nbytes, 1) - 1) // CACHE_LINE_BYTES
    cnt = np.where(nbytes > 0, last - first + 1, 0)
    return first, cnt


def ragged_spans(first: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """``concat([arange(f, f+c) for f, c in zip(first, counts)])``."""
    counts = np.asarray(counts, dtype=np.int64)
    return np.repeat(np.asarray(first, dtype=np.int64),
                     counts) + ragged_arange(counts)


def ragged_bulk(start: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorized :func:`bulk_issue` over groups."""
    return np.repeat(np.asarray(start, dtype=np.int64),
                     np.asarray(counts, dtype=np.int64))


def ragged_spread(start: np.ndarray, window: np.ndarray,
                  counts: np.ndarray) -> np.ndarray:
    """Vectorized issue spread over groups: group ``g``'s element ``i``
    gets ``start[g] + floor(i * window[g] / counts[g])`` (float64
    arithmetic, bit-identical to the scalar helper)."""
    counts = np.asarray(counts, dtype=np.int64)
    i = ragged_arange(counts).astype(np.float64)
    w = np.repeat(np.asarray(window, dtype=np.float64), counts)
    n = np.repeat(counts.astype(np.float64), counts)
    t = np.repeat(np.asarray(start, dtype=np.float64), counts)
    return (t + i * w / n).astype(np.int64)


def group_ranks(counts: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Rank of each element within its group, preserving input order.

    ``key`` maps each element to its group id; ``counts`` are the group
    sizes (``np.bincount(key, minlength=G)``).
    """
    order = np.argsort(key, kind="stable")
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.cumsum(counts) - counts
    ranks = np.empty(len(key), dtype=np.int64)
    ranks[order] = np.arange(len(key), dtype=np.int64) - np.repeat(
        starts, counts)
    return ranks


def bulk_issue(n: int, start: int) -> np.ndarray:
    """Unlimited producer: all requests available at ``start`` (paper: "the
    requests are just created in bulk")."""
    return np.full(n, start, dtype=np.int64)
