"""The graph problems the accelerators run, in plain NumPy, with the
per-iteration statistics their trace models read.

* ``edge_centric`` (HitGraph): synchronous scatter/gather.  Every edge
  whose source is active offers its source's value (plus one for BFS);
  each destination takes the minimum; the active set of the next
  iteration is the set of vertices whose value changed.
* ``vertex_centric`` (AccuGraph): an asynchronous pull sweep a block.
  Block ``k`` holds the in-edges whose source lies in interval ``k``,
  sorted by destination, and is relaxed edge by edge against the
  current values.  The sweep is computed here as synchronous rounds to
  their fixed point, which equals the edge-by-edge sweep: an edge from a
  higher vertex reads the value from before the sweep, an edge from a
  lower one the value after it, and the forward substitution has one
  solution.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

#: the "unreached" value of BFS (the program's sentinel)
INF32 = np.int32(2**31 - 2**24)


@dataclasses.dataclass
class Iteration:
    active_before: np.ndarray                      # bool[n]
    changed: np.ndarray                            # bool[n]
    changed_per_block: Optional[List[np.ndarray]] = None


@dataclasses.dataclass
class Run:
    values: np.ndarray
    iterations: int
    per_iter: List[Iteration]


def _start(n: int, problem: str, root: int):
    if problem == "wcc":
        return np.arange(n, dtype=np.int32), np.ones(n, dtype=bool), 0
    if problem == "bfs":
        values = np.full(n, INF32, dtype=np.int32)
        values[root] = 0
        active = np.zeros(n, dtype=bool)
        active[root] = True
        return values, active, 1
    raise ValueError(f"the reference runs wcc and bfs, not {problem!r}")


class MinInto:
    """``out[dst[i]] = min(out[dst[i]], cand[i])`` over edges sorted by
    ``dst`` once, a segment minimum a call."""

    def __init__(self, dst: np.ndarray):
        self.starts = np.flatnonzero(np.diff(dst, prepend=np.int64(-1)))
        self.heads = dst[self.starts]

    def __call__(self, out: np.ndarray, cand: np.ndarray) -> None:
        if len(self.starts):
            out[self.heads] = np.minimum(
                out[self.heads], np.minimum.reduceat(cand, self.starts))


def edge_centric(n: int, src: np.ndarray, dst: np.ndarray, problem: str,
                 root: int = 0, max_iters: int = 10_000) -> Run:
    values, active, add = _start(n, problem, root)
    order = np.argsort(dst)     # any order: a minimum does not see it
    src, dst = src[order], dst[order]
    min_into = MinInto(dst)
    per_iter: List[Iteration] = []
    while len(per_iter) < max_iters and active.any():
        cand = np.where(active[src], values[src] + np.int32(add), INF32)
        new = values.copy()
        min_into(new, cand.astype(np.int32))
        changed = new != values
        per_iter.append(Iteration(active, changed))
        values, active = new, changed
    return Run(values, len(per_iter), per_iter)


def sweep_rounds(values: np.ndarray, src: np.ndarray, dst: np.ndarray,
                 add: int) -> np.ndarray:
    """The edge-by-edge sweep of ``values[dst] = min(values[dst],
    values[src] + add)`` over in-edges sorted by ``dst``, as rounds to
    the fixed point; returns the new values."""
    up, down = src > dst, src < dst
    base = values.copy()
    MinInto(dst[up])(base, values[src[up]] + np.int32(add))
    s_down = src[down]
    min_down = MinInto(dst[down])
    x = base
    while True:
        y = base.copy()
        min_down(y, x[s_down] + np.int32(add))
        if np.array_equal(y, x):
            return x
        x = y


def vertex_centric(n: int, src: np.ndarray, dst: np.ndarray, problem: str,
                   q: int, root: int = 0, block_skipping: bool = False,
                   max_iters: int = 10_000) -> Run:
    values, _active, add = _start(n, problem, root)
    p = -(-n // q)
    blocks = []
    for k in range(p):
        sel = (src // q) == k
        order = np.argsort(dst[sel])
        blocks.append((src[sel][order], dst[sel][order]))
    dirty = np.ones(p, dtype=bool)
    changed_prev = np.ones(n, dtype=bool)
    per_iter: List[Iteration] = []
    while len(per_iter) < max_iters:
        before = values
        per_block: List[Optional[np.ndarray]] = []
        any_processed = False
        for k, (s, d) in enumerate(blocks):
            if block_skipping and not dirty[k]:
                per_block.append(None)
                continue
            any_processed = True
            dirty[k] = False
            new = sweep_rounds(values, s, d, add)
            changed_k = new != values
            values = new
            per_block.append(changed_k)
            if block_skipping and changed_k.any():
                dirty[np.unique(np.nonzero(changed_k)[0] // q)] = True
        changed = values != before
        per_iter.append(Iteration(changed_prev, changed, per_block))
        changed_prev = changed
        if not changed.any() or not any_processed:
            break
    return Run(values, len(per_iter), per_iter)
