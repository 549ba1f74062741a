"""Incremental WCC / BFS frontier repair for dynamic-graph updates.

Both engines solve min-propagation fixpoints

    L[v] = min(init[v],  min over edges (s -> v) of  f(L[s]))

(WCC: ``f = id`` over vertex-id labels; BFS: ``f = +1`` over depths).
Warm-starting the engines from ``x0`` / ``active0`` instead of the
static init converges to the *new* graph's fixpoint ``L_new`` iff

    L_new  <=  x0  <=  static init     (pointwise).

After an :class:`~repro_torch.graphs.updates.UpdateBatch`, the converged
old labelling violates the lower bound only where a justifying path used
a deleted edge.  The repair planner restores the invariant exactly:

* ``R`` — the forward closure (along edge direction in the *new* graph)
  of the deleted edges' destinations: every vertex whose old
  justification may have used a deleted edge is reachable from that
  edge's destination.
* ``x0``  = old values with ``x0[R]`` reset to the static init (the BFS
  root keeps depth 0), so ``L_new <= x0 <= init`` everywhere.
* ``active0`` = ``R``, its in-neighbors in the new graph (they re-relax
  the reset region), and the endpoints of inserted edges (they open the
  only new relaxation paths).

The result is bit-identical to a static recompute on the mutated graph
and to the JAX package's repair, while the per-iteration statistics the
trace models consume cover only the repair frontier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.algorithms import edge_centric, vertex_centric
from repro_torch.algorithms.common import INF32, Problem, RunResult
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.updates import UpdateBatch

#: problems with an incremental variant.  SSSP is min-combine too but
#: re-weights deletions non-locally; PR/SpMV are stationary (no
#: warm-start semantics).
INCREMENTAL_PROBLEMS = (Problem.WCC, Problem.BFS)


def static_init(problem: Problem, n: int, root: int = 0) -> np.ndarray:
    """The static initial labelling the engines start from."""
    if problem == Problem.WCC:
        return np.arange(n, dtype=np.int32)
    if problem == Problem.BFS:
        init = np.full(n, INF32, dtype=np.int32)
        init[root] = 0
        return init
    raise ValueError(
        f"no incremental variant for problem {problem}; "
        f"supported: {[p.value for p in INCREMENTAL_PROBLEMS]}")


def forward_closure(g: Graph, seeds: np.ndarray) -> np.ndarray:
    """bool[n]: vertices reachable from ``seeds`` along edge direction
    (seeds included).  Level-synchronous: each level gathers the whole
    frontier's out-neighbors at once."""
    reach = np.zeros(g.n, dtype=bool)
    if not len(seeds):
        return reach
    counts = np.bincount(g.src, minlength=g.n)
    ptr = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    nbr = g.dst[np.argsort(g.src, kind="stable")]
    frontier = np.unique(np.asarray(seeds, dtype=np.int64))
    reach[frontier] = True
    while len(frontier):
        deg = counts[frontier]
        first = np.repeat(ptr[frontier], deg)
        within = np.arange(len(first), dtype=np.int64) - np.repeat(
            np.cumsum(deg) - deg, deg)
        nxt = np.unique(nbr[first + within])
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt
    return reach


@dataclasses.dataclass(frozen=True)
class RepairPlan:
    """Warm-start inputs restoring ``L_new <= x0 <= init`` (see module
    docstring) plus the reset region for reporting."""

    x0: np.ndarray                 # int32[n]
    active0: np.ndarray            # bool[n]
    reset: np.ndarray              # bool[n] — the closure R

    @property
    def n_reset(self) -> int:
        return int(self.reset.sum())

    @property
    def n_active(self) -> int:
        return int(self.active0.sum())


def plan_repair(g_old: Graph, g_new: Graph, batch: UpdateBatch,
                problem: Problem, old_values: np.ndarray,
                root: int = 0) -> RepairPlan:
    """Build the repair plan for ``batch`` taking ``g_old`` (with
    converged ``old_values``) to ``g_new``."""
    n = g_new.n
    init = static_init(problem, n, root)
    old = np.asarray(old_values, dtype=np.int32)
    if len(old) != n:
        raise ValueError(
            f"old_values has {len(old)} entries for an n={n} graph")

    del_dst = (g_old.dst[batch.delete_idx] if batch.n_deleted
               else np.empty(0, dtype=np.int64))
    reset = forward_closure(g_new, del_dst)

    x0 = old.copy()
    x0[reset] = init[reset]

    active = reset.copy()
    if reset.any():
        # in-neighbors (in the new graph) of the reset region re-relax it
        active[np.unique(g_new.src[reset[g_new.dst]])] = True
    if batch.n_inserted:
        active[batch.insert_src] = True
        active[batch.insert_dst] = True
    return RepairPlan(x0=x0, active0=active, reset=reset)


def run_incremental(g_old: Graph, g_new: Graph, batch: UpdateBatch,
                    problem: Problem, old_values: np.ndarray, *,
                    engine: str = "edge", root: int = 0,
                    q: Optional[int] = None,
                    block_skipping: bool = False,
                    max_iters: int = 10_000,
                    plan: Optional[RepairPlan] = None,
                    device=None) -> RunResult:
    """Repair ``old_values`` after ``batch`` on the engine named by
    ``engine`` (``"edge"`` = HitGraph-style scatter/gather, ``"vertex"``
    = AccuGraph-style pull), on ``device`` (default the card).  Returns a
    :class:`RunResult` whose final values are bit-identical to a static
    recompute on ``g_new`` and whose per-iteration stats cover only the
    repair frontier."""
    problem = Problem(problem)
    if problem not in INCREMENTAL_PROBLEMS:
        raise ValueError(
            f"no incremental variant for problem {problem}; "
            f"supported: {[p.value for p in INCREMENTAL_PROBLEMS]}")
    if plan is None:
        plan = plan_repair(g_old, g_new, batch, problem, old_values, root)
    if engine == "edge":
        g = g_new.with_unit_weights() if g_new.weights is None else g_new
        return edge_centric.run(g, problem, root=root,
                                max_iters=max_iters, device=device,
                                x0=plan.x0, active0=plan.active0)
    if engine == "vertex":
        return vertex_centric.run(g_new, problem, q=q, root=root,
                                  max_iters=max_iters,
                                  block_skipping=block_skipping,
                                  device=device,
                                  x0=plan.x0, active0=plan.active0)
    raise ValueError(f"unknown engine {engine!r}; 'edge' | 'vertex'")
