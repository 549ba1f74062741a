"""Edge-centric (HitGraph-style) two-phase engine.

Synchronous scatter/gather semantics (paper Sect. 3.2): each iteration
produces updates for every edge whose source is *active* (scatter), then
applies all updates to destination values (gather).  Values are always one
iteration behind within an iteration — which is why HitGraph needs more
iterations than AccuGraph (paper Fig. 12b).

On the card the min-combine step is torch code: a gather of the source
values and a ``scatter_reduce_("amin")`` onto the destinations.  On the
CPU it is a dst-sorted ``np.minimum.reduceat``, as the JAX package runs
it on the CPU.  Integer min is exact and independent of order, so both
give the JAX package's values and per-iteration statistics bit for bit.
A Python driver iterates to convergence and records the statistics the
accelerator trace models consume.

The stationary problems (PR, SpMV) run a fixed number of iterations of
two kernels, on the card and (as their plain versions) on the CPU: the
scatter ``edge_scatter(op="mul")``, ``values[src] * w``, and the gather
``segment_reduce(op="sum")`` onto the destinations, over edges sorted by
destination once a run (the gather then sums runs of equal ids before
it touches memory).  Their float sums are taken in another order than
the JAX package's, so values agree to a tolerance, while the statistics
(all-true every iteration) are equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.algorithms.common import (DAMPING, INF32, IterStats, Problem,
                                          RunResult, stationary_inputs)
from repro_torch.device import resolve_device
from repro_torch.graphs.formats import Graph
from repro_torch.kernels.edge_scatter.ops import edge_scatter
from repro_torch.kernels.segment_reduce.ops import segment_reduce


def _step_min(values, src, dst, w, active, problem: Problem):
    """SSSP / WCC / BFS scatter+gather (min combine) on tensors."""
    if problem == Problem.SSSP:
        cand = values[src] + w
    elif problem == Problem.BFS:
        cand = values[src] + 1
    else:  # wcc
        cand = values[src]
    cand = torch.where(active[src], cand,
                       torch.full_like(cand, int(INF32)))
    new = values.clone().scatter_reduce_(0, dst, cand, "amin",
                                         include_self=True)
    return new, new != values


def _min_run_numpy(g: Graph, problem: Problem, w: np.ndarray,
                   values: np.ndarray, active: np.ndarray,
                   max_iters: int):
    """Host path for the min-combine problems: one-time dst sort, then
    ``np.minimum.reduceat`` per iteration."""
    order = np.argsort(g.dst, kind="stable")
    src_s = g.src[order]
    w_s = w[order].astype(np.int32)
    dst_s = g.dst[order]
    starts = np.flatnonzero(np.diff(dst_s, prepend=np.int64(-1)))
    dgroups = dst_s[starts]
    add_one = np.int32(1)
    per_iter = []
    it = 0
    while it < max_iters and active.any():
        vs = values[src_s]
        if problem == Problem.SSSP:
            cand = vs + w_s
        elif problem == Problem.BFS:
            cand = vs + add_one
        else:  # wcc
            cand = vs
        cand = np.where(active[src_s], cand, INF32)
        new = values.copy()
        if len(starts):
            gathered = np.minimum.reduceat(cand, starts)
            new[dgroups] = np.minimum(values[dgroups], gathered)
        changed = new != values
        per_iter.append(IterStats(active_before=active, changed=changed))
        values = new
        active = changed
        it += 1
    return RunResult(values, it, per_iter)


def _min_run_torch(g: Graph, problem: Problem, w_np: np.ndarray,
                   values_np: np.ndarray, active: np.ndarray,
                   max_iters: int, device):
    """Device path for the min-combine problems: the graph and values
    stay on ``device``; each iteration's change set comes back to the
    host for the trace models."""
    src = torch.as_tensor(g.src, device=device)
    dst = torch.as_tensor(g.dst, device=device)
    w = torch.as_tensor(w_np, device=device)
    values = torch.as_tensor(values_np, device=device)
    per_iter = []
    it = 0
    while it < max_iters and active.any():
        new, changed = _step_min(values, src, dst, w,
                                 torch.as_tensor(active, device=device),
                                 problem)
        changed_np = changed.cpu().numpy()
        per_iter.append(IterStats(active_before=active, changed=changed_np))
        values = new
        active = changed_np
        it += 1
    return RunResult(values.cpu().numpy(), it, per_iter)


def sort_by_dst(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """The edges ``(src, dst, w)`` in destination order, edge-list order
    kept among equal destinations, on their device."""
    dst, order = torch.sort(dst, stable=True)
    return src[order], dst, w[order]


def _stationary_run(g: Graph, problem: Problem, iters: int, device,
                    x0: Optional[np.ndarray]) -> RunResult:
    """PR / SpMV: each iteration scatters ``values[src] * w`` over the
    edges and sums the updates onto their destinations; PR then damps.
    The edges are sorted by destination once, so that the gather sees
    runs of equal ids."""
    n = g.n
    w_np, values_np = stationary_inputs(g, problem, x0)
    src, dst, w = sort_by_dst(
        torch.as_tensor(g.src.astype(np.int32), device=device),
        torch.as_tensor(g.dst.astype(np.int32), device=device),
        torch.as_tensor(w_np, device=device))
    values = torch.as_tensor(values_np, device=device)
    ones = torch.ones(n, dtype=torch.float32, device=device)
    per_iter = []
    for _ in range(iters):
        upd, _ = edge_scatter(src, w, values, ones, op="mul")
        acc = segment_reduce(dst, upd, n, "sum")
        values = (acc if problem == Problem.SPMV
                  else (1.0 - DAMPING) / n + DAMPING * acc)
        per_iter.append(IterStats(active_before=np.ones(n, bool),
                                  changed=np.ones(n, bool)))
    return RunResult(values.cpu().numpy(), iters, per_iter)


def run(
    g: Graph,
    problem: Problem,
    root: int = 0,
    max_iters: int = 10_000,
    fixed_iters: Optional[int] = None,
    device=None,
    x0: Optional[np.ndarray] = None,
    active0: Optional[np.ndarray] = None,
) -> RunResult:
    """Run ``problem`` edge-centrically to convergence on ``device``
    (default the card); collect per-iteration stats.  ``fixed_iters``
    applies to the stationary problems only (default 1), as in the JAX
    package.

    For the min-combine problems ``x0`` / ``active0`` warm-start the
    relaxation (the incremental-update path): iteration proceeds from
    the given labelling and frontier instead of the static init.
    Correctness needs ``L <= x0 <= init`` pointwise (see
    :mod:`repro_torch.algorithms.incremental`), which the repair planner
    guarantees.  For SpMV ``x0`` is the start vector; PR ignores both."""
    device = resolve_device(device)
    if problem.stationary:
        return _stationary_run(
            g, problem, fixed_iters if fixed_iters is not None else 1,
            device, x0)
    n = g.n
    w_np = np.asarray(
        g.weights if g.weights is not None
        else np.ones(g.m, dtype=np.int32),
        dtype=np.int32)
    if problem == Problem.WCC:
        values_np = np.arange(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
    else:
        values_np = np.full(n, INF32, dtype=np.int32)
        values_np[root] = 0
        active = np.zeros(n, dtype=bool)
        active[root] = True
    if x0 is not None:
        if active0 is None:
            raise ValueError(
                "a min-problem warm start (x0=) needs active0=")
        values_np = np.asarray(x0, dtype=np.int32).copy()
    if active0 is not None:
        active = np.asarray(active0, dtype=bool).copy()
    if device.type == "cpu":
        return _min_run_numpy(g, problem, w_np, values_np, active,
                              max_iters)
    return _min_run_torch(g, problem, w_np, values_np, active, max_iters,
                          device)
