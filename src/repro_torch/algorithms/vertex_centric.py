"""Vertex-centric pull engine (AccuGraph-style).

AccuGraph applies value changes *directly* (paper Sect. 3.3: "the value
changes are also directly applied to the values currently present in BRAM
for a coherent view") — i.e. asynchronous within an iteration.  Each block
is swept edge by edge over its dst-sorted in-edges, relaxing each edge
against the *current* value array, exactly like AccuGraph's sequential
accumulator.  This is what makes AccuGraph converge in fewer iterations
than HitGraph (Fig. 12b) — an effect the trace models depend on.

The sweep is :func:`repro_torch.kernels.sweep_min.ops.sweep_min_block`
over each block's in-edges, packed on the run's device once a run: on the
card exact parallel rounds (the serial one-thread kernel past a budget of
rounds), a plain loop on the CPU.

Stationary problems (PR, SpMV) use synchronous pull semantics (two value
arrays), matching the original article's fixed-iteration measurements:
each iteration is ``y[v] = sum over in-edges u -> v of w * x[u]``, one
:func:`repro_torch.kernels.spmv_ell.ops.spmv_sell` call (one kernel
launch) over the in-edges packed once a run as a sliced ELL, on the run's
device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.algorithms.common import (DAMPING, INF32, IterStats, Problem,
                                          RunResult, stationary_inputs)
from repro_torch.device import resolve_device
from repro_torch.graphs.formats import (CSRPartitions, Graph,
                                        partition_intervals)
from repro_torch.kernels.spmv_ell.ops import pack_in_edges, spmv_sell
from repro_torch.kernels.sweep_min.ops import (pack_sweep_block,
                                               sweep_min_block)


def _block_edges(parts: CSRPartitions, k: int):
    """Dst-sorted in-edges of block k as (src=neighbor, dst=vertex)."""
    blk = parts.blocks[k]
    dst = np.repeat(
        np.arange(parts.n, dtype=np.int64), np.diff(blk.pointers)
    )
    return blk.neighbors, dst


def _stationary_run(g: Graph, problem: Problem, p: int, iters: int,
                    device) -> RunResult:
    """PR / SpMV by pull: each iteration computes the whole ``y`` from
    the sliced in-edge ELL in one ``spmv_sell``; PR then damps.  The JAX
    package starts SpMV from ones here (it takes no ``x0``)."""
    n = g.n
    w, values_np = stationary_inputs(g, problem)
    a = pack_in_edges(g.src, g.dst, n, w, device=device)
    values = torch.as_tensor(values_np, device=device)
    blocks_all = [np.ones(n, dtype=bool) for _ in range(p)]
    per_iter: List[IterStats] = []
    for _ in range(iters):
        y = spmv_sell(a, values)
        values = (y if problem == Problem.SPMV
                  else (1.0 - DAMPING) / n + DAMPING * y)
        per_iter.append(IterStats(np.ones(n, bool), np.ones(n, bool),
                                  changed_per_block=blocks_all))
    return RunResult(values.cpu().numpy(), iters, per_iter)


def run(
    g: Graph,
    problem: Problem,
    q: Optional[int] = None,
    root: int = 0,
    max_iters: int = 10_000,
    fixed_iters: Optional[int] = None,
    block_skipping: bool = False,
    device=None,
    x0: Optional[np.ndarray] = None,
    active0: Optional[np.ndarray] = None,
) -> RunResult:
    """Run ``problem`` vertex-centrically (pull) with partition size q on
    ``device`` (default the card).

    ``block_skipping`` models the paper's §5 *partition skipping*: a dirty
    bit per source interval, set whenever a value in that interval is
    written, cleared when the block is processed; clean blocks are skipped
    (exact — a clean block admits no relaxation).  Skipped blocks are
    recorded as ``None`` in ``changed_per_block`` so the trace model emits
    no requests for them.  ``fixed_iters`` applies to the stationary
    problems only (default 1), as in the JAX package; their
    ``changed_per_block`` is one all-true array per block.

    ``x0`` / ``active0`` warm-start the relaxation (the incremental-update
    path): values start from ``x0`` and only blocks containing an
    ``active0`` vertex start dirty.  Correctness needs ``L <= x0 <=
    init`` pointwise (see :mod:`repro_torch.algorithms.incremental`).
    The sweeps of the repair go through the same ``sweep_min_block``.
    The stationary problems ignore ``x0`` and ``active0``, as the JAX
    package does.
    """
    device = resolve_device(device)
    n = g.n
    q = q if q is not None else n
    if problem.stationary:
        return _stationary_run(
            g, problem, len(partition_intervals(n, q)),
            fixed_iters if fixed_iters is not None else 1, device)
    parts = CSRPartitions.build(g, q)
    per_iter: List[IterStats] = []
    # the JAX package's quirk, kept: SSSP relaxes with +1, not weights
    add = 1 if problem in (Problem.BFS, Problem.SSSP) else 0
    if problem == Problem.WCC:
        values = torch.arange(n, dtype=torch.int32, device=device)
    else:
        values = torch.full((n,), int(INF32), dtype=torch.int32,
                            device=device)
        values[root] = 0
    if x0 is not None:
        if active0 is None:
            raise ValueError(
                "a min-problem warm start (x0=) needs active0=")
        values = torch.as_tensor(np.asarray(x0, dtype=np.int32).copy(),
                                 device=device)
    blocks = [pack_sweep_block(*(a.astype(np.int32)
                                 for a in _block_edges(parts, k)), n,
                               device=device)
              for k in range(parts.p)]
    dirty = np.ones(parts.p, dtype=bool)
    changed_prev = np.ones(n, dtype=bool)
    if active0 is not None:
        changed_prev = np.asarray(active0, dtype=bool).copy()
        dirty[:] = False
        dirty[np.unique(np.flatnonzero(changed_prev) // parts.q)] = True
    it = 0
    while it < max_iters:
        vals_before = values.clone()
        changed_blocks: List[Optional[np.ndarray]] = []
        any_processed = False
        for k in range(parts.p):
            if block_skipping and not dirty[k]:
                changed_blocks.append(None)
                continue
            any_processed = True
            dirty[k] = False
            before_k = values.clone()
            sweep_min_block(values, blocks[k], add)
            changed_k = (values != before_k).cpu().numpy()
            changed_blocks.append(changed_k)
            if block_skipping and changed_k.any():
                touched = np.nonzero(changed_k)[0]
                dirty[np.unique(touched // parts.q)] = True
        changed = (values != vals_before).cpu().numpy()
        per_iter.append(IterStats(
            active_before=changed_prev, changed=changed,
            changed_per_block=changed_blocks,
        ))
        it += 1
        changed_prev = changed
        if not changed.any() or not any_processed:
            break
    return RunResult(values.cpu().numpy(), it, per_iter)
