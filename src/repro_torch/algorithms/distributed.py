"""Distributed edge-centric engine: HitGraph's architecture over
``torch.distributed``.

HitGraph on an FPGA partitions the vertices into intervals by source; its
PEs scatter updates through a p x p crossbar into per-partition queues,
and the gather applies them.  Here each rank of a process group owns one
vertex interval (its values) and the edges whose *source* lies in it.  The
scatter takes, for every destination slot of the whole graph, a
segment-min of the candidate values (``scatter_reduce_("amin")``, the
merging of the dst-sorted updates); the crossbar is one
``all_to_all_single`` of those queues; the gather is an elementwise min
against the local values.  The iteration is synchronous, like HitGraph's
two-phase execution, so the values equal those of
``algorithms/edge_centric.py`` and of the JAX package's ``shard_map``
engine.

An empty segment of the scatter holds ``INF32``; JAX's ``segment_min``
gives int32 max there.  Both vanish in the min against the local values,
which never exceed ``INF32``, so the results are equal.

With no process group initialized the world is one shard on ``device``
and no collective runs.  NCCL groups take CUDA tensors and gloo groups
CPU tensors; any other pairing raises (nothing is staged through the
host).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.algorithms.common import INF32
from repro_torch.device import resolve_device
from repro_torch.graphs.formats import Graph

#: the device type each process-group backend takes
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def shard_edges(g: Graph, n_shards: int, weighted: bool = False):
    """Partition edges by source interval and pad shards to equal size.

    Returns (src, dst, w, valid) each of shape (n_shards, max_edges) and
    the padded interval size q.
    """
    q = -(-g.n // n_shards)                  # ceil
    part = g.src // q
    counts = np.bincount(part, minlength=n_shards)
    E = max(int(counts.max()), 1)
    src = np.zeros((n_shards, E), np.int32)
    dst = np.zeros((n_shards, E), np.int32)
    w = np.ones((n_shards, E), np.int32)
    valid = np.zeros((n_shards, E), bool)
    weights = (g.weights if g.weights is not None
               else np.ones(g.m, dtype=np.int32)).astype(np.int32)
    for s in range(n_shards):
        idx = np.nonzero(part == s)[0]
        src[s, :len(idx)] = g.src[idx]
        dst[s, :len(idx)] = g.dst[idx]
        w[s, :len(idx)] = weights[idx]
        valid[s, :len(idx)] = True
    return src, dst, w, valid, q


def _world(group) -> Tuple[Optional[object], int, int]:
    """``(group, shards, this rank's shard)``: the default group when one is
    initialized and ``group`` is None, else no group and one shard."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_rank(group)


def _check_backend(group, device: torch.device) -> None:
    if group is None:
        return
    backend = str(dist.get_backend(group))
    want = BACKEND_DEVICE.get(backend)
    if want is None:
        raise ValueError(f"the distributed engine runs over nccl or gloo, "
                         f"not {backend}")
    if device.type != want:
        raise ValueError(f"a {backend} group takes {want} tensors, not "
                         f"{device.type} ones (pass device= to match)")


def make_min_step(group, n_shards: int, q: int, add_weight: bool
                  ) -> Callable:
    """The distributed scatter / crossbar / gather step of this rank.

    ``step(values_l[q], src_l, dst_l, w_l, valid_l)`` takes this rank's
    interval (int32) and its padded edges (global ids as int64, weights
    int32, ``valid`` bool) and returns the new interval and a one-element
    int32 flag, nonzero when any rank's values changed.  ``group`` None
    means one shard and no collective."""
    shard_id = 0 if group is None else dist.get_rank(group)
    inf = int(INF32)

    def step(values_l, src_l, dst_l, w_l, valid_l):
        # padded edges carry source 0, outside every interval but the
        # first: mask them before the gather, not after
        local_src = torch.where(valid_l, src_l - shard_id * q,
                                torch.zeros_like(src_l))
        cand = values_l[local_src]
        if add_weight:
            cand = cand + w_l
        cand = torch.where(valid_l, cand, torch.full_like(cand, inf))
        # scatter + merge: segment-min keyed by the global dst slot, laid
        # out as (dst shard, dst local): the update queues
        upd = torch.full((n_shards * q,), inf, dtype=torch.int32,
                         device=values_l.device)
        upd.scatter_reduce_(0, dst_l, cand, "amin", include_self=True)
        # the crossbar: rank r receives chunk r of every sender's queues,
        # in sender order
        if group is None:
            recv = upd
        else:
            recv = torch.empty_like(upd)
            dist.all_to_all_single(recv, upd, group=group)
        gathered = recv.view(n_shards, q).amin(dim=0)
        new_vals = torch.minimum(values_l, gathered)
        changed = (new_vals != values_l).any().to(torch.int32).reshape(1)
        if group is not None:
            dist.all_reduce(changed, op=dist.ReduceOp.MAX, group=group)
        return new_vals, changed

    return step


def _propagate(g: Graph, init: Callable[[int, int], np.ndarray],
               add_weight: bool, group, device, max_iters: int,
               stats: Optional[dict]) -> np.ndarray:
    """Run the min step to its fixed point; every rank returns the whole
    ``[n]`` int32 result.  ``init(S, q)`` gives the ``[S, q]`` start
    values."""
    group, n_shards, rank = _world(group)
    device = resolve_device(device)
    _check_backend(group, device)
    t0 = time.perf_counter()
    src, dst, w, valid, q = shard_edges(g, n_shards, weighted=add_weight)
    step = make_min_step(group, n_shards, q, add_weight)
    args = (torch.as_tensor(src[rank], dtype=torch.int64, device=device),
            torch.as_tensor(dst[rank], dtype=torch.int64, device=device),
            torch.as_tensor(w[rank], dtype=torch.int32, device=device),
            torch.as_tensor(valid[rank], dtype=torch.bool, device=device))
    values = torch.as_tensor(init(n_shards, q)[rank], dtype=torch.int32,
                             device=device)
    t1 = time.perf_counter()
    step_seconds = []
    for _ in range(max_iters):
        t = time.perf_counter()
        values, changed = step(values, *args)
        done = not int(changed.item())
        step_seconds.append(time.perf_counter() - t)
        if done:
            break
    t2 = time.perf_counter()
    if group is None:
        out = values
    else:
        out = torch.empty((n_shards * q,), dtype=torch.int32, device=device)
        # all_gather_single is all_gather_into_tensor's newer name
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        gather(out, values, group=group)
    result = out.cpu().numpy()[:g.n]
    if stats is not None:
        stats.update(iterations=len(step_seconds), shards=n_shards, q=q,
                     edges_per_shard=int(src.shape[1]),
                     setup_seconds=t1 - t0, step_seconds=step_seconds,
                     gather_seconds=time.perf_counter() - t2)
    return result


def run_wcc(g: Graph, group=None, device=None, max_iters: int = 10_000,
            stats: Optional[dict] = None) -> np.ndarray:
    """Distributed WCC (min-label propagation); returns the labels.  The
    world is ``group`` (default: the initialized default group, else one
    shard); ``device`` None means the card.  ``stats``, when given,
    receives the iteration count, the shard layout and the host-clock
    seconds of the set-up (sharding and copies), of each step (each ends
    in a sync on the ``changed`` flag) and of the final gather."""
    def init(S, q):
        values = np.arange(S * q, dtype=np.int32).reshape(S, q)
        return np.where(values < g.n, values, INF32).astype(np.int32)
    return _propagate(g, init, False, group, device, max_iters, stats)


def run_sssp(g: Graph, root: int = 0, group=None, device=None,
             max_iters: int = 10_000,
             stats: Optional[dict] = None) -> np.ndarray:
    """Distributed SSSP from ``root`` (unit weights when ``g`` has none);
    returns the distances, ``INF32`` where unreached.  Arguments as
    :func:`run_wcc`."""
    gw = g.with_unit_weights() if g.weights is None else g

    def init(S, q):
        values = np.full((S, q), INF32, dtype=np.int32)
        values[root // q, root % q] = 0
        return values
    return _propagate(gw, init, True, group, device, max_iters, stats)
