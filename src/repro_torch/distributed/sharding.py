"""Case-sharded sweep serving.

The batched serve (:func:`repro_torch.core.vectorized.fused_scan_batch`)
serves independent cases, each from a cold carry.  On a mesh of N entries
(:func:`repro_torch.launch.mesh.make_sweep_mesh`) the case batch splits
into N contiguous shards instead, one batched serve each on its entry's
device: ``dram_serve_batch`` (``csrc/dram_serve.cu``) on a card, its plain
version on the CPU.  The per-case math is the same, so every finish equals
the unsharded serve's bit for bit, for any mesh.  The batch pads up to a
multiple of the mesh size with replicas of case 0, as the JAX package
pads, so every shard has the same number of cases; the pad rows are
dropped afterwards.

Every shard's inputs are placed on its device before the first shard is
served, and the finishes are gathered onto ``device`` only once every
shard has been launched, so distinct cards serve their shards at once.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import vectorized as vec

Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _case0(arr, n: int):
    """``n`` replicas of case 0 of ``arr`` (an array or a tensor, case axis
    first)."""
    if isinstance(arr, torch.Tensor):
        return arr[:1].expand((n,) + tuple(arr.shape[1:]))
    return np.repeat(np.asarray(arr)[:1], n, axis=0)


def _shard_rows(arr, lo: int, hi: int, M: int):
    """Cases ``[lo, hi)`` of ``arr``'s ``M`` cases padded with replicas of
    case 0 past ``M``, without copying the cases outside the shard."""
    if hi <= M:
        return arr[lo:hi]
    parts = ([arr[lo:M]] if lo < M else []) + [_case0(arr, hi - max(lo, M))]
    if isinstance(arr, torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


def _pad_cases(arr, pad: int):
    """``arr`` with ``pad`` replicas of case 0 appended."""
    return _shard_rows(arr, 0, len(arr) + pad, len(arr))


def _serve_shards(streams_for: Callable[[int, int, torch.device], Streams],
                  timing, n_banks: int, banks_per_rank: int,
                  mesh: Sequence[torch.device], device):
    """Serve ``len(timing)`` cases in ``len(mesh)`` shards: shard k's
    streams are ``streams_for(lo, hi, mesh[k])``.  Returns the finishes
    ``[M, S, C, K]`` and the lean carries, case axis first, on
    ``device``."""
    if not mesh:
        raise ValueError("the case mesh is empty")
    device = torch.device(device)
    M = len(timing)
    D = len(mesh)
    per = -(-M // D)
    bounds = [(k * per, (k + 1) * per) for k in range(D)]
    inputs = [(streams_for(lo, hi, d),
               vec.as_int32(_shard_rows(timing, lo, hi, M), d))
              for (lo, hi), d in zip(bounds, mesh)]
    outs = [vec.fused_scan_batch(*streams, t, n_banks, banks_per_rank, d)
            for (streams, t), d in zip(inputs, mesh)]
    fin = torch.cat([f.to(device) for f, _ in outs], dim=0)[:M]
    carry = tuple(torch.cat([c[i].to(device) for _, c in outs], dim=0)[:M]
                  for i in range(len(outs[0][1])))
    return fin, carry


def sharded_fused_scan_batch(issue, meta, boundary, timing, n_banks: int,
                             banks_per_rank: int,
                             mesh: Sequence[torch.device], device):
    """Case-sharded :func:`~repro_torch.core.vectorized.fused_scan_batch`
    on M stacked programs (``issue``/``meta`` ``[M, S, C, K]``,
    ``boundary[M, S]``, ``timing[M, 7]``; host arrays or tensors): shard k
    of the case batch is served on ``mesh[k]``.  Returns ``(finish[M, S,
    C, K], lean carries)`` on ``device``, bit-identical to the unsharded
    serve for any mesh."""
    def streams_for(lo, hi, d):
        return tuple(vec.as_int32(_shard_rows(a, lo, hi, len(timing)), d)
                     for a in (issue, meta, boundary))
    return _serve_shards(streams_for, timing, n_banks, banks_per_rank,
                         mesh, device)


def sharded_fused_scan_batch_shared(issue, meta, boundary, timing,
                                    n_banks: int, banks_per_rank: int,
                                    mesh: Sequence[torch.device], device):
    """Case-sharded shared-program variant: ONE program (``[S, C, K]``,
    ``boundary[S]``) served against a sharded batch of timing vectors
    (``[M, 7]``).  The program is copied once per distinct device of the
    mesh, never once per case.  Returns as
    :func:`sharded_fused_scan_batch`."""
    copies = {}

    def streams_for(lo, hi, d):
        if d not in copies:
            copies[d] = tuple(vec.as_int32(a, d)
                              for a in (issue, meta, boundary))
        return copies[d]
    return _serve_shards(streams_for, timing, n_banks, banks_per_rank,
                         mesh, device)

