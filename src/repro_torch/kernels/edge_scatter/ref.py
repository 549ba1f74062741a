"""Plain PyTorch version of HitGraph's scatter.

``edge_scatter_ref(src, weights, values, active, op)`` computes what the
CUDA kernel ``csrc/edge_scatter.cu`` and the JAX package's Pallas kernel
compute: ``upd = values[src]``, then ``+ weights`` (``op="add"``) or
``* weights`` (``"mul"``), and ``valid = active[src]``.  A ``src``
outside ``[0, len(values))`` gathers 0 and gives ``valid`` 0, and the op
is still applied.
"""

from __future__ import annotations

import torch


def edge_scatter_ref(src: torch.Tensor, weights: torch.Tensor,
                     values: torch.Tensor, active: torch.Tensor,
                     op: str = "copy"):
    q = values.shape[0]
    inside = (src >= 0) & (src < q)
    safe = torch.where(inside, src, 0).long()
    zero = values.new_zeros(())
    vals = values if q else values.new_zeros(1)
    act = active if q else active.new_zeros(1)
    g = torch.where(inside, vals[safe], zero)
    if op == "add":
        upd = g + weights
    elif op == "mul":
        upd = g * weights
    else:
        upd = g
    return upd, torch.where(inside, act[safe], zero)
