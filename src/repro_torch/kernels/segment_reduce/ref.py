"""Plain PyTorch version of the segment reduce.

``segment_reduce_ref(ids, values, num_segments, op)`` computes what the
CUDA kernel ``csrc/segment_reduce.cu`` and the JAX package's Pallas
kernel compute: ``out[s, :]`` is the sum, min or max of ``values[i, :]``
over ``ids[i] == s``, the identity (0, +inf, -inf) for an empty segment;
ids outside ``[0, num_segments)`` match no segment.  Sums accumulate in
float64 and min / max in float32, and the result is rounded once to the
values' dtype.
"""

from __future__ import annotations

import torch

IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def segment_reduce_ref(ids: torch.Tensor, values: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    squeeze = values.dim() == 1
    acc = torch.float64 if op == "sum" else torch.float32
    vals = (values[:, None] if squeeze else values).to(acc)
    keep = (ids >= 0) & (ids < num_segments)
    idx, vals = ids[keep].long(), vals[keep]
    out = torch.full((num_segments, vals.shape[1]), IDENTITY[op],
                     dtype=acc, device=values.device)
    if op == "sum":
        out.index_add_(0, idx, vals)
    else:
        out.scatter_reduce_(0, idx[:, None].expand_as(vals), vals,
                            "amin" if op == "min" else "amax")
    out = out.to(values.dtype)
    return out[:, 0] if squeeze else out
