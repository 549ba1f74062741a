"""Segment reduce by id: the kernel wrapper.

``segment_reduce(ids, values, num_segments, op)`` gives ``out[s, :]``,
the sum, min or max of ``values[i, :]`` over ``ids[i] == s`` (identity
for an empty segment, out-of-range ids ignored), in the values' dtype.
For CUDA tensors it launches ``csrc/segment_reduce.cu``; for CPU tensors
it runs the plain version :func:`~.ref.segment_reduce_ref`.  No
fallback: a CUDA tensor goes to the kernel or the call raises.
``segment_reduce.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref

OPS = {"sum": 0, "min": 1, "max": 2}
DTYPES = (torch.float32, torch.bfloat16)


def _check(ids, values, num_segments, op) -> int:
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    for t in (ids, values):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError("segment_reduce takes contiguous tensors")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids must be 1-D int32, got {ids.dtype} "
                        f"[{ids.dim()}-D]")
    if values.dtype not in DTYPES:
        raise TypeError(f"values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    if values.device != ids.device:
        raise ValueError(f"tensors on {values.device} and {ids.device}")
    if values.dim() not in (1, 2) or values.shape[0] != ids.shape[0]:
        raise ValueError(f"values must be [m] or [m, d] with m = "
                         f"{ids.shape[0]}, got {tuple(values.shape)}")
    d = 1 if values.dim() == 1 else values.shape[1]
    if d < 1:
        raise ValueError("values need at least one column")
    if not 0 <= num_segments * d < 2**31:
        raise ValueError(f"num_segments * d must lie in [0, 2**31), got "
                         f"{num_segments} * {d}")
    return d


def segment_reduce(ids: torch.Tensor, values: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """ids int32[m], values float32 or bfloat16 [m] or [m, d] ->
    [num_segments] or [num_segments, d] in the values' dtype."""
    d = _check(ids, values, num_segments, op)
    if values.device.type == "cpu":
        return segment_reduce_ref(ids, values, num_segments, op)
    if values.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on CUDA or CPU, not "
                         f"{values.device}")
    lib = library()
    shape = ((num_segments,) if values.dim() == 1
             else (num_segments, d))
    out = torch.empty(shape, dtype=values.dtype, device=values.device)
    bf16 = values.dtype == torch.bfloat16
    # sums accumulate in float64; bf16 min / max in float32
    scratch = (out if op != "sum" and not bf16 else torch.empty(
        shape, dtype=torch.float64 if op == "sum" else torch.float32,
        device=values.device))
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_segment_reduce(
            ids.data_ptr(), values.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), ids.shape[0], d, num_segments, OPS[op],
            int(bf16), stream)
    check_launch(code, "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
