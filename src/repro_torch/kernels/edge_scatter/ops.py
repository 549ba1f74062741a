"""HitGraph's scatter, one update per edge: the kernel wrapper.

``edge_scatter(src, weights, values, active, op)`` gives ``(upd,
valid)``: ``upd = values[src]`` (``"copy"``), ``+ weights`` (``"add"``)
or ``* weights`` (``"mul"``), and ``valid = active[src]``; a ``src``
outside ``[0, len(values))`` gathers 0.  For CUDA tensors it launches
``csrc/edge_scatter.cu``; for CPU tensors it runs the plain version
:func:`~.ref.edge_scatter_ref`.  No fallback: a CUDA tensor goes to the
kernel or the call raises.  ``edge_scatter.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.edge_scatter.ref import edge_scatter_ref

OPS = {"copy": 0, "add": 1, "mul": 2}


def _check(src, weights, values, active, op) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    for t in (src, weights, values, active):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        if t.dim() != 1:
            raise ValueError("edge_scatter takes 1-D tensors")
        if not t.is_contiguous():
            raise ValueError("edge_scatter takes contiguous tensors")
        if t.device != src.device:
            raise ValueError(f"tensors on {t.device} and {src.device}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    for name, t in (("weights", weights), ("values", values),
                    ("active", active)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if weights.shape != src.shape or active.shape != values.shape:
        raise ValueError("weights must match src, and active values, in "
                         "length")
    if values.shape[0] >= 2**31:
        raise ValueError("values longer than the int32 id range")


def edge_scatter(src: torch.Tensor, weights: torch.Tensor,
                 values: torch.Tensor, active: torch.Tensor,
                 op: str = "copy"):
    """src int32[m], weights float32[m], values and active float32[q] ->
    ``(upd float32[m], valid float32[m])``."""
    _check(src, weights, values, active, op)
    if src.device.type == "cpu":
        return edge_scatter_ref(src, weights, values, active, op)
    if src.device.type != "cuda":
        raise ValueError(f"edge_scatter runs on CUDA or CPU, not "
                         f"{src.device}")
    lib = library()
    upd = torch.empty_like(weights)
    valid = torch.empty_like(weights)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_edge_scatter(
            src.data_ptr(), weights.data_ptr(), values.data_ptr(),
            active.data_ptr(), upd.data_ptr(), valid.data_ptr(),
            src.shape[0], values.shape[0], OPS[op], stream)
    check_launch(code, "edge_scatter")
    count_launch(edge_scatter)
    return upd, valid


edge_scatter.launches = 0
