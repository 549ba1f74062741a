"""Asynchronous min-relaxation sweep of one vertex-centric block.

``sweep_min(values, src, dst, add)`` relaxes every edge in edge order,
``values[dst] = min(values[dst], values[src] + add)``, in place, against
the current values (AccuGraph's on-chip accumulation).  For CUDA tensors
it launches the one-thread kernel of ``csrc/sweep_min.cu``; for CPU
tensors it runs the plain loop :func:`sweep_min_ref`.  No fallback: a
CUDA tensor goes to the kernel or the call raises.
``sweep_min.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check_launch, library


def _wrap32(x: int) -> int:
    """int32 two's-complement wrap, as the device arithmetic does."""
    return (x + 2**31) % 2**32 - 2**31


def sweep_min_ref(values: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, add: int) -> None:
    """The plain sequential sweep, one Python-loop iteration per edge."""
    vals = values.tolist()
    for s, d in zip(src.tolist(), dst.tolist()):
        vals[d] = min(vals[d], _wrap32(vals[s] + add))
    values.copy_(torch.tensor(vals, dtype=values.dtype))


def sweep_min(values: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              add: int) -> None:
    """Relax ``values`` (int32[n], updated in place) over the edges
    ``src -> dst`` (int32[m]) in order."""
    for t in (values, src, dst):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError("sweep_min takes 1-D int32 tensors")
        if not t.is_contiguous():
            raise ValueError("sweep_min takes contiguous tensors")
        if t.device != values.device:
            raise ValueError(f"tensors on {t.device} and {values.device}")
    if src.shape != dst.shape:
        raise ValueError("src and dst differ in length")
    n, m = values.shape[0], src.shape[0]
    if m and (int(torch.minimum(src.min(), dst.min())) < 0
              or int(torch.maximum(src.max(), dst.max())) >= n):
        raise ValueError("edge endpoints out of range")
    if values.device.type == "cpu":
        sweep_min_ref(values, src, dst, add)
        return
    if values.device.type != "cuda":
        raise ValueError(f"sweep_min runs on CUDA or CPU, not "
                         f"{values.device}")
    lib = library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_sweep_min(values.data_ptr(), src.data_ptr(),
                                   dst.data_ptr(), m, int(add), stream)
    check_launch(code, "sweep_min")
    sweep_min.launches += 1


sweep_min.launches = 0
