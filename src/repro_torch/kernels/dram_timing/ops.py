"""Public wrapper of the blocked DRAM-serve kernel (``csrc/dram_serve.cu``).

``dram_serve`` checks its inputs, then launches the CUDA kernel for CUDA
tensors or runs the plain version (:func:`ref.dram_serve_ref`) for CPU
tensors.  There is no fallback: a CUDA tensor goes to the kernel or the
call raises.  ``dram_serve.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.vectorized import MAX_PHASE_ISSUE, NEG_INF32
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.dram_timing.ref import dram_serve_ref

State = Tuple[torch.Tensor, ...]


def _check(issue, meta, boundary, timing, state):
    tensors = (issue, meta, boundary, timing) + tuple(state)
    if len(state) != 6:
        raise ValueError(f"state must be the 6-tuple carry, got "
                         f"{len(state)} arrays")
    dev = issue.device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"dram_serve takes int32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("dram_serve takes contiguous tensors")
    if issue.dim() != 3:
        raise ValueError(f"issue must be [S, C, K], got {tuple(issue.shape)}")
    S, C, K = issue.shape
    avail, act, bus, hist, ptr, pmf = state
    if avail.dim() != 2 or hist.dim() != 3:
        raise ValueError("avail must be [C, B] and hist [C, R, 4]")
    B, R = avail.shape[1], hist.shape[1]
    want = {"meta": ((S, C, K), meta), "boundary": ((S,), boundary),
            "timing": ((7,), timing), "avail": ((C, B), avail),
            "act": ((C, B), act), "bus": ((C,), bus),
            "hist": ((C, R, 4), hist), "ptr": ((C, R), ptr),
            "pmf": ((C,), pmf)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if C < 1 or K < 1 or K > 32 or K & (K - 1):
        raise ValueError(f"need C >= 1 and K a power of two <= 32, got "
                         f"C={C}, K={K}")
    if C * K > 1024:
        raise ValueError(f"C*K = {C * K} lanes exceed one thread block")
    if R < 1 or B % R:
        raise ValueError(f"banks ({B}) must split evenly over ranks ({R})")
    # the kernel's int32 contract, as the packer asserts it: issues are
    # phase-relative and in range, and the carry holds reachable times
    if S and (int(issue.min()) < 0 or int(issue.max()) >= MAX_PHASE_ISSUE):
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    if any(int(x.min()) < NEG_INF32 for x in (avail, act, bus, hist, pmf)
           if x.numel()):
        raise ValueError("carry holds times below NEG_INF32")
    if ptr.numel() and (int(ptr.min()) < 0 or int(ptr.max()) > 3):
        raise ValueError("ACT-history pointers must lie in [0, 4)")
    return S, C, K, B, R


def dram_serve(issue: torch.Tensor, meta: torch.Tensor,
               boundary: torch.Tensor, timing: torch.Tensor,
               state: State):
    """Serve a blocked ``[S, C, K]`` program from ``state`` (the in-scan
    carry ``(avail[C,B], act[C,B], bus[C], hist[C,R,4], ptr[C,R],
    pmf[C])``), all int32; ``boundary[S]`` is nonzero on each phase's last
    step, ``timing`` the int32[7] vector (tCL, tRCD, tRP, tRAS, tBL, tRRD,
    tFAW).  Returns ``(finish[S, C, K], state)``, bit-identical to the JAX
    package's fused scan."""
    S, C, K, B, R = _check(issue, meta, boundary, timing, state)
    if issue.device.type == "cpu":
        return dram_serve_ref(issue, meta, boundary, timing, state)
    if issue.device.type != "cuda":
        raise ValueError(f"dram_serve runs on CUDA or CPU, not "
                         f"{issue.device}")
    lib = library()
    fin = torch.empty_like(issue)
    out = tuple(torch.empty_like(x) for x in state)
    with torch.cuda.device(issue.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_dram_serve(
            issue.data_ptr(), meta.data_ptr(), boundary.data_ptr(),
            timing.data_ptr(), *(x.data_ptr() for x in state),
            fin.data_ptr(), *(x.data_ptr() for x in out),
            S, C, K, B, R, B // R, stream)
    check_launch(code, "dram_serve")
    dram_serve.launches += 1
    return fin, out


dram_serve.launches = 0
