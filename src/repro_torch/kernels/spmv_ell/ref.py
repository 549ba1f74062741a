"""Plain PyTorch version of the ELL SpMV.

``spmv_ell_ref(cols, vals, x)`` computes what the CUDA kernel
``csrc/spmv_ell.cu`` and the JAX package's Pallas kernel compute:
``y[r] = sum_k vals[r, k] * x[cols[r, k]]``, where a column id outside
``[0, len(x))`` adds 0 whatever ``vals`` holds.
"""

from __future__ import annotations

import torch


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    nx = x.shape[0]
    inside = (cols >= 0) & (cols < nx)
    xs = x if nx else x.new_zeros(1)
    g = xs[torch.where(inside, cols, 0).long()]
    return torch.where(inside, vals * g, vals.new_zeros(())).sum(dim=1)
