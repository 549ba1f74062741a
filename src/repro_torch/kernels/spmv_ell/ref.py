"""Plain PyTorch versions of the ELL SpMVs.

``spmv_ell_ref(cols, vals, x)`` computes what the CUDA kernel
``csrc/spmv_ell.cu`` and the JAX package's Pallas kernel compute on one
row-major ELL: ``y[r] = sum_k vals[r, k] * x[cols[r, k]]``, where a
column id outside ``[0, len(x))`` adds 0 whatever ``vals`` holds.

``spmv_sell_ref(a, x)`` computes the same sums over the slots of a
sliced ELL (:class:`~.ops.SlicedEll`): every slot's product is added onto
its row's ``y`` in float64 and rounded once; a row in no slice and no
chunk gets 0.
"""

from __future__ import annotations

import torch

#: rows of a slice: one warp on the card, one thread a row
SLICE_ROWS = 32


def _products(cols, vals, x):
    nx = x.shape[0]
    inside = (cols >= 0) & (cols < nx)
    xs = x if nx else x.new_zeros(1)
    g = xs[torch.where(inside, cols, 0).long()]
    return torch.where(inside, vals * g, vals.new_zeros(()))


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    return _products(cols, vals, x).sum(dim=1)


def spmv_sell_ref(a, x: torch.Tensor) -> torch.Tensor:
    # the row of every slot; a slot in no slice and no chunk adds nothing
    row = torch.full((a.cols.numel(),), -1, dtype=torch.int64,
                     device=a.cols.device)
    width = (a.slice_ptr[1:] - a.slice_ptr[:-1]) // SLICE_ROWS
    row[int(a.slice_ptr[0]):int(a.slice_ptr[-1])] = a.slice_rows.view(
        -1, SLICE_ROWS).repeat_interleave(width, dim=0).flatten()
    row[int(a.chunk_ptr[0]):int(a.chunk_ptr[-1])] = (
        a.chunk_rows.repeat_interleave(a.chunk_ptr[1:] - a.chunk_ptr[:-1]))
    keep = row >= 0
    y = torch.zeros(a.n, dtype=torch.float64, device=x.device)
    y.index_add_(0, row[keep],
                 _products(a.cols, a.vals, x)[keep].double())
    return y.float()
