"""SpMV in ELL layout: the kernel wrapper and the packers.

``spmv_ell(cols, vals, x)`` gives ``y[r] = sum_k vals[r, k] *
x[cols[r, k]]``; column ids outside ``[0, len(x))`` are padding and add
0.  For CUDA tensors it launches ``csrc/spmv_ell.cu``; for CPU tensors it
runs the plain version :func:`~.ref.spmv_ell_ref`.  No fallback: a CUDA
tensor goes to the kernel or the call raises.  ``spmv_ell.launches``
counts kernel launches.

Two packers build its inputs on the host: :func:`csr_to_ell`, the JAX
package's CSR -> one ELL of width k, and :func:`pack_in_edges`, the
in-edges of every destination in ELL buckets by in-degree, which the
vertex-centric engine's PR/SpMV pull runs one launch a bucket.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.formats import CSR
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref


def csr_to_ell(csr: CSR, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a CSR matrix to ELL ``(cols int32[n, k], vals float32[n,
    k])``, padding id ``n`` with value 0; ``k`` defaults to the largest
    degree.  A row longer than ``k`` keeps its *first* ``k`` entries, as
    the JAX package's packer does (its docstring says the k largest)."""
    deg = csr.degrees()
    k = int(deg.max()) if k is None else k
    n = csr.n
    cols = np.full((n, k), n, dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float32)
    w = (csr.weights if csr.weights is not None
         else np.ones(csr.m, dtype=np.float32))
    row = np.repeat(np.arange(n), deg)
    slot = np.arange(csr.m) - csr.pointers[row]
    keep = slot < k
    cols[row[keep], slot[keep]] = csr.neighbors[keep]
    vals[row[keep], slot[keep]] = w[keep]
    return cols, vals


@dataclasses.dataclass
class EllBucket:
    """The rows of one ELL width: ``y[rows] = spmv_ell(cols, vals, x)``."""

    rows: np.ndarray            # int64[r], destination ids, ascending
    cols: np.ndarray            # int32[r, k], padding id n
    vals: np.ndarray            # float32[r, k], padding 0


def pack_in_edges(src: np.ndarray, dst: np.ndarray, n: int,
                  weights: np.ndarray) -> List[EllBucket]:
    """The in-edges ``src -> dst`` (weight ``weights``) of every
    destination as ELL rows ``y[dst] = sum w * x[src]``, grouped into
    buckets by in-degree rounded up to a power of two, so that a skewed
    graph pads each row to at most twice its degree.  A row keeps its
    edges in edge-list order; a vertex with no in-edge is in no bucket.
    Buckets come narrowest first."""
    order = np.argsort(dst, kind="stable")
    dst_s = dst[order]
    src_s = src[order].astype(np.int32)
    w_s = np.asarray(weights)[order].astype(np.float32)
    deg = np.bincount(dst, minlength=n)
    start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=start[1:])
    slot = np.arange(len(dst_s)) - start[dst_s]
    # the power of two >= deg: 2 ** bit_length(deg - 1), 0 for deg 0
    width = np.where(deg > 0, np.left_shift(
        1, np.frexp(np.maximum(deg - 1, 0))[1]), 0).astype(np.int64)
    edge_width = width[dst_s]
    rank = np.zeros(n, dtype=np.int64)
    buckets = []
    for k in np.unique(width[deg > 0]):
        rows = np.flatnonzero(width == k)
        rank[rows] = np.arange(len(rows))
        sel = edge_width == k
        r, s = rank[dst_s[sel]], slot[sel]
        cols = np.full((len(rows), int(k)), n, dtype=np.int32)
        vals = np.zeros((len(rows), int(k)), dtype=np.float32)
        cols[r, s] = src_s[sel]
        vals[r, s] = w_s[sel]
        buckets.append(EllBucket(rows, cols, vals))
    return buckets


def _check(cols, vals, x) -> None:
    for t in (cols, vals, x):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError("spmv_ell takes contiguous tensors")
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"vals and x must be float32, got {vals.dtype} "
                        f"and {x.dtype}")
    if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
        raise ValueError(f"cols and vals must be [n, k] and x [nx], got "
                         f"{tuple(cols.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(x.shape)}")
    if x.shape[0] >= 2**31 or cols.shape[1] >= 2**31:
        raise ValueError("len(x) and k must lie in the int32 range")


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """cols int32[n, k], vals float32[n, k], x float32[nx] -> y
    float32[n]."""
    _check(cols, vals, x)
    if x.device.type == "cpu":
        return spmv_ell_ref(cols, vals, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmv_ell runs on CUDA or CPU, not {x.device}")
    lib = library()
    n, k = cols.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_spmv_ell(cols.data_ptr(), vals.data_ptr(),
                                  x.data_ptr(), y.data_ptr(), n, k,
                                  x.shape[0], stream)
    check_launch(code, "spmv_ell")
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
