"""SpMV in ELL layouts: the kernel wrappers and the packers.

Two entry points launch the one kernel of ``csrc/spmv_ell.cu``:

- ``spmv_ell(cols, vals, x)``, the Pallas counterpart: ``y[r] = sum_k
  vals[r, k] * x[cols[r, k]]`` over one row-major ``[n, k]`` ELL;
- ``spmv_sell(a, x)``, the vertex-centric engine's pull: the whole ``y``
  of a :class:`SlicedEll` (see :func:`pack_in_edges`) in one launch.

Column ids outside ``[0, len(x))`` are padding and add 0.  For CUDA
tensors the wrappers launch the kernel; for CPU tensors they run the
plain versions :func:`~.ref.spmv_ell_ref` and :func:`~.ref.spmv_sell_ref`.
No fallback: a CUDA tensor goes to the kernel or the call raises.
``spmv_ell.launches`` counts the kernel's launches from either entry
point.

The packers: :func:`csr_to_ell`, the JAX package's CSR -> one ELL of
width k (host NumPy), and :func:`pack_in_edges`, the in-edges of every
destination as a :class:`SlicedEll`, in torch tensor ops on the run's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.formats import CSR
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.spmv_ell.ref import (SLICE_ROWS, spmv_ell_ref,
                                              spmv_sell_ref)

#: in-degree from which a row is heavy; a thread walks a light row alone,
#: so this bounds the longest slice (chip_smoke.py times the pull step at
#: 16 to 256: PERF.md)
HEAVY_SLOTS = 32
#: slots of a heavy row's chunk, one 256-thread block each
CHUNK_SLOTS = 4096


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
class SlicedEll:
    """Sliced ELL (SELL-32) of ``y[v] = sum w * x[u]`` over in-edges
    ``u -> v``, ``y`` of length ``n``.

    ``cols`` / ``vals`` hold the light slices, then the heavy rows.  Slice
    ``s`` covers slots ``[slice_ptr[s], slice_ptr[s + 1])``, column-major:
    slot ``j`` of its row ``r`` (``0 <= r < 32``, destination
    ``slice_rows[32 s + r]``, -1 for none) is ``slice_ptr[s] + 32 j + r``;
    padding slots hold column ``n`` and value 0.  Heavy chunk ``c`` is
    slots ``[chunk_ptr[c], chunk_ptr[c + 1])`` of row ``chunk_rows[c]``.
    """

    n: int
    cols: torch.Tensor          # int32[slots]
    vals: Optional[torch.Tensor]  # float32[slots]; None: sources only
    slice_ptr: torch.Tensor     # int64[slices + 1]
    slice_rows: torch.Tensor    # int32[32 slices]
    chunk_ptr: torch.Tensor     # int64[chunks + 1]
    chunk_rows: torch.Tensor    # int32[chunks]

    @property
    def n_slices(self) -> int:
        return self.slice_ptr.numel() - 1

    @property
    def n_chunks(self) -> int:
        return self.chunk_ptr.numel() - 1


def _exclusive_cumsum(t: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(t, 0) - t


def pack_in_edges(src, dst, n: int, weights, device=None,
                  heavy: int = HEAVY_SLOTS,
                  chunk: int = CHUNK_SLOTS) -> SlicedEll:
    """The in-edges ``src -> dst`` (weight ``weights``) of every
    destination as a :class:`SlicedEll`, built with torch tensor ops on
    ``device`` (default: ``dst``'s device if it is a tensor, else the
    CPU).  ``weights=None`` packs the sources alone (``vals`` None).

    Rows with at least one in-edge and fewer than ``heavy`` are light:
    sorted by in-degree, widest first (ties by id), cut into slices of 32
    rows, each padded to its widest row; a light row keeps its edges in
    edge-list order.  Rows of ``heavy`` in-edges or more follow, in id
    order, unpadded, cut into chunks of ``chunk`` slots; a heavy row's
    edges are sorted by source (stably), so that a block's neighbouring
    lanes gather neighbouring words of x where the row is dense.  A vertex
    with no in-edge is in no slice and no chunk.
    """
    if heavy < 1 or chunk < 1:
        raise ValueError(f"heavy and chunk must be >= 1, got {heavy}, "
                         f"{chunk}")
    if device is None:
        device = dst.device if isinstance(dst, torch.Tensor) else "cpu"
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device).long()
    w = (None if weights is None
         else torch.as_tensor(weights, device=device).float())
    m = dst.numel()
    # edges grouped by destination, edge-list order kept within a row,
    # then a heavy row's edges sorted by source
    dst_s, order = torch.sort(dst, stable=True)
    deg = torch.bincount(dst, minlength=n)
    on_heavy = torch.nonzero(deg[dst_s] >= heavy).flatten()
    key = dst_s[on_heavy] * n + src[order[on_heavy]].long()
    order[on_heavy] = order[on_heavy[torch.sort(key, stable=True)[1]]]
    src_s = src[order].int()
    row_start = _exclusive_cumsum(deg)
    slot = torch.arange(m, device=device) - row_start[dst_s]

    # light rows: widest first, 32 to a slice, column-major
    is_light = (deg > 0) & (deg < heavy)
    light = torch.nonzero(is_light).flatten()
    light = light[torch.sort(deg[light], descending=True, stable=True)[1]]
    n_slices = -(-light.numel() // SLICE_ROWS)
    rank = torch.full((n,), -1, dtype=torch.int64, device=device)
    rank[light] = torch.arange(light.numel(), device=device)
    slice_rows = torch.full((n_slices * SLICE_ROWS,), -1, dtype=torch.int32,
                            device=device)
    slice_rows[:light.numel()] = light.int()
    width = deg[light[::SLICE_ROWS]]
    slice_ptr = torch.cat([width.new_zeros(1),
                           torch.cumsum(width * SLICE_ROWS, 0)])
    light_slots = int(slice_ptr[-1])

    # heavy rows: id order, unpadded, after the slices
    heavy_rows = torch.nonzero(deg >= heavy).flatten()
    hdeg = deg[heavy_rows]
    hstart = torch.full((n,), -1, dtype=torch.int64, device=device)
    hstart[heavy_rows] = light_slots + _exclusive_cumsum(hdeg)
    n_chunks = torch.div(hdeg + chunk - 1, chunk, rounding_mode="floor")
    chunk_rows = torch.repeat_interleave(heavy_rows, n_chunks)
    first = torch.repeat_interleave(_exclusive_cumsum(n_chunks), n_chunks)
    chunk_ptr = torch.empty(chunk_rows.numel() + 1, dtype=torch.int64,
                            device=device)
    chunk_ptr[:-1] = (hstart[chunk_rows]
                      + (torch.arange(chunk_rows.numel(), device=device)
                         - first) * chunk)
    total = light_slots + int(hdeg.sum())
    chunk_ptr[-1] = total

    cols = torch.full((total,), n, dtype=torch.int32, device=device)
    r = rank[dst_s]
    on_slice = r >= 0
    r = r.clamp(min=0)
    pos = torch.where(
        on_slice,
        slice_ptr[torch.div(r, SLICE_ROWS, rounding_mode="floor")]
        + slot * SLICE_ROWS + r % SLICE_ROWS,
        hstart[dst_s] + slot)
    cols[pos] = src_s
    vals = None
    if w is not None:
        vals = torch.zeros(total, dtype=torch.float32, device=device)
        vals[pos] = w[order]
    return SlicedEll(n, cols, vals, slice_ptr, slice_rows, chunk_ptr,
                     chunk_rows.int())


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
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got {tuple(x.shape)}")
    if x.shape[0] >= 2**31:
        raise ValueError("len(x) must lie in the int32 range")


def _cuda_device(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU, not {x.device}")


def _launch(cols, vals, x, y, slice_ptr, slice_rows, n_slices, chunk_ptr,
            chunk_rows, n_chunks, k, what: str) -> None:
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_spmv_ell(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            slice_ptr, slice_rows, n_slices, chunk_ptr, chunk_rows,
            n_chunks, y.shape[0], k, x.shape[0], stream)
    check_launch(code, what)
    spmv_ell.launches += 1


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """cols int32[n, k], vals float32[n, k], x float32[nx] -> y
    float32[n]."""
    _check(cols, vals, x)
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"cols and vals must be [n, k], got "
                         f"{tuple(cols.shape)} and {tuple(vals.shape)}")
    if cols.shape[0] >= 2**31 or cols.shape[1] >= 2**31:
        raise ValueError("n and k must lie in the int32 range")
    if x.device.type == "cpu":
        return spmv_ell_ref(cols, vals, x)
    _cuda_device(x, "spmv_ell")
    n, k = cols.shape
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    _launch(cols, vals, x, y, None, None, -(-n // SLICE_ROWS), None, None,
            0, k, "spmv_ell")
    return y


def spmv_sell(a: SlicedEll, x: torch.Tensor) -> torch.Tensor:
    """The whole pull ``y float32[a.n]`` of a :class:`SlicedEll` and x
    float32[nx]: on the card one zeroing memset and one kernel launch."""
    _check(a.cols, a.vals, x)
    if a.vals.shape != a.cols.shape or a.cols.dim() != 1:
        raise ValueError("a sliced ELL holds 1-D cols and vals of one "
                         "length")
    for t, dtype in ((a.slice_ptr, torch.int64), (a.slice_rows, torch.int32),
                     (a.chunk_ptr, torch.int64), (a.chunk_rows, torch.int32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"a sliced ELL table must be contiguous "
                             f"{dtype} on {x.device}")
    if (a.slice_rows.numel() != SLICE_ROWS * a.n_slices
            or a.chunk_rows.numel() != a.n_chunks):
        raise ValueError("a sliced ELL needs 32 rows a slice and one row a "
                         "chunk")
    if not 0 <= a.n < 2**31 or a.n_chunks >= 2**31:
        raise ValueError("n and the chunk count must lie in the int32 "
                         "range")
    if x.device.type == "cpu":
        return spmv_sell_ref(a, x)
    _cuda_device(x, "spmv_sell")
    y = torch.empty(a.n, dtype=torch.float32, device=x.device)
    _launch(a.cols, a.vals, x, y, a.slice_ptr.data_ptr(),
            a.slice_rows.data_ptr(), a.n_slices, a.chunk_ptr.data_ptr(),
            a.chunk_rows.data_ptr(), a.n_chunks, 0, "spmv_sell")
    return y


spmv_ell.launches = 0
