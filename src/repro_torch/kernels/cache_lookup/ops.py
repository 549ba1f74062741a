"""LRU lookup of a read stream through a set-associative on-chip cache.

``cache_lookup(seg_ptr, tag, pos, tags, age)`` serves reads sorted
stably by set (CSR segments ``seg_ptr``, int64[U + 1]; each read's tag,
int64[N], and its program-order position, int32[N]) through the touched
sets' state rows (``tags``, ``age``: int64[U, W], updated in place) and
returns each read's hit flag, bool[N], in program order.  On the card it
is one launch of ``csrc/cache_lookup.cu``, counted in
``cache_lookup.launches``: a thread a set for up to 32 ways (the ways in
recency order in registers, the reads staged into shared memory by
asynchronous copies), a warp a set above that and for the sets the
thread path hands over.  For CPU tensors the plain version
(:func:`~.ref.cache_lookup_ref`) runs.  No fallback: a CUDA tensor goes
to the kernel or the call raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref


def _check(seg_ptr, tag, pos, tags, age):
    want = {"seg_ptr": (seg_ptr, torch.int64, 1),
            "tag": (tag, torch.int64, 1), "pos": (pos, torch.int32, 1),
            "tags": (tags, torch.int64, 2), "age": (age, torch.int64, 2)}
    for name, (t, dtype, dim) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name} must be {dim}-D {dtype}, got "
                            f"{t.dim()}-D {t.dtype}")
        if t.device != tag.device:
            raise ValueError(f"tensors on {t.device} and {tag.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    U, W = tags.shape
    if tuple(age.shape) != (U, W):
        raise ValueError(f"age must be [{U}, {W}], got {tuple(age.shape)}")
    if seg_ptr.shape[0] != U + 1 or pos.shape[0] != tag.shape[0]:
        raise ValueError("seg_ptr must be [U + 1] and pos as long as tag")
    if W < 1:
        raise ValueError("a cache set has at least one way")


def cache_lookup(seg_ptr: torch.Tensor, tag: torch.Tensor,
                 pos: torch.Tensor, tags: torch.Tensor,
                 age: torch.Tensor) -> torch.Tensor:
    """Serve the reads through the cache; see the module docstring."""
    _check(seg_ptr, tag, pos, tags, age)
    if tag.device.type == "cpu":
        return cache_lookup_ref(seg_ptr, tag, pos, tags, age)
    if tag.device.type != "cuda":
        raise ValueError(f"cache_lookup runs on CUDA or CPU, not "
                         f"{tag.device}")
    hit = launch(seg_ptr, tag, pos, tags, age)
    count_launch(cache_lookup)
    return hit


def launch(seg_ptr, tag, pos, tags, age, warp: bool = False):
    """One launch of the kernel on checked CUDA tensors: the path that
    ``W`` picks, or with ``warp`` the warp path for every set (to time the
    two paths on one stream).  Counts nothing."""
    U, W = tags.shape
    lib = library()
    if W > lib.repro_cache_lookup_max_ways():
        raise ValueError(f"cache_lookup takes at most "
                         f"{lib.repro_cache_lookup_max_ways()} ways, got {W}")
    hit = torch.empty(tag.shape[0], dtype=torch.bool, device=tag.device)
    with torch.cuda.device(tag.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_cache_lookup(seg_ptr.data_ptr(), tag.data_ptr(),
                                      pos.data_ptr(), tags.data_ptr(),
                                      age.data_ptr(), hit.data_ptr(), U, W,
                                      tag.shape[0], int(warp), stream)
    check_launch(code, "cache_lookup")
    return hit


cache_lookup.launches = 0
