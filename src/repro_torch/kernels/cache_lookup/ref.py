"""Plain PyTorch version of the LRU cache lookup.

``cache_lookup_ref(seg_ptr, tag, pos, tags, age)`` computes what the CUDA
kernel ``csrc/cache_lookup.cu`` computes, by the column loop of the JAX
package's ``_lookup_numpy``: the reads of segment ``u`` (``seg_ptr[u] ..
seg_ptr[u + 1]``, program order) go through set ``u``'s state row
(``tags[u]``, ``age[u]``), one lockstep column of all sets at a time.
On a hit the ways younger than the hit way age by one and the hit way
becomes age 0; on a miss every way ages and the oldest (the first
largest age) takes the tag.  Returns ``hit[pos[i]]`` for each read ``i``
(program order); ``tags`` and ``age`` are updated in place.
"""

from __future__ import annotations

import torch


def cache_lookup_ref(seg_ptr: torch.Tensor, tag: torch.Tensor,
                     pos: torch.Tensor, tags: torch.Tensor,
                     age: torch.Tensor) -> torch.Tensor:
    U, W = tags.shape
    N = tag.shape[0]
    dev = tag.device
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    if N == 0 or U == 0:
        return hit
    counts = seg_ptr[1:] - seg_ptr[:-1]
    row = torch.repeat_interleave(torch.arange(U, device=dev), counts)
    slot = torch.arange(N, device=dev) - seg_ptr[row]
    L = int(counts.max())
    tag_m = torch.full((U, L), -1, dtype=torch.int64, device=dev)
    valid_m = torch.zeros((U, L), dtype=torch.bool, device=dev)
    tag_m[row, slot] = tag
    valid_m[row, slot] = True
    hit_m = torch.zeros((U, L), dtype=torch.bool, device=dev)
    rows = torch.arange(U, device=dev)
    for t in range(L):
        cur = tag_m[:, t]
        v = valid_m[:, t]
        match = (tags == cur[:, None]) & v[:, None]
        h = match.any(dim=1)
        hit_age = torch.where(match, age, -1).amax(dim=1)
        thresh = torch.where(h, hit_age, W)
        tgt = torch.where(h, match.to(torch.uint8).argmax(dim=1),
                          age.argmax(dim=1))
        age += (age < thresh[:, None]) & v[:, None]
        r = rows[v]
        age[r, tgt[r]] = 0
        tags[r, tgt[r]] = cur[r]
        hit_m[:, t] = h
    hit[pos.long()] = hit_m[row, slot]
    return hit
