"""Delta-CSR trace builders for the dynamic-graph update path.

Applying an :class:`~repro_torch.graphs.updates.UpdateBatch` on the
device is a *structural* rewrite: every partition whose edge membership
changed gets its storage regions re-streamed by the host DMA engine (both
paper accelerators store an edge under its **source** partition —
HitGraph's dst-sorted per-partition edge lists, AccuGraph's
per-source-interval inverse-CSR blocks — so the rewritten set is the
source partitions of inserted and deleted edges).

The builders here emit that rewrite as one ``ep{e}_apply`` phase —
sequential, DRAM-bound line writes over only the touched partitions'
regions in the **new** model's layout — and expose the line ranges whose
on-chip copies the rewrite made stale, for
:func:`repro_torch.core.cache.invalidate_lines` (host DMA bypasses the
on-chip hierarchy, so exactly these lines must be dropped).

Duck-typed on the model attributes: HitGraph-shaped models expose
``edge_base`` / ``m_k``, AccuGraph-shaped models ``ptr_base`` /
``nbr_base`` / ``parts``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.dram import CACHE_LINE_BYTES
from repro_torch.core.trace import bulk_issue
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.updates import UpdateBatch


def structural_partitions(batch: UpdateBatch, g_before: Graph,
                          q: int, p: int) -> np.ndarray:
    """Source partitions whose edge storage the batch rewrites (edges
    live under their source partition in both modelled accelerators).
    Deleting compacts, inserting appends — either way the partition's
    whole region re-streams."""
    srcs = [np.asarray(batch.insert_src, dtype=np.int64)]
    if batch.n_deleted:
        srcs.append(g_before.src[batch.delete_idx])
    vs = np.concatenate(srcs)
    if not len(vs):
        return np.empty(0, dtype=np.int64)
    ks = np.unique(vs // max(int(q), 1))
    return ks[ks < p]


def delta_regions(model, touched: np.ndarray
                  ) -> List[Tuple[int, int]]:
    """``(byte_start, nbytes)`` of every storage region the rewrite of
    ``touched`` partitions re-streams, in the model's (new) layout."""
    regions: List[Tuple[int, int]] = []
    if hasattr(model, "edge_base"):                  # HitGraph-shaped
        eb = model.cfg.edge_bytes
        for k in touched:
            regions.append((int(model.edge_base[k]),
                            int(model.m_k[k]) * eb))
    elif hasattr(model, "nbr_base"):                 # AccuGraph-shaped
        pb = model.cfg.pointer_bytes
        nb = model.cfg.neighbor_bytes
        for k in touched:
            regions.append((int(model.ptr_base[k]),
                            (model.g.n + 1) * pb))
            regions.append((int(model.nbr_base[k]),
                            model.parts.blocks[int(k)].m * nb))
    else:
        raise TypeError(
            f"model {type(model).__name__} exposes neither an edge_base "
            "(HitGraph-shaped) nor an nbr_base (AccuGraph-shaped) "
            "layout; register a delta region map for it")
    return regions


def _all_regions(model):
    """Every named allocation of the model's layout(s):
    ``name -> (byte_start, nbytes)``."""
    if hasattr(model, "layouts"):                    # per-channel layouts
        out = {}
        for lay in model.layouts:
            out.update(lay.regions())
        return out
    return model.layout.regions()


def _to_line_range(byte0: int, nbytes: int):
    first = byte0 // CACHE_LINE_BYTES
    last = (byte0 + nbytes - 1) // CACHE_LINE_BYTES
    return (first, last - first + 1)


def stale_line_ranges(model_old, model_new,
                      touched: np.ndarray) -> List[Tuple[int, int]]:
    """Old-layout cache-line ranges whose on-chip residency is stale after
    an epoch's layout rebuild: regions of a touched partition, plus every
    region the rebuild moved or resized (region sizes track
    per-partition edge counts, so a touched partition shifts everything
    allocated after it on its channel).

    Invalidating the *old* ranges suffices: the allocator packs regions
    disjointly, so a new-layout range overlapping a surviving cached line
    belongs to a region that itself moved — which is in this set."""
    old = _all_regions(model_old)
    new = _all_regions(model_new)
    tset = {int(k) for k in np.asarray(touched).ravel()}
    ranges = []
    for name, (byte0, nbytes) in old.items():
        if nbytes <= 0:
            continue
        suffix = name.rsplit("_", 1)[-1]
        is_touched = suffix.isdigit() and int(suffix) in tset
        if is_touched or new.get(name) != (byte0, nbytes):
            ranges.append(_to_line_range(byte0, nbytes))
    return ranges


def delta_line_ranges(model, touched: np.ndarray
                      ) -> List[Tuple[int, int]]:
    """The same regions as ``(first_line, n_lines)`` cache-line ranges."""
    return [_to_line_range(byte0, nbytes)
            for byte0, nbytes in delta_regions(model, touched)
            if nbytes > 0]


def delta_phase(model, epoch: int, touched: np.ndarray):
    """The ``ep{epoch}_apply`` phase: sequential line writes over the
    touched partitions' regions (DRAM-bound streaming DMA — back-to-back
    issue lower bounds, like the models' prefetch streams).  Returns a
    ``(name, line, is_write, issue)`` phase tuple, or ``None`` when the
    batch touches nothing."""
    spans = [np.arange(first, first + n, dtype=np.int64)
             for first, n in delta_line_ranges(model, touched)]
    if not spans:
        return None
    lines = np.concatenate(spans)
    return (f"ep{epoch}_apply", lines,
            np.ones(len(lines), dtype=bool),
            bulk_issue(len(lines), 0))
