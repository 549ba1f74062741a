"""Pareto-front reduction over evaluated design points.

Objectives (all minimized, in this order):

* ``runtime_ns``    — the cycle-accurate simulated runtime (device
  cycles over the device clock, so points on different memory devices
  compare honestly);
* ``dram_requests`` — line requests that reached DRAM after on-chip
  filtering (the paper's memory-access-pattern cost);
* ``bram_bytes``    — on-chip budget spent: the case's cache capacity
  plus its stream-prefetch buffering.

The front is a pure function of the evaluated ``(key -> objectives)``
mapping: computed set-wise and returned sorted by (objective vector,
key), so it is invariant to evaluation order, worker count, and
insertion order — and bit-identical across runs at one seed because the
sweep rows themselves are.
Points with identical vectors are all kept (they are genuinely
exchangeable designs); a point is dropped only when some other point is
at least as good everywhere and strictly better somewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

from repro_torch.sim.memory import resolve_cache
from repro_torch.sim.registry import get_accelerator
from repro_torch.sim.sweep import SweepRow

#: objective names, minimized, in canonical vector order
OBJECTIVES = ("runtime_ns", "dram_requests", "bram_bytes")

#: bytes of stream-buffer storage per prefetch slot (one cache line)
_PREFETCH_SLOT_BYTES = 64


def bram_bytes_of(row: SweepRow) -> int:
    """On-chip bytes the case's hierarchy occupies (0 for cache-free
    points): LRU capacity + prefetch stream-buffer slots."""
    spec = get_accelerator(row.case.accelerator)
    cache = resolve_cache(row.case.cache, spec)
    if cache is None:
        return 0
    return (cache.capacity_bytes
            + cache.prefetch_degree * _PREFETCH_SLOT_BYTES)


def objectives_of(row: SweepRow) -> Tuple[float, float, float]:
    """The canonical minimized objective vector of one evaluated row."""
    return (float(row.report.runtime_ns),
            float(row.report.total_requests),
            float(bram_bytes_of(row)))


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when ``a`` is at least as good as ``b`` in every objective
    and strictly better in at least one."""
    if len(a) != len(b):
        raise ValueError(f"objective arity mismatch: {a} vs {b}")
    return (all(x <= y for x, y in zip(a, b))
            and any(x < y for x, y in zip(a, b)))


def pareto_front(vectors: Mapping[str, Sequence[float]]) -> List[str]:
    """Keys of the non-dominated entries of ``vectors``, sorted by
    (objective vector, key).  Order-invariant: any permutation of the
    mapping yields the same list."""
    items = sorted(((tuple(v), k) for k, v in vectors.items()))
    front: List[Tuple[Tuple[float, ...], str]] = []
    for vec, key in items:
        if any(dominates(fv, vec) for fv, _ in front):
            continue
        # sorted order means nothing later can dominate an accepted
        # entry with a strictly smaller first objective, but equal-first
        # entries can still be dominated by an earlier one — the filter
        # above handles both because every potential dominator of `vec`
        # sorts before it.
        front.append((vec, key))
    return [k for _, k in front]


@dataclasses.dataclass(frozen=True)
class FrontEntry:
    """One Pareto-optimal design for a scenario."""

    key: str                              # DesignPoint.key
    objectives: Tuple[float, ...]         # OBJECTIVES order
    row: SweepRow = dataclasses.field(compare=False)

    # ``row`` is outside the identity: evidence payload — front identity is
    # (key, objectives); the backing row carries reports that never shape
    # membership

    def as_dict(self) -> Dict[str, float]:
        d = dict(zip(OBJECTIVES, self.objectives))
        d["config"] = self.key
        return d


def front_of_rows(rows: Mapping[str, SweepRow]) -> List[FrontEntry]:
    """Reduce evaluated rows (design-point key -> row) to the sorted
    Pareto front."""
    vectors = {k: objectives_of(r) for k, r in rows.items()}
    return [FrontEntry(key=k, objectives=tuple(vectors[k]), row=rows[k])
            for k in pareto_front(vectors)]
