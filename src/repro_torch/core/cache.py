"""On-chip cache-hierarchy model: BRAM vertex caches + stream prefetchers.

The hierarchy is an explicit simulation layer between the emitted request
program and the DRAM model:

    trace model -> SegmentedTrace -> [cache filter] -> pack -> fused serve

* A :class:`CacheConfig` describes a set-associative **vertex cache**
  (LRU per set; a line maps to set ``line % sets``) plus an optional
  **sequential stream prefetcher**.  It hangs off
  :class:`~repro_torch.core.dram.DRAMConfig.cache`.
* The **cache** drops read requests that hit on chip *before packing*.
  Writes bypass it (the traced writes are the accelerators' explicit DRAM
  write-backs).
* The **prefetcher** shapes the post-cache miss stream: within a phase,
  reads of consecutive lines form runs, and a run's requests beyond its
  head may be fetched up to ``degree`` requests ahead of demand (their
  issue lower bound moves back to the triggering demand's).  Addresses
  and program order are untouched, so a prefetched program never takes
  longer than the unprefetched one.

Both halves depend only on line addresses, program order and the
timing-independent issue bounds.  The lookup state (:class:`CacheState`)
lives on a device; :func:`lookup_reads` serves a read stream through it
with the hand-written kernel ``repro_torch.kernels.cache_lookup`` on the
card (one warp a touched set) or its plain version on the CPU, and
:func:`filter_program` looks up a whole program's reads in one call: the
sets are independent, and the state carries across phases in program
order, so that equals the JAX package's phase-by-phase lookups.  The lookup
always runs where the state lives.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.trace import SegmentedTrace, Trace


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """One level of on-chip hierarchy in front of a DRAM device.

    ``lines``  capacity in 64 B cache lines (0 = no cache); ``sets`` =
               ``lines // ways``; a line maps to set ``line % sets``.
    ``ways``   associativity (1 = direct-mapped), LRU replacement.
    ``prefetch_degree``  sequential stream-buffer depth: reads covered by
               an ongoing consecutive-line run are issued up to this many
               requests ahead of demand (0 = off).

    ``lines=0, prefetch_degree=0`` is the identity.
    """

    lines: int = 0
    ways: int = 1
    prefetch_degree: int = 0
    #: display only — excluded from eq/hash so same-geometry configs
    #: under different names compare equal
    name: str = dataclasses.field(default="", compare=False)

    def __post_init__(self) -> None:
        if self.lines < 0 or self.ways < 1 or self.prefetch_degree < 0:
            raise ValueError(f"invalid cache geometry: {self}")
        if self.lines % self.ways:
            raise ValueError(
                f"cache lines ({self.lines}) must divide evenly into "
                f"ways ({self.ways})")

    @property
    def sets(self) -> int:
        return self.lines // self.ways

    @property
    def capacity_bytes(self) -> int:
        return self.lines * 64

    @property
    def enabled(self) -> bool:
        return self.lines > 0 or self.prefetch_degree > 0

    def display_name(self) -> str:
        if self.name:
            return self.name
        if not self.enabled:
            return "none"
        parts = []
        if self.lines:
            parts.append(f"{self.capacity_bytes // 1024}KiB/{self.ways}w")
        if self.prefetch_degree:
            parts.append(f"pf{self.prefetch_degree}")
        return "+".join(parts)


@dataclasses.dataclass
class CacheStats:
    """Accumulated hierarchy statistics of one filtered stream."""

    lookups: int = 0        # read requests that probed the cache
    hits: int = 0           # reads served on chip (dropped before DRAM)
    prefetch_hits: int = 0  # reads covered by the stream buffer

    def merge(self, other: "CacheStats") -> None:
        self.lookups += other.lookups
        self.hits += other.hits
        self.prefetch_hits += other.prefetch_hits

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)


@dataclasses.dataclass
class CacheState:
    """Mutable lookup state on one device: per-set tags (-1 = invalid) and
    LRU ages (a permutation of ``0..ways-1`` per set; 0 = most recent, the
    way with the largest age is the victim — untouched ways keep the
    largest ages, so empty ways fill before a valid line is evicted)."""

    tags: torch.Tensor      # int64[sets, ways]
    age: torch.Tensor       # int64[sets, ways]


def effective(cache: Optional[CacheConfig]) -> Optional[CacheConfig]:
    """Normalize a cache selection: a disabled config means "no cache"."""
    return cache if cache is not None and cache.enabled else None


def init_state(cache: Optional[CacheConfig],
               device=None) -> Optional[CacheState]:
    """A cold state on ``device`` (default the card), or ``None`` when
    the level has no sets."""
    if cache is None or cache.sets == 0:
        return None
    device = resolve_device(device)
    S, W = cache.sets, cache.ways
    return CacheState(
        tags=torch.full((S, W), -1, dtype=torch.int64, device=device),
        age=torch.arange(W, dtype=torch.int64, device=device).repeat(S, 1))


def invalidate_lines(state: Optional[CacheState],
                     cache: Optional[CacheConfig], line_ranges) -> int:
    """Drop every cached line inside any ``(first_line, n_lines)`` range —
    the dynamic-update hook: lines of regions the host rewrote are stale
    and must miss on next access; every other line keeps its residency.

    Invalidated ways become the oldest in their set (they refill before
    any surviving line is evicted); surviving ways keep their relative
    recency, so ages stay a per-set permutation.  Runs where the state
    lives; returns the number of lines dropped."""
    if state is None or cache is None or not cache.sets:
        return 0
    ranges = [(int(f), int(f) + int(c)) for f, c in line_ranges if c > 0]
    if not ranges:
        return 0
    dev = state.tags.device
    sets, W = state.tags.shape
    lines = state.tags * sets + torch.arange(sets, dtype=torch.int64,
                                             device=dev)[:, None]
    # a line lies in some range iff, among the ranges starting at or below
    # it, the furthest end lies past it
    ranges.sort()
    first = torch.tensor([f for f, _ in ranges], dtype=torch.int64,
                         device=dev)
    end = torch.cummax(torch.tensor([e for _, e in ranges],
                                    dtype=torch.int64, device=dev), 0).values
    k = torch.searchsorted(first, lines, right=True) - 1
    mask = (k >= 0) & (lines < end[k.clamp(min=0)]) & (state.tags >= 0)
    n = int(mask.sum())
    if n:
        state.tags[mask] = -1
        key = state.age + W * mask
        state.age = torch.argsort(torch.argsort(key, dim=1, stable=True),
                                  dim=1, stable=True)
    return n


def lookup_reads(state: CacheState, set_idx, tag) -> np.ndarray:
    """Serve a read stream (program order; ``set_idx`` and ``tag`` int
    arrays or tensors) through the cache; returns the per-request hit
    mask (host bool array) and updates ``state`` in place.

    The reads are sorted stably by set into one segment a touched set;
    only the touched sets' state rows are gathered, served and scattered
    back, so the cost is bounded by the reads, independent of the set
    count.  The lookup runs where the state lives: the kernel on the
    card, its plain version on the CPU."""
    n = len(set_idx)
    if n == 0:
        return np.zeros(0, dtype=bool)
    # looked up on the ops module at each call, as the other kernels'
    # callers do, so a caller can stand in for the wrapper
    from repro_torch.kernels.cache_lookup.ops import cache_lookup
    dev = state.tags.device
    set_t = torch.as_tensor(set_idx, device=dev).to(torch.int64)
    tag_t = torch.as_tensor(tag, device=dev).to(torch.int64)
    sets_sorted, order = torch.sort(set_t, stable=True)
    uniq, counts = torch.unique_consecutive(sets_sorted, return_counts=True)
    seg_ptr = torch.zeros(len(uniq) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=seg_ptr[1:])
    tags_sub = state.tags[uniq]
    age_sub = state.age[uniq]
    hit = cache_lookup(seg_ptr, tag_t[order].contiguous(),
                       order.to(torch.int32), tags_sub, age_sub)
    state.tags[uniq] = tags_sub
    state.age[uniq] = age_sub
    return hit.cpu().numpy()


def _prefetch_issue(line: np.ndarray, is_write: np.ndarray,
                    issue: np.ndarray, degree: int,
                    phase: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, int]:
    """Stream-buffer issue shaping: within each run of consecutive-line
    reads, request ``i`` of the run may be fetched when demand reaches
    request ``i - degree`` (clamped to the run head, and never later than
    its own demand), so its issue lower bound becomes ``min(issue[i],
    issue[max(i - degree, head)])``.  Writes are untouched.  A run never
    crosses a phase: ``phase`` (each request's phase id, ``None`` for one
    phase) breaks them.  Returns ``(new_issue, prefetch_hits)`` — a hit is
    any read covered by an ongoing run."""
    r = np.nonzero(~is_write)[0]
    if len(r) == 0 or degree <= 0:
        return issue, 0
    ln = line[r]
    start = np.empty(len(r), dtype=bool)
    start[0] = True
    np.not_equal(ln[1:], ln[:-1] + 1, out=start[1:])
    if phase is not None:
        ph = phase[r]
        start[1:] |= ph[1:] != ph[:-1]
    run_id = np.cumsum(start) - 1
    head = np.nonzero(start)[0][run_id]
    idx = np.arange(len(r), dtype=np.int64)
    src = np.maximum(idx - degree, head)
    out = issue.copy()
    out[r] = np.minimum(issue[r], issue[r[src]])
    return out, int((idx > head).sum())


def _filter_arrays(line, is_write, issue, phase, cache: CacheConfig,
                   state: Optional[CacheState]):
    """Requests through the hierarchy: cache drop, then prefetch shaping
    (runs broken at ``phase`` changes).  Returns ``(line, is_write, issue,
    phase, CacheStats)``."""
    stats = CacheStats()
    if cache.sets and len(line):
        r = np.nonzero(~is_write)[0]
        if len(r):
            lines_r = line[r]
            hit = lookup_reads(state, lines_r % cache.sets,
                               lines_r // cache.sets)
            stats.lookups = len(r)
            stats.hits = int(hit.sum())
            keep = np.ones(len(line), dtype=bool)
            keep[r[hit]] = False
            line, is_write, issue = line[keep], is_write[keep], issue[keep]
            phase = phase[keep] if phase is not None else None
    if cache.prefetch_degree and len(line):
        issue, stats.prefetch_hits = _prefetch_issue(
            line, is_write, issue, cache.prefetch_degree, phase)
    return line, is_write, issue, phase, stats


def filter_trace(trace: "Trace", cache: Optional[CacheConfig],
                 state: Optional[CacheState] = None, device=None):
    """Filter one phase trace; returns ``(trace, stats, state)`` (a state
    is created on ``device`` on first use and chained across calls)."""
    from repro_torch.core.trace import Trace
    if cache is None or not cache.enabled:
        return trace, CacheStats(), state
    if state is None:
        state = init_state(cache, device)
    line, wr, iss, _, stats = _filter_arrays(
        trace.line_addr, trace.is_write, trace.issue, None, cache, state)
    return Trace(line, wr, iss), stats, state


def filter_program(program: "SegmentedTrace",
                   cache: Optional[CacheConfig],
                   state: Optional[CacheState] = None, device=None):
    """Filter a whole multi-phase program with the cache state carried
    across phase barriers (the cache persists; prefetch runs never cross a
    barrier).  Equal to :func:`filter_trace` phase by phase.  Returns
    ``(program, stats, state)``; phases whose every request hits are
    dropped, as the backends drop empty phases."""
    from repro_torch.core.trace import SegmentedTrace
    if cache is None or not cache.enabled or len(program) == 0:
        return program, CacheStats(), state
    if state is None:
        state = init_state(cache, device)
    P = program.n_phases
    phase = np.repeat(np.arange(P, dtype=np.int64), np.diff(program.offsets))
    line, wr, iss, phase, stats = _filter_arrays(
        program.line_addr, program.is_write, program.issue, phase, cache,
        state)
    counts = np.bincount(phase, minlength=P)
    kept = counts > 0
    offsets = np.zeros(int(kept.sum()) + 1, dtype=np.int64)
    np.cumsum(counts[kept], out=offsets[1:])
    names = [name for name, k in zip(program.names, kept) if k]
    return SegmentedTrace(line, wr, iss, offsets, names), stats, state
