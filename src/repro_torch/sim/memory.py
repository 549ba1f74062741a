"""Unified memory selection: one ``MemoryConfig`` covering DDR3 / DDR4 /
HBM2 / HBM2E, so any accelerator runs on any memory.

========================  ==================================================
name                      device
========================  ==================================================
``ddr3`` / ``ddr3-1600k`` DDR3-1600K, 4 channels, 2 ranks (HitGraph row)
``ddr4`` / ``ddr4-2400r`` DDR4-2400R, 1 channel, 4Gb x16 (AccuGraph row)
``ddr4-8gb``              DDR4-2400R, 8Gb x16 (comparability row)
``hbm2``                  HBM2, 8 legacy channels (paper §7 future work)
``hbm2e``                 HBM2E-class stack, 16 pseudo-channels
``tpu-hbm``               HBM2E-class stack of 16 line-interleaved channels
========================  ==================================================

``simulate(..., memory=...)`` accepts a name above, a ``MemoryConfig``,
or a raw :class:`DRAMConfig`; ``None`` keeps the accelerator's own paper
default.  ``simulate(..., cache=...)`` selects the on-chip hierarchy level
in front of the device: a :data:`CACHE_PRESETS` name, ``"default"`` (the
accelerator's declared paper hierarchy) or a :class:`CacheConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core.cache import CacheConfig, effective as _effective_cache
from repro_torch.core.dram import (CONTIGUOUS_ORDER, DEFAULT_ORDER,
                                   AddressOrder, DRAMConfig, DRAMTiming,
                                   ddr3_1600k, ddr4_2400r, hbm2, hbm2e)
from repro_torch.errors import UnknownPresetError

_KINDS = ("ddr3", "ddr4", "hbm2", "hbm2e")


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Declarative memory selection.

    ``interleaving`` picks the address-mapping component order (Fig. 5):
    ``"contiguous"`` places each data structure whole in one channel
    (channel = MSBs; both paper accelerators use this), ``"line"``
    stripes subsequent cache lines across channels (channel = LSBs).
    """

    kind: str = "ddr4"                   # ddr3 | ddr4 | hbm2 | hbm2e
    channels: Optional[int] = None       # None -> device default
    ranks: Optional[int] = None          # DDR only
    density: Optional[str] = None        # DDR4: "4Gb" | "8Gb"
    interleaving: str = "contiguous"     # "contiguous" | "line"
    cache: Optional[CacheConfig] = None  # on-chip hierarchy level

    def resolve(self) -> DRAMConfig:
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown memory kind {self.kind!r}; one of {_KINDS}")
        if self.kind == "ddr3":
            cfg = ddr3_1600k(channels=self.channels or 4,
                             ranks=self.ranks or 2)
        elif self.kind == "ddr4":
            cfg = ddr4_2400r(channels=self.channels or 1,
                             ranks=self.ranks or 1,
                             density=self.density or "4Gb")
        elif self.kind == "hbm2":
            cfg = hbm2(channels=self.channels or 8)
        else:
            cfg = hbm2e(channels=self.channels or 16)
        order: AddressOrder = (CONTIGUOUS_ORDER
                               if self.interleaving == "contiguous"
                               else DEFAULT_ORDER)
        return dataclasses.replace(cfg, order=order,
                                   cache=_effective_cache(self.cache))


MEMORY_PRESETS = {
    "ddr3": MemoryConfig(kind="ddr3"),
    "ddr3-1600k": MemoryConfig(kind="ddr3"),
    "ddr4": MemoryConfig(kind="ddr4"),
    "ddr4-2400r": MemoryConfig(kind="ddr4"),
    "ddr4-8gb": MemoryConfig(kind="ddr4", density="8Gb"),
    # the paper's §7 future-work devices; line interleaving so the stack's
    # channel parallelism is actually reachable
    "hbm2": MemoryConfig(kind="hbm2", interleaving="line"),
    "hbm2e": MemoryConfig(kind="hbm2e", interleaving="line"),
    "tpu-hbm": MemoryConfig(kind="hbm2e", channels=16,
                            interleaving="line"),
}

MemoryLike = Union[None, str, MemoryConfig, DRAMConfig]

#: standalone timing vectors for :func:`timing_variants` grids: JEDEC
#: speed grades beyond the full device presets above (cycle counts at the
#: grade's nominal data rate).  The serve takes timing as an input and
#: packing never reads it, so a grid of them shares one packed program
#: per geometry.  The follow-up comparison paper (arXiv:2104.07776) sweeps
#: this kind of speed-grade axis.
TIMING_PRESETS = {
    "ddr3-1066": DRAMTiming(tCL=7, tRCD=7, tRP=7, tRAS=20, tBL=4,
                            tRRD=4, tFAW=27),
    "ddr3-1333": DRAMTiming(tCL=9, tRCD=9, tRP=9, tRAS=24, tBL=4,
                            tRRD=5, tFAW=30),
    "ddr3-1866": DRAMTiming(tCL=13, tRCD=13, tRP=13, tRAS=32, tBL=4,
                            tRRD=6, tFAW=45),
    "ddr4-2133": DRAMTiming(tCL=14, tRCD=14, tRP=14, tRAS=28, tBL=4,
                            tRRD=6, tFAW=32),
    "ddr4-2666": DRAMTiming(tCL=18, tRCD=18, tRP=18, tRAS=35, tBL=4,
                            tRRD=8, tFAW=40),
    "ddr4-2933": DRAMTiming(tCL=21, tRCD=21, tRP=21, tRAS=39, tBL=4,
                            tRRD=8, tFAW=44),
    "ddr4-3200": DRAMTiming(tCL=22, tRCD=22, tRP=22, tRAS=42, tBL=4,
                            tRRD=9, tFAW=48),
    "hbm-1gbps": DRAMTiming(tCL=7, tRCD=7, tRP=7, tRAS=17, tBL=2,
                            tRRD=1, tFAW=8),
}


def timing_variants(base: MemoryLike, kinds=("ddr3", "ddr4", "hbm2")):
    """Timing-only memory grid: the base device's geometry and clock with
    each named preset's *timing vector* swapped in.

    Packing depends only on geometry, so a sweep over these devices packs
    each (graph, accelerator) point once and serves it against every
    timing vector; with ``batch_memories=True``, in one batched serve.
    ``base`` is any :func:`resolve_memory` selector naming the geometry
    (e.g. ``"ddr4-8gb"`` or an accelerator's default ``DRAMConfig``);
    ``kinds`` name either :data:`TIMING_PRESETS` entries or full device
    presets (whose timing is borrowed).  Returns one ``DRAMConfig`` per
    kind, named ``<base>@<kind>-timing``."""
    cfg = resolve_memory(base)
    if cfg is None:
        raise ValueError("timing_variants needs an explicit base device")
    out = []
    for kind in kinds:
        t = TIMING_PRESETS.get(kind)
        if t is None:
            t = resolve_memory(kind).timing
        out.append(dataclasses.replace(
            cfg, timing=t, name=f"{cfg.name}@{kind}-timing"))
    return out


def resolve_memory(memory: MemoryLike) -> Optional[DRAMConfig]:
    """Coerce any memory selector to a :class:`DRAMConfig` (or ``None``
    for "keep the accelerator's paper default")."""
    if memory is None:
        return None
    if isinstance(memory, DRAMConfig):
        return memory
    if isinstance(memory, MemoryConfig):
        return memory.resolve()
    if isinstance(memory, str):
        try:
            return MEMORY_PRESETS[memory.lower()].resolve()
        except KeyError:
            raise UnknownPresetError("memory", memory,
                                     MEMORY_PRESETS) from None
    raise TypeError(
        f"memory must be None, a preset name, MemoryConfig, or "
        f"DRAMConfig; got {type(memory).__name__}")


def memory_name(memory: MemoryLike) -> str:
    """Stable display name for sweep rows."""
    if memory is None:
        return "default"
    if isinstance(memory, str):
        return memory
    if isinstance(memory, MemoryConfig):
        return memory.kind
    return memory.name


# ---------------------------------------------------------------------------
# On-chip cache-hierarchy selection: named presets + per-spec paper
# defaults.
# ---------------------------------------------------------------------------

#: named on-chip hierarchy levels for ``cache=``.  ``vertex-*`` are
#: BRAM-class set-associative LRU vertex caches at FPGA on-chip budgets,
#: ``prefetch-*`` pure sequential stream prefetchers; both compose in one
#: ``CacheConfig``.  ``cache="default"`` selects the accelerator spec's
#: declared paper hierarchy (``AcceleratorSpec.default_cache()``).
CACHE_PRESETS = {
    "none": CacheConfig(name="none"),
    "vertex-64k": CacheConfig(lines=1024, ways=8, name="vertex-64k"),
    "vertex-256k": CacheConfig(lines=4096, ways=8, name="vertex-256k"),
    "vertex-1m": CacheConfig(lines=16384, ways=16, name="vertex-1m"),
    "vertex-2m": CacheConfig(lines=32768, ways=16, name="vertex-2m"),
    "direct-256k": CacheConfig(lines=4096, ways=1, name="direct-256k"),
    "prefetch-4": CacheConfig(prefetch_degree=4, name="prefetch-4"),
    "prefetch-8": CacheConfig(prefetch_degree=8, name="prefetch-8"),
    "vertex-1m+prefetch": CacheConfig(lines=16384, ways=16,
                                      prefetch_degree=8,
                                      name="vertex-1m+prefetch"),
}

CacheLike = Union[None, str, CacheConfig]


def resolve_cache(cache: CacheLike, spec=None) -> Optional[CacheConfig]:
    """Coerce a cache selector to a :class:`CacheConfig` (or ``None`` for
    "leave the memory point's cache as it is").

    ``"default"`` picks ``spec.default_cache()`` — the accelerator's
    declared paper hierarchy; a disabled config (``"none"`` /
    ``CacheConfig()``) explicitly strips any cache the memory point
    carries."""
    if cache is None:
        return None
    if isinstance(cache, CacheConfig):
        return cache
    if isinstance(cache, str):
        if cache == "default":
            if spec is None:
                raise ValueError(
                    'cache="default" needs an accelerator spec to read '
                    "the paper hierarchy from")
            return spec.default_cache() or CacheConfig(name="none")
        try:
            return CACHE_PRESETS[cache.lower()]
        except KeyError:
            raise UnknownPresetError(
                "cache", cache,
                list(CACHE_PRESETS) + ["default"]) from None
    raise TypeError(
        f"cache must be None, a preset name, 'default', or a "
        f"CacheConfig; got {type(cache).__name__}")


def cache_name(cache: CacheLike) -> str:
    """Stable display name for sweep rows."""
    if cache is None:
        return "none"
    if isinstance(cache, str):
        return cache
    return cache.display_name()


def cache_variants(kinds=("none", "vertex-64k", "vertex-256k",
                          "vertex-1m")):
    """A cache-size ladder for sweep ``caches=`` axes, by preset name (the
    hierarchy-layer analogue of :func:`timing_variants`): one
    ``CacheConfig`` per kind; ``"default"`` is per accelerator and passes
    through as the string."""
    return [kind if kind == "default" else resolve_cache(kind)
            for kind in kinds]
