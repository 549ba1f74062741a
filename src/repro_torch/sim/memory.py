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
                                   AddressOrder, DRAMConfig, ddr3_1600k,
                                   ddr4_2400r, hbm2, hbm2e)
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
    """Stable display name for result rows."""
    if cache is None:
        return "none"
    if isinstance(cache, str):
        return cache
    return cache.display_name()
