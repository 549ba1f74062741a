"""On-chip cache-hierarchy configuration.

Only the configuration half of the JAX package's cache layer is ported so
far: :class:`CacheConfig` and :func:`effective`, which the memory
selection and :class:`~repro_torch.core.dram.DRAMConfig` carry.  The
filter that drops on-chip hits before packing comes with a later slice
(see ROADMAP.md); until then every entry point raises on an enabled
cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """One level of on-chip hierarchy in front of a DRAM device.

    ``lines``  capacity in 64 B cache lines (0 = no cache); ``sets`` =
               ``lines // ways``; a line maps to set ``line % sets``.
    ``ways``   associativity (1 = direct-mapped), LRU replacement.
    ``prefetch_degree``  sequential stream-buffer depth (0 = off).

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
    def enabled(self) -> bool:
        return self.lines > 0 or self.prefetch_degree > 0


def effective(cache: Optional[CacheConfig]) -> Optional[CacheConfig]:
    """Normalize a cache selection: a disabled config means "no cache"."""
    return cache if cache is not None and cache.enabled else None
