"""Scenario-scaled accelerator config policies.

A :class:`PartitionPolicy` is a declarative ``partition_elements`` value
that resolves against the graph it is simulated on:

* ``PartitionPolicy(count=16)`` — 16 partitions whatever the graph size
  (``q = ceil(n / 16)``);
* ``PartitionPolicy(q_full=1_024_000, n_full=4_847_571)`` — preserve the
  partition count a full-scale paper configuration implies when running
  a scaled stand-in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.graphs.formats import Graph


def scaled_q(q_full: int, n_full: int, n: int, floor: int = 256) -> int:
    """Partition size that preserves a full-scale configuration's
    partition COUNT on an ``n``-vertex stand-in, floored."""
    if q_full <= 0 or n_full <= 0:
        raise ValueError(
            f"scaled_q needs positive q_full/n_full, got "
            f"{q_full}/{n_full}")
    return max(int(q_full * n / n_full), floor)


@dataclasses.dataclass(frozen=True)
class PartitionPolicy:
    """A graph-relative ``partition_elements`` value: exactly one of
    ``count`` or ``q_full`` + ``n_full``; ``floor`` clamps the resolved
    size from below."""

    count: Optional[int] = None
    q_full: Optional[int] = None
    n_full: Optional[int] = None
    floor: int = 1

    def __post_init__(self) -> None:
        by_count = self.count is not None
        by_ref = self.q_full is not None or self.n_full is not None
        if by_count == by_ref:
            raise ValueError(
                "PartitionPolicy needs either count= or "
                "q_full=+n_full=, not both/neither")
        if by_count and self.count < 1:
            raise ValueError(f"partition count must be >= 1, "
                             f"got {self.count}")
        if by_ref and (self.q_full is None or self.n_full is None):
            raise ValueError(
                "the reference form needs both q_full and n_full")
        if self.floor < 1:
            raise ValueError(f"floor must be >= 1, got {self.floor}")

    def resolve(self, g: Graph) -> int:
        """The concrete ``partition_elements`` for graph ``g``."""
        if self.count is not None:
            return max(math.ceil(g.n / self.count), self.floor)
        return scaled_q(self.q_full, self.n_full, g.n, floor=self.floor)

    def label(self) -> str:
        """Stable display form (design-point keys, sweep rows)."""
        if self.count is not None:
            return f"parts{self.count}"
        return f"qfull{self.q_full}@{self.n_full}"


def resolve_partitioned_config(config, g: Graph):
    """Return ``config`` with any :class:`PartitionPolicy` sitting in its
    ``partition_elements`` field resolved against ``g`` (the identity
    for plain configs / configs without the field)."""
    if config is None:
        return None
    pe = getattr(config, "partition_elements", None)
    if isinstance(pe, PartitionPolicy):
        return dataclasses.replace(config,
                                   partition_elements=pe.resolve(g))
    return config
