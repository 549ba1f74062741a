"""DRAM device models: timing, organization, and address mapping.

Faithful to the paper's setup (Sect. 2.2, Tab. 2):

* HitGraph   -> DDR3, 4 channels, 2 ranks, speed grade 1600K, org 8Gb_x16
* AccuGraph  -> DDR4, 1 channel, 1 rank, speed grade 2400R, org 4Gb_x16
* Comparability -> DDR4, 1 channel, 1 rank, 2400R, 8Gb_x16
* HBM2/HBM2E -> the paper's "future work" DRAM types.

All requests are modelled at cache-line (64 B) granularity.  Timing
parameters are expressed in *memory-controller clock cycles* of the given
speed grade.  The address mapping follows the paper's Fig. 5: a physical
line address is split LSB-to-MSB according to a configurable component
order.  Host-side NumPy: the trace builders and the packer decode on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover — annotation only, no runtime dep
    from repro_torch.core.cache import CacheConfig

CACHE_LINE_BYTES = 64

AddressOrder = Tuple[str, ...]

DEFAULT_ORDER: AddressOrder = ("channel", "column", "rank", "bank", "row")

# Channel-as-MSB placement: each accelerator data structure lives whole in
# one channel (the paper's per-PE channel assignment).
CONTIGUOUS_ORDER: AddressOrder = ("column", "rank", "bank", "row", "channel")


@dataclasses.dataclass(frozen=True)
class DRAMTiming:
    """Timing parameters in memory-clock cycles.

    tCL   column (CAS) latency                  (row-buffer hit)
    tRCD  RAS-to-CAS delay                      (activate -> column cmd)
    tRP   precharge latency                     (row-buffer conflict)
    tRAS  minimum time between ACT and PRE of the same bank
    tBL   data-bus occupancy per request (burst length 8 at DDR -> 4 clocks)
    tRRD  ACT-to-ACT, different banks, same rank
    tFAW  four-activate window per rank
    """

    tCL: int
    tRCD: int
    tRP: int
    tRAS: int
    tBL: int
    tRRD: int = 6
    tFAW: int = 32


@dataclasses.dataclass(frozen=True)
class DRAMOrganization:
    """Component counts of one memory *channel* (per Fig. 4)."""

    ranks: int
    banks: int            # banks per rank (bank groups folded in)
    rows: int             # rows per bank
    row_bytes: int        # bytes per row across the rank (columns x width)

    @property
    def lines_per_row(self) -> int:
        return self.row_bytes // CACHE_LINE_BYTES


@dataclasses.dataclass(frozen=True)
class DRAMConfig:
    """A complete memory-system model: standard, speed, organization,
    addressing — plus the optional on-chip hierarchy level in front of
    the device (:class:`repro_torch.core.cache.CacheConfig`)."""

    name: str
    standard: str                     # DDR3 | DDR4 | HBM2 | HBM2E
    channels: int
    timing: DRAMTiming
    org: DRAMOrganization
    clock_ghz: float                  # memory-controller clock
    order: AddressOrder = DEFAULT_ORDER
    cache: Optional["CacheConfig"] = None

    @property
    def banks_per_channel(self) -> int:
        return self.org.ranks * self.org.banks

    @property
    def capacity_bytes(self) -> int:
        return (
            self.channels
            * self.org.ranks
            * self.org.banks
            * self.org.rows
            * self.org.row_bytes
        )

    @property
    def peak_gbps(self) -> float:
        """Peak data bandwidth in GB/s over all channels."""
        lines_per_cycle = 1.0 / self.timing.tBL
        return (
            self.channels * lines_per_cycle * CACHE_LINE_BYTES * self.clock_ghz
        )

    def component_sizes(self) -> Dict[str, int]:
        return {
            "channel": self.channels,
            "column": self.org.lines_per_row,
            "rank": self.org.ranks,
            "bank": self.org.banks,
            "row": self.org.rows,
        }

    @property
    def effective_cache(self) -> Optional["CacheConfig"]:
        """The on-chip level actually in force (a disabled config counts
        as none)."""
        c = self.cache
        return c if c is not None and c.enabled else None

    @property
    def structure_key(self):
        """The DRAM structure alone — channels, organization, address
        order: all that *trace emission* depends on."""
        return (self.channels, self.org, self.order)

    @property
    def geometry_key(self):
        """Everything request *packing* depends on — the structure and the
        on-chip cache level (cache hits are dropped before packing) — and
        nothing it does not (timing parameters, the clock)."""
        return (self.channels, self.org, self.order, self.cache)

    def decode_spec(self):
        """``((comp, shift, mask), ...)`` in address order for the pow2
        shift/mask decode the device pack runs; ``None`` when a component
        size is not a power of two (the host packer serves those)."""
        sizes = self.component_sizes()
        if any(s & (s - 1) for s in sizes.values()):
            return None
        spec = []
        shift = 0
        for comp in self.order:
            size = sizes[comp]
            spec.append((comp, shift, size - 1))
            shift += size.bit_length() - 1
        return tuple(spec)

    # ---- address mapping (Fig. 5) ------------------------------------
    def decode_lines(self, line_addrs: np.ndarray) -> Dict[str, np.ndarray]:
        """Split line addresses into DRAM components per the address order.

        Returns a dict with ``channel``, ``rank``, ``bank``, ``row``,
        ``column`` arrays plus ``bank_in_channel`` (rank*banks + bank) and
        ``bank_global``.
        """
        rem = np.asarray(line_addrs, dtype=np.int64)
        sizes = self.component_sizes()
        comps: Dict[str, np.ndarray] = {}
        pow2 = all(s & (s - 1) == 0 for s in sizes.values())
        for comp in self.order:
            size = sizes[comp]
            if pow2:            # shift/mask fast path (all real devices)
                comps[comp] = rem & (size - 1)
                rem = rem >> size.bit_length() - 1
            else:
                comps[comp] = rem % size
                rem = rem // size
        # Addresses beyond capacity wrap into higher rows (documented
        # simplification; traces are expected to fit).
        comps["row"] = comps["row"] + rem * 0
        comps["bank_in_channel"] = (
            comps["rank"] * self.org.banks + comps["bank"]
        )
        comps["bank_global"] = (
            comps["channel"] * self.banks_per_channel
            + comps["bank_in_channel"]
        )
        return comps

    def line_decoder(self) -> Callable[[int], Tuple[int, int, int]]:
        """A scalar form of :meth:`decode_lines` for one line at a time:
        ``decode(line) -> (channel, bank_in_channel, row)`` in Python
        ints, equal to ``decode_lines`` on every int64 line (floor ``%``
        and ``//`` are the shift/mask decode on powers of two)."""
        sizes = self.component_sizes()
        order = [(comp, sizes[comp]) for comp in self.order]
        banks = self.org.banks

        def decode(line: int) -> Tuple[int, int, int]:
            rem = int(line)
            got = {}
            for comp, size in order:
                got[comp] = rem % size
                rem //= size
            return got["channel"], got["rank"] * banks + got["bank"], \
                got["row"]

        return decode


# ---------------------------------------------------------------------------
# Presets (Tab. 2 of the paper + HBM future-work configs)
# ---------------------------------------------------------------------------

def ddr3_1600k(channels: int = 4, ranks: int = 2) -> DRAMConfig:
    """DDR3-1600K (11-11-11), 8Gb x16 devices, 64-bit channel, 800 MHz."""
    return DRAMConfig(
        name=f"DDR3_1600K_{channels}ch",
        standard="DDR3",
        channels=channels,
        timing=DRAMTiming(tCL=11, tRCD=11, tRP=11, tRAS=28, tBL=4,
                          tRRD=6, tFAW=40),
        org=DRAMOrganization(ranks=ranks, banks=8, rows=65536, row_bytes=8192),
        clock_ghz=0.8,
    )


def ddr4_2400r(channels: int = 1, ranks: int = 1,
               density: str = "4Gb") -> DRAMConfig:
    """DDR4-2400R (16-16-16), x16 devices, 64-bit channel, 1200 MHz.

    4Gb_x16: 32768 rows/bank (AccuGraph); 8Gb_x16: 65536 (Comparability).
    16 banks = 4 bank groups x 4 (folded).
    """
    rows = {"4Gb": 32768, "8Gb": 65536}[density]
    return DRAMConfig(
        name=f"DDR4_2400R_{density}_{channels}ch",
        standard="DDR4",
        channels=channels,
        timing=DRAMTiming(tCL=16, tRCD=16, tRP=16, tRAS=32, tBL=4,
                          tRRD=7, tFAW=36),
        org=DRAMOrganization(ranks=ranks, banks=16, rows=rows, row_bytes=8192),
        clock_ghz=1.2,
    )


def hbm2(channels: int = 8) -> DRAMConfig:
    """HBM2, 8 legacy channels (128-bit each), 2 Gb/s per pin, 1 GHz."""
    return DRAMConfig(
        name=f"HBM2_{channels}ch",
        standard="HBM2",
        channels=channels,
        timing=DRAMTiming(tCL=14, tRCD=14, tRP=14, tRAS=34, tBL=2,
                          tRRD=2, tFAW=16),
        org=DRAMOrganization(ranks=1, banks=16, rows=16384, row_bytes=2048),
        clock_ghz=1.0,
    )


def hbm2e(channels: int = 16) -> DRAMConfig:
    """HBM2E-like stack: 16 pseudo-channels, 3.2 Gb/s/pin class."""
    return DRAMConfig(
        name=f"HBM2E_{channels}ch",
        standard="HBM2E",
        channels=channels,
        timing=DRAMTiming(tCL=18, tRCD=18, tRP=18, tRAS=42, tBL=2,
                          tRRD=3, tFAW=20),
        org=DRAMOrganization(ranks=1, banks=16, rows=32768, row_bytes=1024),
        clock_ghz=1.6,
    )


PRESETS = {
    "hitgraph": lambda: ddr3_1600k(channels=4, ranks=2),
    "accugraph": lambda: ddr4_2400r(channels=1, ranks=1, density="4Gb"),
    "comparability": lambda: ddr4_2400r(channels=1, ranks=1, density="8Gb"),
    "hbm2": hbm2,
    "hbm2e": hbm2e,
}


@dataclasses.dataclass
class MemoryLayout:
    """Sequential allocator of plain arrays, cache-line aligned ("data
    structures lie adjacent in memory as plain arrays", Sect. 3.1)."""

    base: int = 0
    _offsets: Dict[str, Tuple[int, int]] = dataclasses.field(
        default_factory=dict
    )
    _cursor: int = 0

    def __post_init__(self) -> None:
        self._cursor = self.base

    def allocate(self, name: str, nbytes: int) -> int:
        """Allocate ``nbytes`` for array ``name``; returns byte offset."""
        start = self._cursor
        self._offsets[name] = (start, nbytes)
        aligned = (nbytes + CACHE_LINE_BYTES - 1) // CACHE_LINE_BYTES
        self._cursor = start + aligned * CACHE_LINE_BYTES
        return start

    def regions(self) -> Dict[str, Tuple[int, int]]:
        """Every allocation as ``name -> (byte_start, nbytes)`` — what the
        dynamic path diffs to find the regions an epoch's rebuild moved."""
        return dict(self._offsets)

    @property
    def total_bytes(self) -> int:
        return self._cursor - self.base
