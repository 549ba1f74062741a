"""The DRAM device and its service timing, in plain Python over NumPy.

The configuration's ``memory`` block fixes the device: channels, ranks,
banks, rows, row bytes, the clock and the address order (the paper's
Fig. 5, least significant component first).  Requests are cache lines of
64 bytes.  Each channel serves its requests in program order, one at a
time, under the timing vector ``(tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW)``
in memory-clock cycles:

* a row hit issues its column command at ``max(issue, bank free)``;
* a closed bank activates at ``max(issue, bank free, rank floor)``, a
  bank with another row open precharges at ``max(issue, bank free,
  activate + tRAS)`` and activates ``tRP`` later (and not before the rank
  floor); the column command follows ``tRCD`` after the activate;
* the rank floor is ``tRRD`` after the rank's last activate and ``tFAW``
  after its fourth-last one;
* the data leave at ``max(column + tCL, bus free) + tBL``, and the bank
  takes its next column command ``tBL`` after this one.

A program is a list of phases separated by barriers: a phase starts when
every request of the one before it has finished, and the banks, ranks
and buses keep their state across the barrier.  ``carry_state=False``
forgets that state at every barrier, as a serve that restarts each phase
from cold banks would; that breaks one of the guarantees the
configuration states and serves as the comparison's control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

LINE_BYTES = 64
TIMING_FIELDS = ("tCL", "tRCD", "tRP", "tRAS", "tBL", "tRRD", "tFAW")
NEVER = -(1 << 40)


@dataclasses.dataclass(frozen=True)
class Device:
    channels: int
    ranks: int
    banks: int             # banks a rank
    rows: int              # rows a bank
    row_bytes: int
    clock_ghz: float
    order: tuple           # address components, least significant first

    @staticmethod
    def from_spec(memory: dict) -> "Device":
        return Device(int(memory["channels"]), int(memory["ranks"]),
                      int(memory["banks"]), int(memory["rows"]),
                      int(memory["row_bytes"]), float(memory["clock_ghz"]),
                      tuple(memory["order"]))

    @property
    def capacity_bytes(self) -> int:
        return (self.channels * self.ranks * self.banks * self.rows
                * self.row_bytes)

    @property
    def banks_per_channel(self) -> int:
        return self.ranks * self.banks

    def decode(self, lines: np.ndarray):
        """``(channel, bank within the channel, row)`` of each line."""
        sizes = {"channel": self.channels,
                 "column": self.row_bytes // LINE_BYTES,
                 "rank": self.ranks, "bank": self.banks, "row": self.rows}
        rem = np.asarray(lines, dtype=np.int64)
        comp = {}
        for name in self.order:
            comp[name] = rem % sizes[name]
            rem = rem // sizes[name]
        return (comp["channel"], comp["rank"] * self.banks + comp["bank"],
                comp["row"])


@dataclasses.dataclass
class PhaseResult:
    name: str
    requests: int
    start: int
    end: int
    hits: int
    conflicts: int


class Channel:
    """One channel's bank, rank and bus state, in absolute cycles."""

    def __init__(self, banks: int, banks_per_rank: int):
        ranks = banks // banks_per_rank
        self.banks_per_rank = banks_per_rank
        self.open_row = [-1] * banks
        self.act_time = [NEVER] * banks
        self.bank_free = [0] * banks
        self.act_hist = [[NEVER] * 4 for _ in range(ranks)]
        self.act_ptr = [0] * ranks
        self.last_act = [NEVER] * ranks
        self.bus_free = 0

    def serve(self, issue: Sequence[int], bank: Sequence[int],
              row: Sequence[int], timing: Dict[str, int]):
        """Serve a stream in order; returns ``(last finish, hits,
        conflicts)`` (the last finish is the largest: the bus orders
        them)."""
        tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (
            timing[f] for f in TIMING_FIELDS)
        per_rank = self.banks_per_rank
        open_row, act_time = self.open_row, self.act_time
        bank_free, act_hist = self.bank_free, self.act_hist
        act_ptr, last_act = self.act_ptr, self.last_act
        bus = self.bus_free
        hits = conflicts = 0
        # the hit path, most requests, takes the maximum of two by a
        # comparison: a call of max() costs as much again
        for t, b, r in zip(issue, bank, row):
            o = open_row[b]
            free = bank_free[b]
            if o == r:
                hits += 1
                col = t if t > free else free
            else:
                rank = b // per_rank
                hist = act_hist[rank]
                ptr = act_ptr[rank]
                floor = max(last_act[rank] + tRRD, hist[ptr] + tFAW)
                if o == -1:
                    act = max(t, free, floor)
                else:
                    conflicts += 1
                    pre = max(t, free, act_time[b] + tRAS)
                    act = max(pre + tRP, floor)
                col = act + tRCD
                act_time[b] = act
                open_row[b] = r
                hist[ptr] = act
                act_ptr[rank] = (ptr + 1) % 4
                last_act[rank] = act
            bank_free[b] = col + tBL
            data = col + tCL
            bus = (data if data > bus else bus) + tBL
        self.bus_free = bus
        return bus, hits, conflicts


@dataclasses.dataclass
class DecodedProgram:
    """A program's requests decoded once for every timing vector: for each
    phase, its name and for each channel the (issue, bank, row) arrays."""

    names: List[str]
    requests: List[int]
    streams: List[List[tuple]]   # [phase][channel] -> (issue, bank, row)


def decode_program(device: Device, phases) -> DecodedProgram:
    """``phases`` is a list of ``(name, line, issue)`` arrays in program
    order, phase-relative issue cycles; empty phases are dropped."""
    names, requests, streams = [], [], []
    for name, line, issue in phases:
        if len(line) == 0:
            continue
        ch, bank, row = device.decode(line)
        per_channel = []
        for c in range(device.channels):
            sel = ch == c
            per_channel.append(tuple(a[sel].astype(np.int32)
                                     for a in (issue, bank, row)))
        names.append(name)
        requests.append(len(line))
        streams.append(per_channel)
    return DecodedProgram(names, requests, streams)


def serve_program(device: Device, program: DecodedProgram,
                  timing: Dict[str, int],
                  carry_state: bool = True) -> List[PhaseResult]:
    """Serve every phase, the first from cold DRAM state, each starting
    at the end of the one before it.  ``carry_state=False`` starts every
    phase from cold state instead (open rows forgotten at each barrier)."""
    now = 0
    out = []
    for name, n_req, per_channel in zip(program.names, program.requests,
                                        program.streams):
        if not out or not carry_state:
            channels = [Channel(device.banks_per_channel, device.banks)
                        for _ in range(device.channels)]
            for chan in channels:
                chan.bus_free = now
        end, hits, conflicts = now, 0, 0
        for chan, (issue, bank, row) in zip(channels, per_channel):
            if len(issue) == 0:
                continue
            last, h, c = chan.serve((issue.astype(np.int64) + now).tolist(),
                                    bank.tolist(), row.tolist(), timing)
            end = max(end, last)
            hits += h
            conflicts += c
        out.append(PhaseResult(name, n_req, now, end, hits, conflicts))
        now = end
    return out
