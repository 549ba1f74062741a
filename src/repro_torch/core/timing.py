"""DRAM service-timing semantics: the element-granular oracle.

This module is the per-channel, in-order request service model in its
incremental form: scalar Python over int64 NumPy state, one request at a
time.  The event-driven backend (``sim/backends.py::EventDRAM``) and the
abstraction graph's DRAM endpoint (``core/abstractions.py``) serve through
it, and the ``dram_timing`` and ``dram_serve`` kernels must agree with it
bit for bit on integer cycle counts.

Model (one memory channel; requests served in stream order):

Per bank ``b`` we track the open row, the time of the last ACT, and the
earliest next column command (``bank_avail``).  A request to row ``r`` is:

* row hit      (open_row == r):  col = max(issue, bank_avail)
* row empty    (open_row == -1): act = max(issue, bank_avail);
                                 col = act + tRCD
* row conflict (other row open): pre = max(issue, bank_avail,
                                           act_time + tRAS);
                                 act = pre + tRP; col = act + tRCD

After the column command, data is ready at ``col + tCL`` and occupies the
shared channel data bus for ``tBL`` cycles: ``finish = max(col + tCL,
bus_free) + tBL``.  Back-to-back column commands to one bank are spaced by
``tCCD = tBL`` (``bank_avail = col + tBL``).

Activates are additionally rate-limited per *rank* (rank = bank //
banks_per_rank): ``act >= last_act_rank + tRRD`` and ``act >=
fourth_last_act_rank + tFAW`` (four-activate window).

Simplifications vs. Ramulator: writes share read timing (tCWL ~ tCL), no
refresh, no command-bus contention, FCFS per channel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig, DRAMTiming

ROW_HIT, ROW_EMPTY, ROW_CONFLICT = 0, 1, 2

# A value safely below any valid cycle but not overflow-prone.
NEG_INF = -(1 << 40)


@dataclasses.dataclass
class ChannelState:
    """Mutable per-channel timing state (incremental event-driven form).

    ``banks_per_rank`` defaults to ``n_banks`` (single rank).
    """

    timing: DRAMTiming
    n_banks: int
    banks_per_rank: int = 0
    open_row: np.ndarray = None          # int64[n_banks], -1 == empty
    act_time: np.ndarray = None          # int64[n_banks]
    bank_avail: np.ndarray = None        # int64[n_banks]
    bus_free: int = 0
    act_hist: np.ndarray = None          # int64[n_ranks, 4] circular
    act_ptr: np.ndarray = None           # int64[n_ranks]
    last_act_rank: np.ndarray = None     # int64[n_ranks]

    def __post_init__(self) -> None:
        if self.banks_per_rank == 0:
            self.banks_per_rank = self.n_banks
        n_ranks = self.n_banks // self.banks_per_rank
        if self.open_row is None:
            self.open_row = np.full(self.n_banks, -1, dtype=np.int64)
            self.act_time = np.full(self.n_banks, NEG_INF, dtype=np.int64)
            self.bank_avail = np.zeros(self.n_banks, dtype=np.int64)
            self.act_hist = np.full((n_ranks, 4), NEG_INF, dtype=np.int64)
            self.act_ptr = np.zeros(n_ranks, dtype=np.int64)
            self.last_act_rank = np.full(n_ranks, NEG_INF, dtype=np.int64)

    def _record_act(self, rank: int, act: int) -> None:
        ptr = self.act_ptr[rank]
        self.act_hist[rank, ptr] = act
        self.act_ptr[rank] = (ptr + 1) % 4
        self.last_act_rank[rank] = act

    def _act_floor(self, rank: int) -> int:
        """Earliest allowed next ACT on this rank (tRRD + tFAW)."""
        t = self.timing
        oldest = self.act_hist[rank, self.act_ptr[rank]]
        return max(self.last_act_rank[rank] + t.tRRD, oldest + t.tFAW)

    def serve(self, issue: int, bank: int, row: int) -> Tuple[int, int]:
        """Serve one request; returns (finish_cycle, row_kind)."""
        t = self.timing
        rank = bank // self.banks_per_rank
        if self.open_row[bank] == row:
            kind = ROW_HIT
            col = max(issue, self.bank_avail[bank])
        elif self.open_row[bank] == -1:
            kind = ROW_EMPTY
            act = max(issue, self.bank_avail[bank], self._act_floor(rank))
            col = act + t.tRCD
            self.act_time[bank] = act
            self.open_row[bank] = row
            self._record_act(rank, act)
        else:
            kind = ROW_CONFLICT
            pre = max(issue, self.bank_avail[bank],
                      self.act_time[bank] + t.tRAS)
            act = max(pre + t.tRP, self._act_floor(rank))
            col = act + t.tRCD
            self.act_time[bank] = act
            self.open_row[bank] = row
            self._record_act(rank, act)
        self.bank_avail[bank] = col + t.tBL
        finish = max(col + t.tCL, self.bus_free) + t.tBL
        self.bus_free = finish
        return int(finish), kind

    def serve_many(self, issue, bank, row) -> Tuple[List[int], List[int]]:
        """:meth:`serve` over a stream of requests (sequences of ints, in
        order); returns ``(finish, kind)`` lists.  The same arithmetic on
        the same state, read into Python ints for the stream and written
        back after it, so that a long stream does not pay for a NumPy
        scalar at every step."""
        t = self.timing
        tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (
            t.tCL, t.tRCD, t.tRP, t.tRAS, t.tBL, t.tRRD, t.tFAW)
        per_rank = self.banks_per_rank
        open_row = self.open_row.tolist()
        act_time = self.act_time.tolist()
        bank_avail = self.bank_avail.tolist()
        act_hist = self.act_hist.tolist()
        act_ptr = self.act_ptr.tolist()
        last_act = self.last_act_rank.tolist()
        bus_free = int(self.bus_free)
        finish: List[int] = []
        kinds: List[int] = []
        for iss, b, r in zip(issue, bank, row):
            o = open_row[b]
            if o == r:
                kind = ROW_HIT
                col = max(iss, bank_avail[b])
            else:
                rank = b // per_rank
                hist = act_hist[rank]
                ptr = act_ptr[rank]
                floor = max(last_act[rank] + tRRD, hist[ptr] + tFAW)
                if o == -1:
                    kind = ROW_EMPTY
                    act = max(iss, bank_avail[b], floor)
                else:
                    kind = ROW_CONFLICT
                    pre = max(iss, bank_avail[b], act_time[b] + tRAS)
                    act = max(pre + tRP, floor)
                col = act + tRCD
                act_time[b] = act
                open_row[b] = r
                hist[ptr] = act
                act_ptr[rank] = (ptr + 1) % 4
                last_act[rank] = act
            bank_avail[b] = col + tBL
            bus_free = max(col + tCL, bus_free) + tBL
            finish.append(bus_free)
            kinds.append(kind)
        self.open_row[:] = open_row
        self.act_time[:] = act_time
        self.bank_avail[:] = bank_avail
        self.act_hist[:] = act_hist
        self.act_ptr[:] = act_ptr
        self.last_act_rank[:] = last_act
        self.bus_free = bus_free
        return finish, kinds


def simulate_channel(
    issue: np.ndarray, bank: np.ndarray, row: np.ndarray, timing: DRAMTiming,
    n_banks: int, banks_per_rank: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference (python-loop) per-channel service. Returns (finish, kind)."""
    st = ChannelState(timing=timing, n_banks=n_banks,
                      banks_per_rank=banks_per_rank)
    n = len(issue)
    finish = np.zeros(n, dtype=np.int64)
    kind = np.zeros(n, dtype=np.int8)
    for i in range(n):
        finish[i], kind[i] = st.serve(int(issue[i]), int(bank[i]),
                                      int(row[i]))
    return finish, kind


@dataclasses.dataclass
class TraceResult:
    """Timing + statistics of one simulated trace."""

    cycles: int                      # makespan in memory-clock cycles
    ns: float
    total_requests: int
    total_bytes: int
    row_hits: int
    row_empty: int
    row_conflicts: int
    achieved_gbps: float
    peak_gbps: float
    per_channel_cycles: Dict[int, int]
    finish: np.ndarray | None = None

    @property
    def hit_rate(self) -> float:
        if self.total_requests == 0:
            return 0.0
        return self.row_hits / self.total_requests

    @property
    def bandwidth_fraction(self) -> float:
        if self.peak_gbps == 0:
            return 0.0
        return self.achieved_gbps / self.peak_gbps


def simulate_trace(
    line_addr: np.ndarray,
    issue: np.ndarray,
    cfg: DRAMConfig,
    keep_finish: bool = False,
) -> TraceResult:
    """Simulate a full trace (program order) on all channels of ``cfg``.

    ``line_addr`` are cache-line addresses; ``issue`` are issue-cycle lower
    bounds (memory clock).  Channels operate independently; the global
    makespan is the max over channels.
    """
    line_addr = np.asarray(line_addr, dtype=np.int64)
    issue = np.asarray(issue, dtype=np.int64)
    comps = cfg.decode_lines(line_addr)
    finish_all = np.zeros(len(line_addr), dtype=np.int64)
    hits = empt = conf = 0
    per_channel: Dict[int, int] = {}
    for c in range(cfg.channels):
        m = comps["channel"] == c
        if not m.any():
            per_channel[c] = 0
            continue
        fin, kind = simulate_channel(
            issue[m], comps["bank_in_channel"][m], comps["row"][m],
            cfg.timing, cfg.banks_per_channel, cfg.org.banks,
        )
        finish_all[m] = fin
        hits += int((kind == ROW_HIT).sum())
        empt += int((kind == ROW_EMPTY).sum())
        conf += int((kind == ROW_CONFLICT).sum())
        per_channel[c] = int(fin[-1])
    cycles = int(finish_all.max()) if len(finish_all) else 0
    ns = cycles / cfg.clock_ghz
    total_bytes = len(line_addr) * CACHE_LINE_BYTES
    gbps = (total_bytes / ns) if ns > 0 else 0.0
    return TraceResult(
        cycles=cycles,
        ns=ns,
        total_requests=len(line_addr),
        total_bytes=total_bytes,
        row_hits=hits,
        row_empty=empt,
        row_conflicts=conf,
        achieved_gbps=gbps,
        peak_gbps=cfg.peak_gbps,
        per_channel_cycles=per_channel,
        finish=finish_all if keep_finish else None,
    )
