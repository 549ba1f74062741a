"""Memory access abstractions (paper Fig. 6) and the event-driven engine.

The paper models accelerators as a graph of

* **producers** (Fig. 6a)  — control-flow trigger -> request stream,
  optionally rate-limited (pipeline counts);
* **mergers**  (Fig. 6b-d) — direct / round-robin / priority;
* **mappers**  (Fig. 6e-g) — cache-line buffer, filter, callback;

feeding one DRAM endpoint.  This module is the *event-driven* (element
granularity) realization, the fidelity reference for the trace models in
``core/hitgraph.py`` / ``core/accugraph.py``.  The engine ticks the
accelerator and the DRAM at their respective clocks (Sect. 3.1);
computation and on-chip accesses are instantaneous by default.  It runs on
the host, one request at a time, through
:class:`~repro_torch.core.timing.ChannelState`.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from repro_torch.core.dram import DRAMConfig
from repro_torch.core.timing import ChannelState


@dataclasses.dataclass
class Request:
    """One cache-line request flowing through the abstraction graph."""

    line: int
    write: bool
    callbacks: List[Callable[[int], None]] = dataclasses.field(
        default_factory=list
    )


class Node:
    """Base class of the abstraction graph; pushes requests downstream."""

    def __init__(self, downstream: "Node | None" = None):
        self.downstream = downstream

    def push(self, req: Request, t_mem: int) -> None:
        if self.downstream is not None:
            self.downstream.push(req, t_mem)

    def flush(self, t_mem: int) -> None:
        if self.downstream is not None:
            self.downstream.flush(t_mem)


class CacheLineBuffer(Node):
    """Fig. 6e: merge *subsequent* requests to the same line into one.

    Callbacks of merged requests ride along on the surviving request.
    Placed "as far from the memory as necessary" — i.e. per stream.
    """

    def __init__(self, downstream: Node):
        super().__init__(downstream)
        self._pending: Optional[Request] = None

    def push(self, req: Request, t_mem: int) -> None:
        if self._pending is not None and self._pending.line == req.line \
                and self._pending.write == req.write:
            self._pending.callbacks.extend(req.callbacks)
            return
        if self._pending is not None:
            self.downstream.push(self._pending, t_mem)
        self._pending = req

    def flush(self, t_mem: int) -> None:
        if self._pending is not None:
            self.downstream.push(self._pending, t_mem)
            self._pending = None
        super().flush(t_mem)


class RequestFilter(Node):
    """Fig. 6f: discard requests served on-chip; fire callbacks directly."""

    def __init__(self, downstream: Node, keep: Callable[[Request], bool]):
        super().__init__(downstream)
        self.keep = keep
        self.filtered = 0

    def push(self, req: Request, t_mem: int) -> None:
        if self.keep(req):
            self.downstream.push(req, t_mem)
        else:
            self.filtered += 1
            for cb in req.callbacks:
                cb(t_mem)


class Merger(Node):
    """Base merger: buffers per-source pushes within a tick, emits ordered."""

    def __init__(self, n_sources: int, downstream: Node):
        super().__init__(downstream)
        self.buffers: List[List[Request]] = [[] for _ in range(n_sources)]

    def port(self, i: int) -> "MergerPort":
        return MergerPort(self, i)

    def _ordered(self) -> List[Request]:
        raise NotImplementedError

    def emit(self, t_mem: int) -> None:
        for req in self._ordered():
            self.downstream.push(req, t_mem)
        for b in self.buffers:
            b.clear()


class MergerPort(Node):
    def __init__(self, merger: Merger, index: int):
        super().__init__(None)
        self.merger = merger
        self.index = index

    def push(self, req: Request, t_mem: int) -> None:
        self.merger.buffers[self.index].append(req)

    def flush(self, t_mem: int) -> None:
        pass


class DirectMerger(Merger):
    """Fig. 6b: sources do not operate in parallel; registration order."""

    def _ordered(self) -> List[Request]:
        return [r for b in self.buffers for r in b]


class RoundRobinMerger(Merger):
    """Fig. 6c: equal load balancing across sources."""

    def _ordered(self) -> List[Request]:
        out: List[Request] = []
        iters = [iter(b) for b in self.buffers]
        alive = list(range(len(iters)))
        while alive:
            nxt = []
            for i in alive:
                try:
                    out.append(next(iters[i]))
                    nxt.append(i)
                except StopIteration:
                    pass
            alive = nxt
        return out


class PriorityMerger(Merger):
    """Fig. 6d: lower priority value = served first."""

    def __init__(self, priorities: List[int], downstream: Node):
        super().__init__(len(priorities), downstream)
        self.priorities = priorities

    def _ordered(self) -> List[Request]:
        order = sorted(range(len(self.buffers)),
                       key=lambda i: self.priorities[i])
        return [r for i in order for r in self.buffers[i]]


class Producer:
    """Fig. 6a: turns a control-flow trigger into a request stream.

    ``stream`` yields ``(line, write, callback|None)``; ``rate`` limits
    emissions per *accelerator* cycle (None = bulk).  ``on_produced`` fires
    once every element has been emitted (the paper's producer-to-producer
    control edges); per-element callbacks fire on memory response.
    """

    def __init__(
        self,
        name: str,
        out: Node,
        rate: Optional[float] = None,
    ):
        self.name = name
        self.out = out
        self.rate = rate
        self.on_produced: List[Callable[[int], None]] = []
        self._stream: Optional[Iterator] = None
        self._credit = 0.0
        self.active = False
        self.produced = 0

    def trigger(self, stream: Iterable[Tuple[int, bool, Optional[Callable]]],
                t_mem: int) -> None:
        self._stream = iter(stream)
        self._credit = 0.0
        self.active = True

    def tick(self, t_mem: int) -> None:
        if not self.active:
            return
        if self.rate is None:
            budget = None
        else:
            self._credit += self.rate
            budget = int(self._credit)
            self._credit -= budget
        emitted = 0
        while budget is None or emitted < budget:
            try:
                line, write, cb = next(self._stream)
            except StopIteration:
                self.active = False
                self.out.flush(t_mem)
                for fn in self.on_produced:
                    fn(t_mem)
                return
            req = Request(int(line), bool(write),
                          [cb] if cb is not None else [])
            self.out.push(req, t_mem)
            emitted += 1
            self.produced += 1


class DRAMEndpoint(Node):
    """Terminal node: per-channel in-order service via ChannelState.

    Each request's line is decoded by :meth:`DRAMConfig.line_decoder`, the
    scalar form of ``decode_lines`` (equal on every line)."""

    def __init__(self, cfg: DRAMConfig, engine: "Engine"):
        super().__init__(None)
        self.cfg = cfg
        self.engine = engine
        self.channels = [
            ChannelState(timing=cfg.timing, n_banks=cfg.banks_per_channel,
                         banks_per_rank=cfg.org.banks)
            for _ in range(cfg.channels)
        ]
        self._decode = cfg.line_decoder()
        self.served = 0
        self.row_kind_counts = [0, 0, 0]
        self.last_finish = 0

    def push(self, req: Request, t_mem: int) -> None:
        c, bank, row = self._decode(req.line)
        finish, kind = self.channels[c].serve(t_mem, bank, row)
        self.served += 1
        self.row_kind_counts[kind] += 1
        self.last_finish = max(self.last_finish, finish)
        for cb in req.callbacks:
            self.engine.schedule(finish, cb)

    def flush(self, t_mem: int) -> None:
        pass


class Engine:
    """Discrete-time simulation: accelerator cycles + DRAM service.

    Clock handling per Sect. 3.1: the graph-processing simulation ticks at
    ``acc_ghz``; memory timing runs at ``cfg.clock_ghz``.  All times in
    this class are *memory* cycles; one accelerator tick advances
    ``ratio = mem/acc`` memory cycles (a Python float, as in the JAX
    package: ``t_mem`` advances by ``int(t_mem + max(ratio, 1))``).
    """

    def __init__(self, cfg: DRAMConfig, acc_ghz: float = 0.2):
        self.cfg = cfg
        self.acc_ghz = acc_ghz
        self.ratio = cfg.clock_ghz / acc_ghz
        self.dram = DRAMEndpoint(cfg, self)
        self.producers: List[Producer] = []
        self.mergers: List[Merger] = []
        self._events: List[Tuple[int, int, Callable[[int], None]]] = []
        self._seq = itertools.count()
        self.t_mem = 0
        self.finished = False

    # -- construction ---------------------------------------------------
    def producer(self, name: str, out: Node,
                 rate: Optional[float] = None) -> Producer:
        p = Producer(name, out, rate)
        self.producers.append(p)
        return p

    def register_merger(self, m: Merger) -> Merger:
        self.mergers.append(m)
        return m

    # -- runtime ----------------------------------------------------------
    def schedule(self, t_mem: int, fn: Callable[[int], None]) -> None:
        heapq.heappush(self._events, (int(t_mem), next(self._seq), fn))

    def barrier(self, fn: Callable[[int], None]) -> None:
        """Fire ``fn`` when all issued memory requests have finished."""
        self.schedule(max(self.dram.last_finish, self.t_mem), fn)

    def run(self, max_cycles: int = 1 << 31) -> int:
        """Run to completion; returns makespan in memory cycles."""
        while self.t_mem < max_cycles:
            while self._events and self._events[0][0] <= self.t_mem:
                _, _, fn = heapq.heappop(self._events)
                fn(self.t_mem)
            any_active = any(p.active for p in self.producers)
            if not any_active and not self._events:
                break
            for p in self.producers:
                p.tick(self.t_mem)
            for m in self.mergers:
                m.emit(self.t_mem)
            if not any(p.active for p in self.producers) and self._events:
                # fast-forward to the next event, clamped to its time: an
                # event scheduled *during this cycle* (same-cycle callback
                # chain, e.g. a barrier firing at t_mem) must run at its
                # scheduled time, not one cycle later.
                self.t_mem = max(self.t_mem, self._events[0][0])
            else:
                self.t_mem = int(self.t_mem + max(self.ratio, 1))
        return max(self.dram.last_finish, self.t_mem)

    def runtime_ns(self) -> float:
        return max(self.dram.last_finish, self.t_mem) / self.cfg.clock_ghz
