"""AccuGraph's request program (the paper's Sect. 3.3, Fig. 8), frozen.

The graph is held as inverse-CSR blocks, one a source interval of ``q``
vertices (``q = n`` when the configuration names none): block ``k`` has,
for every destination vertex, its in-neighbours that lie in interval
``k``.  Memory holds the values, then each block's pointers and its
neighbours, cache-line aligned.  For each block of each iteration: a
prefetch phase reads the interval's values, then the block phase reads
the values outside the interval and the pointers (paced by
``vertex_pipelines``), the neighbours (paced by ``edge_pipelines`` and
by the vertex cache's bank conflicts) and writes the changed values, all
merged by issue cycle.  A copy of the program's model
(``core/accugraph.py``) in plain NumPy.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.algorithms import Run, vertex_centric
from portbench.reference.dram import LINE_BYTES, Device


def _q(n: int, acc: dict) -> int:
    return int(acc["partition_elements"] or n)


def run_algorithm(graph, acc: dict, problem: str, root: int = 0) -> Run:
    return vertex_centric(graph.n, graph.src, graph.dst, problem,
                          _q(graph.n, acc), root,
                          block_skipping=bool(acc["partition_skipping"]))


def _line_span(byte_start: int, nbytes: int) -> np.ndarray:
    if nbytes <= 0:
        return np.empty(0, dtype=np.int64)
    return np.arange(byte_start // LINE_BYTES,
                     (byte_start + nbytes - 1) // LINE_BYTES + 1,
                     dtype=np.int64)


def _spread(n: int, start: int, end: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1 or end <= start:
        return np.full(n, start, dtype=np.int64)
    return (start + (np.arange(n, dtype=np.float64) * (end - start) / n)
            ).astype(np.int64)


def _align(nbytes: int) -> int:
    return -(-nbytes // LINE_BYTES) * LINE_BYTES


def _stall_cycles(nbrs: np.ndarray, acc: dict) -> int:
    """Cycles to stream a block's neighbours: ``edge_pipelines`` a cycle,
    or longer where the vertex cache's busiest bank, serving one distinct
    id of each group of ``edge_pipelines`` a port, needs more."""
    ep = int(acc["edge_pipelines"])
    m_k = len(nbrs)
    ideal = int(np.ceil(m_k / ep))
    if not acc["model_stalls"] or m_k == 0:
        return ideal
    banks = int(acc["vertex_cache_banks"])
    group = np.arange(m_k, dtype=np.int64) // ep
    keys = np.sort((group << 32) + nbrs)
    first = np.ones(m_k, dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    per_bank = np.bincount((keys[first] & 0xFFFFFFFF) % banks,
                           minlength=banks)
    return max(ideal, int(np.ceil(per_bank.max()
                                  / int(acc["vertex_cache_ports"]))))


class Model:
    def __init__(self, graph, acc: dict, device: Device):
        n = graph.n
        self.n = n
        self.acc = acc
        self.q = q = _q(n, acc)
        self.p = p = -(-n // q)
        vb, pb, nb = (int(acc["value_bytes"]), int(acc["pointer_bytes"]),
                      int(acc["neighbor_bytes"]))
        # inverse CSR: neighbours (sources) of each destination, in edge
        # order, split by the neighbour's interval
        nbr_all = graph.src[np.argsort(graph.dst, kind="stable")]
        self.values_base = 0
        cursor = _align(n * vb)
        ratio = device.clock_ghz / float(acc["acc_ghz"])
        v_window = int(np.ceil(n / int(acc["vertex_pipelines"])) * ratio)
        self.prefetch, self.static_line, self.static_issue = [], [], []
        self.e_window = []
        for k in range(p):
            s, e = k * q, min((k + 1) * q, n)
            nbrs = nbr_all[(nbr_all // q) == k]
            ptr_base = cursor
            cursor += _align((n + 1) * pb)
            nbr_base = cursor
            cursor += _align(len(nbrs) * nb)
            self.prefetch.append(_line_span(s * vb, (e - s) * vb))
            dv = np.concatenate([_line_span(0, s * vb),
                                 _line_span(e * vb, (n - e) * vb)])
            ptr = _line_span(ptr_base, (n + 1) * pb)
            nl = _line_span(nbr_base, len(nbrs) * nb)
            e_window = int(_stall_cycles(nbrs, acc) * ratio)
            line = np.concatenate([dv, ptr, nl])
            issue = np.concatenate([_spread(len(dv), 0, v_window),
                                    _spread(len(ptr), 0, v_window),
                                    _spread(len(nl), 0, max(e_window, 1))])
            srt = np.argsort(issue, kind="stable")
            self.static_line.append(line[srt])
            self.static_issue.append(issue[srt])
            self.e_window.append(e_window)
        if cursor > device.capacity_bytes:
            raise ValueError("the graph does not fit the device")

    def _block(self, k: int, changed_k: np.ndarray):
        """The block's static reads with its changed-value writes merged
        in by issue cycle (reads first on ties)."""
        w_line = (np.nonzero(changed_k)[0]
                  * int(self.acc["value_bytes"])) // LINE_BYTES
        if len(w_line):
            keep = np.ones(len(w_line), dtype=bool)
            keep[1:] = w_line[1:] != w_line[:-1]
            w_line = w_line[keep]
        w_issue = _spread(len(w_line), 0, max(self.e_window[k], 1))
        line = np.concatenate([self.static_line[k], w_line])
        issue = np.concatenate([self.static_issue[k], w_issue])
        srt = np.argsort(issue, kind="stable")
        return line[srt], issue[srt]

    def phases(self, problem: str, run: Run):
        """``[(name, line, issue), ...]`` of the whole run."""
        out, last = [], -1
        for it, st in enumerate(run.per_iter):
            for k in range(self.p):
                changed_k = st.changed_per_block[k]
                if changed_k is None:
                    continue
                if not (self.acc["prefetch_skipping"] and last == k):
                    pre = self.prefetch[k]
                    out.append((f"it{it}_b{k}_prefetch", pre,
                                np.zeros(len(pre), dtype=np.int64)))
                last = k
                out.append((f"it{it}_b{k}", *self._block(k, changed_k)))
        return out
