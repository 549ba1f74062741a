"""HitGraph's request program (the paper's Sect. 3.2, Fig. 7), frozen.

The edges are split into ``p`` partitions by source interval of ``q``
vertices and sorted by destination within each; partition ``k`` lives
whole in channel ``k % n_pes`` (its values, its edges, its update queue,
one after the other, cache-line aligned).  Each iteration has a scatter
phase (values prefetched, edges read at ``pipelines`` edges a cycle,
updates written to the queues of their destination partitions) and a
gather phase (values prefetched, queues read at the same pace, changed
values written line by line), with update merging, update filtering and
partition skipping as the configuration sets them.  Issue cycles are
phase-relative memory cycles.  A copy of the program's model
(``core/hitgraph.py``) in plain NumPy.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.algorithms import Run, edge_centric
from portbench.reference.dram import LINE_BYTES, Device


def run_algorithm(graph, acc: dict, problem: str, root: int = 0) -> Run:
    return edge_centric(graph.n, graph.src, graph.dst, problem, root)


def _spans(first, count):
    count = np.asarray(count, dtype=np.int64)
    starts = np.cumsum(count) - count
    return (np.repeat(np.asarray(first, dtype=np.int64), count)
            + np.arange(int(count.sum()), dtype=np.int64)
            - np.repeat(starts, count))


def _span_counts(byte_start, nbytes):
    byte_start = np.asarray(byte_start, dtype=np.int64)
    nbytes = np.asarray(nbytes, dtype=np.int64)
    first = byte_start // LINE_BYTES
    last = (byte_start + np.maximum(nbytes, 1) - 1) // LINE_BYTES
    return first, np.where(nbytes > 0, last - first + 1, 0)


def _spread(start, window, count):
    """Element ``i`` of group ``g``: ``start[g] + floor(i * window[g] /
    count[g])`` in float64."""
    count = np.asarray(count, dtype=np.int64)
    starts = np.cumsum(count) - count
    i = (np.arange(int(count.sum()), dtype=np.int64)
         - np.repeat(starts, count)).astype(np.float64)
    w = np.repeat(np.asarray(window, dtype=np.float64), count)
    n = np.repeat(count.astype(np.float64), count)
    t = np.repeat(np.asarray(start, dtype=np.float64), count)
    return (t + i * w / n).astype(np.int64)


def _align(nbytes: int) -> int:
    return -(-nbytes // LINE_BYTES) * LINE_BYTES


def _priority(lines, issue, block):
    """Concatenated streams in PE order, then merged by issue cycle
    (stable: earlier streams win ties)."""
    order = np.argsort(block, kind="stable")
    order = order[np.argsort(issue[order], kind="stable")]
    return lines[order], issue[order]


class Model:
    def __init__(self, graph, acc: dict, device: Device):
        n = graph.n
        self.n = n
        self.acc = acc
        self.q = q = int(acc["partition_elements"])
        self.n_pes = int(acc["n_pes"])
        self.p = p = -(-n // q)
        key = (graph.src // q) * np.int64(n) + graph.dst
        # edges of one key differ only in their source; which of them
        # comes first changes no request
        order = np.argsort(key)
        self.e_src = graph.src[order]
        self.edge_key = key[order]
        e_dst = graph.dst[order]
        m_k = np.bincount(self.edge_key // n, minlength=p)
        starts = np.arange(p, dtype=np.int64) * q
        ends = np.minimum(starts + q, n)
        self.interval_start = starts
        in_counts = np.bincount(e_dst // q, minlength=p)
        cap_ch = device.capacity_bytes // device.channels
        cursor = [c * cap_ch for c in range(device.channels)]
        val, edge, queue = [], [], []
        vb, eb, ub = (int(acc["value_bytes"]), int(acc["edge_bytes"]),
                      int(acc["update_bytes"]))
        for k in range(p):
            c = k % self.n_pes
            n_k = int(ends[k] - starts[k])
            cap = int(min(in_counts[k], n_k * p)) + p
            for base, nbytes in ((val, n_k * vb), (edge, int(m_k[k]) * eb),
                                 (queue, cap * ub)):
                base.append(cursor[c])
                cursor[c] += _align(nbytes)
        if any(cur - c * cap_ch > cap_ch for c, cur in enumerate(cursor)):
            raise ValueError("the graph does not fit a channel")
        self.val_base = np.asarray(val, dtype=np.int64)
        self.queue_base = np.asarray(queue, dtype=np.int64)
        self.pre_first, self.pre_cnt = _span_counts(self.val_base,
                                                    (ends - starts) * vb)
        self.edge_first, self.edge_cnt = _span_counts(
            np.asarray(edge, dtype=np.int64), m_k * eb)
        self.ratio = device.clock_ghz / float(acc["acc_ghz"])
        self.win = (np.ceil(m_k / int(acc["pipelines"]))
                    * self.ratio).astype(np.int64)

    def _cursor(self, w):
        """Exclusive running sum of ``w`` over each PE's partitions."""
        t0 = np.zeros(self.p, dtype=np.int64)
        for c in range(self.n_pes):
            sl = slice(c, None, self.n_pes)
            t0[sl] = np.cumsum(w[sl]) - w[sl]
        return t0

    def _pairs(self, active):
        keys = (self.edge_key[active[self.e_src]]
                if self.acc["update_filtering"] else self.edge_key)
        if self.acc["update_merging"] and len(keys):
            keep = np.ones(len(keys), dtype=bool)
            keep[1:] = keys[1:] != keys[:-1]
            keys = keys[keep]
        return keys // self.n, keys % self.n

    def _scatter(self, active, u_count, q_off):
        p, ub = self.p, int(self.acc["update_bytes"])
        if self.acc["partition_skipping"]:
            proc = np.logical_or.reduceat(active, self.interval_start)
        else:
            proc = np.ones(p, dtype=bool)
        t0 = self._cursor(np.where(proc, np.maximum(self.win, 1), 0))
        blk = p + 2
        pk = np.nonzero(proc)[0]
        kk, jj = np.nonzero(u_count)
        sel = proc[kk]
        kk, jj = kk[sel], jj[sel]
        cnt = u_count[kk, jj]
        w_first, w_cnt = _span_counts(
            self.queue_base[jj] + q_off[kk, jj] * ub, cnt * ub)
        lines = np.concatenate([
            _spans(self.pre_first[pk], self.pre_cnt[pk]),
            _spans(self.edge_first[pk], self.edge_cnt[pk]),
            _spans(w_first, w_cnt)])
        issue = np.concatenate([
            np.repeat(t0[pk], self.pre_cnt[pk]),
            _spread(t0[pk], self.win[pk], self.edge_cnt[pk]),
            _spread(t0[kk], self.win[kk], w_cnt)])
        block = np.concatenate([
            np.repeat(pk * blk, self.pre_cnt[pk]),
            np.repeat(pk * blk + 1, self.edge_cnt[pk]),
            np.repeat(kk * blk + 2 + jj, w_cnt)])
        return _priority(lines, issue, block)

    def _gather(self, changed, dsts, dpart, u_count):
        p = self.p
        ub, vb = int(self.acc["update_bytes"]), int(self.acc["value_bytes"])
        U = u_count.sum(axis=0)
        proc = ((U > 0) if self.acc["partition_skipping"]
                else np.ones(p, dtype=bool))
        win = (np.ceil(U / int(self.acc["pipelines"]))
               * self.ratio).astype(np.int64)
        t0 = self._cursor(np.where(proc, np.maximum(win, 1), 0))
        jk = np.nonzero(proc)[0]
        q_first, q_cnt = _span_counts(self.queue_base, U * ub)
        sel = changed[dsts]
        jd, dd = dpart[sel], dsts[sel]
        line = (self.val_base[jd]
                + (dd - self.interval_start[jd]) * vb) // LINE_BYTES
        order = np.lexsort((line, jd))
        jd, line = jd[order], line[order]
        if len(jd):
            keep = np.ones(len(jd), dtype=bool)
            keep[1:] = (jd[1:] != jd[:-1]) | (line[1:] != line[:-1])
            jd, line = jd[keep], line[keep]
        w_cnt = np.bincount(jd, minlength=p)
        jp = np.nonzero(w_cnt)[0]
        lines = np.concatenate([
            _spans(self.pre_first[jk], self.pre_cnt[jk]),
            _spans(q_first[jk], q_cnt[jk]), line])
        issue = np.concatenate([
            np.repeat(t0[jk], self.pre_cnt[jk]),
            _spread(t0[jk], win[jk], q_cnt[jk]),
            _spread(t0[jp], win[jp], w_cnt[jp])])
        block = np.concatenate([
            np.repeat(jk * 3, self.pre_cnt[jk]),
            np.repeat(jk * 3 + 1, q_cnt[jk]),
            np.repeat(jp * 3 + 2, w_cnt[jp])])
        return _priority(lines, issue, block)

    def phases(self, problem: str, run: Run):
        """``[(name, line, issue), ...]`` of the whole run."""
        p, out = self.p, []
        for it, st in enumerate(run.per_iter):
            kp, dsts = self._pairs(st.active_before)
            dpart = dsts // self.q
            u_count = np.bincount(kp * p + dpart,
                                  minlength=p * p).reshape(p, p)
            q_off = np.zeros((p, p), dtype=np.int64)
            q_off[1:] = np.cumsum(u_count, axis=0)[:-1]
            out.append((f"it{it}_scatter",
                        *self._scatter(st.active_before, u_count, q_off)))
            out.append((f"it{it}_gather",
                        *self._gather(st.changed, dsts, dpart, u_count)))
        return out
