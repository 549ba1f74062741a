"""Plain PyTorch versions of the two DRAM-timing kernels: the references
the CUDA kernels are held against, and what the wrappers run for CPU
tensors.  Both run on whatever device their tensors live.

:func:`dram_serve_ref` (for ``csrc/dram_serve.cu``) is
``make_serve_step`` (``src/repro/core/vectorized.py:579``) written in
torch, one Python-loop iteration per step.  Steps past the last one that
holds a valid lane or a phase boundary are all alike (every lane invalid,
no re-base): instead of looping over them it applies their combined
effect, which is not a no-op — the bus time and the phase makespan clamp
at 0, because such a step's makespan ``mx`` is 0 — so the returned carry
equals a step-by-step run over the whole padded stream.

:func:`dram_timing_ref` (for ``csrc/dram_timing.cu`` and
``csrc/dram_timing_serial.cu``) is ``_request_step``/``_channel_scan``
(``src/repro/core/vectorized.py:227, 279``) in torch, channels side by
side, one Python-loop iteration per slot.  Invalid slots leave the carry
untouched, so it stops at the last slot that is valid in any channel.
:func:`dram_timing_serial_ref` is the same scan under the serial
kernel's name.  :func:`dram_timing_chunked_ref` computes the same by the
card's chunked max-plus passes, with the chunk length a parameter.

:func:`serve_prepass_ref` and :func:`serve_records_ref` are the two
halves of the card's serve (``csrc/dram_serve.cu``) in torch: the
carry-free records of every step, and the carry chain that walks them;
composed, they equal :func:`dram_serve_ref`.

:func:`dram_serve_batch_ref`, :func:`serve_prepass_batch_ref` and
:func:`serve_records_batch_ref` run those over M cases (the batched
serve's case axis), one case after another.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.vectorized import (META_CONFL, META_MISS,
                                         META_RB_MASK, META_RB_SHIFT,
                                         META_VALID, NEG_INF32)

State = Tuple[torch.Tensor, ...]

#: the max-plus zero (-infinity) of the chunked scan's int64 matrices, far
#: below any time: a chunk adds at most T times the timing sum to it
NEG64 = -(1 << 62)
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def dram_timing_ref(issue: torch.Tensor, bank: torch.Tensor,
                    row: torch.Tensor, valid: torch.Tensor,
                    timing: torch.Tensor, carry: State):
    """Serve per-channel ``[C, L]`` request streams (one request per
    channel per slot) from ``carry``, the 7-tuple ``(open_row[C,B],
    act_time[C,B], bank_avail[C,B], bus_free[C], act_hist[C,R,4],
    act_ptr[C,R], last_act[C,R])``.  Returns ``(finish int32[C, L],
    kind int8[C, L], carry)``: kind 0 hit / 1 empty / 2 conflict, and
    ``(0, -1)`` on invalid slots."""
    tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (int(x) for x in
                                             timing.tolist())
    (open_row, act_time, bank_avail, bus_free,
     act_hist, act_ptr, last_act) = (x.clone() for x in carry)
    C, L = issue.shape
    banks_per_rank = open_row.shape[1] // act_ptr.shape[1]
    ch = torch.arange(C, device=issue.device)
    finish = torch.zeros_like(issue)
    kind = torch.full((C, L), -1, dtype=torch.int8, device=issue.device)
    live = torch.nonzero(valid.any(dim=0)).flatten()
    n_live = int(live[-1]) + 1 if len(live) else 0
    for j in range(n_live):
        v = valid[:, j]
        b = bank[:, j].long()
        r = row[:, j]
        rank = torch.div(b, banks_per_rank, rounding_mode="floor")
        o = open_row[ch, b]
        av = bank_avail[ch, b]
        at = act_time[ch, b]
        hit = o == r
        empty = o == -1
        base = torch.maximum(issue[:, j], av)
        # ACT rate limits per rank (tRRD, tFAW over the 4th-last ACT)
        ptr = act_ptr[ch, rank].long()
        oldest = act_hist[ch, rank, ptr]
        la = last_act[ch, rank]
        act_floor = torch.maximum(la + tRRD, oldest + tFAW)
        act = torch.where(
            empty, torch.maximum(base, act_floor),
            torch.maximum(torch.maximum(base, at + tRAS) + tRP, act_floor))
        col = torch.where(hit, base, act + tRCD)
        fin = torch.maximum(col + tCL, bus_free) + tBL
        did_act = ~hit & v
        open_row[ch, b] = torch.where(v & ~hit, r, o)
        act_time[ch, b] = torch.where(did_act, act, at)
        bank_avail[ch, b] = torch.where(v, col + tBL, av)
        bus_free = torch.where(v, fin, bus_free)
        act_hist[ch, rank, ptr] = torch.where(did_act, act, oldest)
        act_ptr[ch, rank] = torch.where(
            did_act, torch.remainder(ptr + 1, 4), ptr).to(act_ptr.dtype)
        last_act[ch, rank] = torch.where(did_act, act, la)
        finish[:, j] = torch.where(v, fin, torch.zeros_like(fin))
        kind[:, j] = torch.where(
            v, torch.where(hit, 0, torch.where(empty, 1, 2)),
            -1).to(torch.int8)
    return finish, kind, (open_row, act_time, bank_avail, bus_free,
                          act_hist, act_ptr, last_act)


def dram_timing_serial_ref(issue: torch.Tensor, bank: torch.Tensor,
                           row: torch.Tensor, valid: torch.Tensor,
                           timing: torch.Tensor, carry: State):
    """The plain version of ``csrc/dram_timing_serial.cu``: one channel
    walks its slots in int32 that wraps, which is :func:`dram_timing_ref`
    slot for slot."""
    return dram_timing_ref(issue, bank, row, valid, timing, carry)


def timing_state_width(banks_per_rank: int) -> int:
    """D, the length of a rank's state vector in the chunked scan: its
    banks' ``bank_avail`` and ``act_time``, its 4-deep ACT history (in
    ring order from the chunk's entry pointer), ``last_act``, and a
    constant 0 (through which the slots' issue cycles enter)."""
    return 2 * banks_per_rank + 6


def _chunked(x: torch.Tensor, n_chunks: int, T: int, fill) -> torch.Tensor:
    C, L = x.shape
    pad = torch.full((C, n_chunks * T - L), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], 1).view(C, n_chunks, T)


def dram_timing_chunked_ref(issue: torch.Tensor, bank: torch.Tensor,
                            row: torch.Tensor, valid: torch.Tensor,
                            timing: torch.Tensor, carry: State, T: int):
    """The card's chunked max-plus scan (``csrc/dram_timing.cu``) in torch:
    what :func:`dram_timing_ref` computes, in int64, by its five passes
    over chunks of ``T`` slots, each pass a loop over chunks or over a
    chunk's slots with every chunk side by side.

    1. summary: per chunk, each bank's first and last valid row, the ACTs
       of slots that are not the first to their bank, the valid count;
    2. entry scan: each chunk's open rows, ACT-ring pointers and valid
       count before it (and so the carry's ``open_row``, ``act_ptr``);
    3. transfer: with its selections fixed (hit / empty / conflict and the
       ring slot of every ACT follow from the open rows alone), a chunk
       maps each rank's state vector ``s`` (:func:`timing_state_width`)
       max-plus linearly; lane ``j`` runs the chunk from the basis vector
       ``e_j`` and gives column ``j`` of the matrix, plus the bus row: the
       chunk's max of ``col + tCL + tBL - n * tBL`` (``n`` counting the
       chunk's valid slots up to and including this one);
    4. carry scan: ``s <- M_k (x) s`` chunk by chunk gives each chunk's
       entry state and the carry out (the card first multiplies groups of
       chunks' matrices, which max-plus associativity allows); the bus is
       a prefix max over the chunks' bus rows, for ``finish_i = n_i * tBL
       + max(bus_in, max_{j <= i} (col_j + tCL + tBL - n_j * tBL))``;
    5. emit: each chunk walked once more from its entry state, writing
       ``finish`` (the card in int32 that wraps as the per-slot scan
       does, flagging the wrap).

    Returns ``(finish, kind, carry)`` as :func:`dram_timing_ref` does.
    Raises ``ValueError`` where a valid slot's step leaves the int32
    range, that is, where the int32 reference would wrap."""
    tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (int(x) for x in
                                             timing.tolist())
    (open_row, act_time, bank_avail, bus_free,
     act_hist, act_ptr, last_act) = carry
    C, L = issue.shape
    B, R = open_row.shape[1], act_ptr.shape[1]
    bpr = B // R
    D = timing_state_width(bpr)
    A, H, LAST, Z = bpr, 2 * bpr, 2 * bpr + 4, 2 * bpr + 5
    dev = issue.device
    i64 = dict(dtype=torch.int64, device=dev)
    if L == 0:
        return (torch.empty_like(issue),
                torch.empty((C, 0), dtype=torch.int8, device=dev),
                tuple(x.clone() for x in carry))
    nK = -(-L // T)
    iss, bnk, rw = (_chunked(x.long(), nK, T, 0) for x in (issue, bank, row))
    v = _chunked(valid, nK, T, False)
    bank_ids = torch.arange(B, device=dev)
    rank_ids = torch.arange(R, device=dev)

    # 1. summary, every chunk side by side
    has = torch.zeros((C, nK, B), dtype=torch.bool, device=dev)
    first = torch.zeros((C, nK, B), **i64)
    last = torch.zeros((C, nK, B), **i64)
    nf_acts = torch.zeros((C, nK, R), **i64)
    for t in range(T):
        vt, bt, rt = v[..., t], bnk[..., t], rw[..., t]
        oh = (bt[..., None] == bank_ids) & vt[..., None]
        seen = (has & oh).any(-1)
        prev = torch.gather(last, 2, bt[..., None]).squeeze(-1)
        acts = vt & seen & (prev != rt)
        nf_acts += ((torch.div(bt, bpr, rounding_mode="floor")[..., None]
                     == rank_ids) & acts[..., None])
        first = torch.where(oh & ~has, rt[..., None], first)
        last = torch.where(oh, rt[..., None], last)
        has |= oh
    nvalid = v.sum(2)

    # 2. entry scan over the chunks
    opn, ptr = open_row.long(), act_ptr.long()
    n = torch.zeros(C, **i64)
    open_entry = torch.empty((C, nK, B), **i64)
    ptr_entry = torch.empty((C, nK, R), **i64)
    N = torch.empty((C, nK), **i64)
    for k in range(nK):
        open_entry[:, k], ptr_entry[:, k], N[:, k] = opn, ptr, n
        fa = has[:, k] & (first[:, k] != opn)
        ptr = (ptr + nf_acts[:, k] + fa.view(C, R, bpr).sum(-1)) % 4
        opn = torch.where(has[:, k], last[:, k], opn)
        n = n + nvalid[:, k]

    # 3. transfer: lane j of chunk k (per rank) runs from e_j
    shape = (C, R, nK, D)
    eye = torch.arange(D, device=dev)
    S = torch.where(eye[:, None] == eye, 0, NEG64).to(torch.int64).expand(
        *shape, D).clone()                                  # [.., j, i]
    G = torch.full(shape, NEG64, **i64)
    cur = open_entry.view(C, nK, R, bpr).permute(0, 2, 1, 3).clone()
    p = torch.zeros((C, R, nK), **i64)
    nloc = torch.zeros((C, nK), **i64)
    live = torch.zeros((C, R, nK), dtype=torch.bool, device=dev)
    kind = torch.full((C, nK, T), -1, dtype=torch.int8, device=dev)

    def comp(idx):
        return torch.gather(S, 4, idx[..., None, None].expand(
            *shape, 1)).squeeze(-1)

    def put(idx, val, mask):
        S.scatter_(4, idx[..., None, None].expand(*shape, 1),
                   torch.where(mask, val, comp(idx))[..., None])

    for t in range(T):
        vt, bt, rt, it = v[..., t], bnk[..., t], rw[..., t], iss[..., t]
        nloc = nloc + vt
        rk = torch.div(bt, bpr, rounding_mode="floor")
        mine = vt[:, None] & (rk[:, None] == rank_ids[:, None])
        live |= mine
        bl = torch.remainder(bt, bpr)[:, None].expand(C, R, nK)
        o = torch.gather(cur, 3, bl[..., None]).squeeze(-1)
        rtx = rt[:, None].expand(C, R, nK)
        hit, empty = o == rtx, o == -1
        av, at, hp = comp(bl), comp(bl + A), comp(p + H)
        la = S[..., LAST].clone()
        base = torch.maximum(it[:, None, :, None] + S[..., Z], av)
        floor = torch.maximum(la + tRRD, hp + tFAW)
        act = torch.where(
            empty[..., None], torch.maximum(base, floor),
            torch.maximum(torch.maximum(base, at + tRAS) + tRP, floor))
        col = torch.where(hit[..., None], base, act + tRCD)
        G = torch.where(mine[..., None], torch.maximum(
            G, col + tCL + tBL - nloc[:, None, :, None] * tBL), G)
        miss = mine & ~hit
        put(bl + A, act, miss[..., None])
        put(p + H, act, miss[..., None])
        S[..., LAST] = torch.where(miss[..., None], act, la)
        put(bl, col + tBL, mine[..., None])
        cur.scatter_(3, bl[..., None], torch.where(miss, rtx, o)[..., None])
        p = torch.where(miss, torch.remainder(p + 1, 4), p)
        kt = torch.where(hit, 0, torch.where(empty, 1, 2))
        kind[..., t] = torch.where(vt, torch.where(mine, kt, 0).sum(1),
                                   -1).to(torch.int8)

    # 4. carry scan over the chunks, each rank on its own
    s = torch.cat([bank_avail.view(C, R, bpr).long(),
                   act_time.view(C, R, bpr).long(), act_hist.long(),
                   last_act.long()[..., None],
                   torch.zeros((C, R, 1), **i64)], -1)
    entry = torch.empty(shape, **i64)
    h = torch.full((C, R, nK), NEG64, **i64)
    q = torch.arange(4, device=dev)
    for k in range(nK):
        entry[:, :, k] = s
        ring = torch.remainder(ptr_entry[:, k][..., None] + q, 4)
        s_rel = s.clone()
        s_rel[..., H:H + 4] = torch.gather(s[..., H:H + 4], 2, ring)
        new = (S[:, :, k] + s_rel[..., :, None]).amax(-2)
        hk = (G[:, :, k] + s_rel).amax(-1)
        new[..., H:H + 4] = torch.empty_like(ring).scatter_(
            2, ring, new[..., H:H + 4].clone())
        lv = live[:, :, k]
        s = torch.where(lv[..., None], new, s)
        h[:, :, k] = torch.where(lv, hk, NEG64)
    F = bus_free.long()
    f_entry = torch.empty((C, nK), **i64)
    for k in range(nK):
        f_entry[:, k] = F
        F = torch.maximum(F, h[:, :, k].amax(1) - N[:, k] * tBL)
    bus_out = F + n * tBL

    # 5. emit: every chunk walked from its true entry state
    def by_bank(x):
        return x.permute(0, 2, 1, 3).reshape(C, nK, B).clone()

    av, at = by_bank(entry[..., :A]), by_bank(entry[..., A:H])
    hist = entry[..., H:H + 4].permute(0, 2, 1, 3).reshape(C, nK, R * 4)
    hist = hist.clone()
    la = entry[..., LAST].permute(0, 2, 1).clone()
    cur, pt = open_entry.clone(), ptr_entry.clone()
    Fc, nc = f_entry.clone(), N.clone()
    fin = torch.zeros((C, nK, T), **i64)
    wrapped = torch.zeros((C, nK), dtype=torch.bool, device=dev)
    for t in range(T):
        vt, bt, rt, it = v[..., t], bnk[..., t], rw[..., t], iss[..., t]
        rk = torch.div(bt, bpr, rounding_mode="floor")
        b1, r1 = bt[..., None], rk[..., None]
        o = torch.gather(cur, 2, b1).squeeze(-1)
        a_v = torch.gather(av, 2, b1).squeeze(-1)
        a_t = torch.gather(at, 2, b1).squeeze(-1)
        pp = torch.gather(pt, 2, r1).squeeze(-1)
        hi = (rk * 4 + pp)[..., None]
        hp = torch.gather(hist, 2, hi).squeeze(-1)
        lr = torch.gather(la, 2, r1).squeeze(-1)
        hit, empty = o == rt, o == -1
        base = torch.maximum(it, a_v)
        x_ras = a_t + tRAS
        x_rp = torch.maximum(base, x_ras) + tRP
        f_rrd, f_faw = lr + tRRD, hp + tFAW
        floor = torch.maximum(f_rrd, f_faw)
        act = torch.where(empty, torch.maximum(base, floor),
                          torch.maximum(x_rp, floor))
        x_rcd = act + tRCD
        col = torch.where(hit, base, x_rcd)
        nc = nc + vt
        Fc = torch.where(vt, torch.maximum(
            Fc, col + tCL + tBL - nc * tBL), Fc)
        f = Fc + nc * tBL
        vals = torch.stack([x_ras, x_rp, f_rrd, f_faw, x_rcd, col + tCL,
                            col + tBL, f])
        wrapped |= vt & ((vals < I32_MIN) | (vals > I32_MAX)).any(0)
        miss = vt & ~hit
        cur.scatter_(2, b1, torch.where(miss, rt, o)[..., None])
        at.scatter_(2, b1, torch.where(miss, act, a_t)[..., None])
        av.scatter_(2, b1, torch.where(vt, col + tBL, a_v)[..., None])
        hist.scatter_(2, hi, torch.where(miss, act, hp)[..., None])
        pt.scatter_(2, r1, torch.where(miss, torch.remainder(pp + 1, 4),
                                       pp)[..., None])
        la.scatter_(2, r1, torch.where(miss, act, lr)[..., None])
        fin[..., t] = torch.where(vt, f, 0)

    out = (opn, s[..., A:H].reshape(C, B), s[..., :A].reshape(C, B),
           bus_out, s[..., H:H + 4], ptr, s[..., LAST])
    if bool(wrapped.any()) or any(
            bool(((x < I32_MIN) | (x > I32_MAX)).any()) for x in out):
        raise ValueError("a step leaves the int32 range (the int32 scan "
                         "would wrap)")
    finish = fin.view(C, nK * T)[:, :L].to(torch.int32).contiguous()
    return (finish, kind.view(C, nK * T)[:, :L].contiguous(),
            tuple(x.to(torch.int32).contiguous() for x in out))


def make_serve_step(timing, C: int, B: int, R: int, K: int,
                    banks_per_rank: int, device):
    """The blocked lockstep serve step over ``[C, K]`` request blocks:
    ``step(state, iss[C,K], mt[C,K], bnd) -> (state, fin_out[C,K])`` with
    ``state`` the 6-tuple ``(avail, act, bus, hist, ptr, pmf)``."""
    tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (int(x) for x in timing)
    i32 = dict(dtype=torch.int32, device=device)
    neg = torch.tensor(NEG_INF32, **i32)
    zero = torch.tensor(0, **i32)
    bank_ids = torch.arange(B, **i32)
    rank_ids = torch.arange(R, **i32)
    ptr_ids = torch.arange(4, **i32)
    lane_ids = torch.arange(K, **i32)
    lane_tbl = lane_ids * tBL
    lane_tbl1 = (lane_ids + 1) * tBL
    tril = lane_ids[:, None] >= lane_ids[None, :]          # [K, K]

    def pick(masked, dim):
        return masked.amax(dim=dim)

    def step(state, iss, mt, bnd):
        avail, act, bus, hist, ptr, pmf = state
        b = mt & 0xFF
        ms = (mt & META_MISS) != 0
        cf = (mt & META_CONFL) != 0
        v = (mt & META_VALID) != 0
        rb_tbl = ((mt >> META_RB_SHIFT) & META_RB_MASK) * tBL
        ohb = b[:, :, None] == bank_ids                    # [C, K, B]
        avail_b = pick(torch.where(ohb, avail[:, None, :], neg), 2)
        act_b = pick(torch.where(ohb, act[:, None, :], neg), 2)
        # hit chain: same-bank max-plus chain over the block's lanes
        adj = iss - rb_tbl
        same = (b[:, :, None] == b[:, None, :]) & tril     # [C, K, K]
        own = pick(torch.where(same, adj[:, None, :], neg), 2)
        col_hit = rb_tbl + torch.maximum(own, avail_b)
        # miss machinery at block level (at most one miss per block)
        mv = ms & v
        m_any = mv.any(dim=1)                              # [C]
        if R == 1:
            ptr_m = ptr[:, 0]                              # [C]
            hist_m = hist[:, 0]                            # [C, 4]
        else:
            rank = torch.div(b, banks_per_rank, rounding_mode="floor")
            rank_m = pick(torch.where(mv, rank, zero), 1)  # [C]
            ohr_m = rank_m[:, None] == rank_ids            # [C, R]
            ptr_m = pick(torch.where(ohr_m, ptr, zero), 1)
            hist_m = pick(torch.where(ohr_m[:, :, None], hist, neg), 1)
        ohp_m = ptr_m[:, None] == ptr_ids                  # [C, 4]
        oh_last = torch.remainder(ptr_m + 3, 4)[:, None] == ptr_ids
        hist_p = pick(torch.where(ohp_m, hist_m, neg), 1)
        last_r = pick(torch.where(oh_last, hist_m, neg), 1)
        # ACT rate limits per rank (tRRD, tFAW over the 4th-last ACT)
        floor = torch.maximum(last_r + tRRD, hist_p + tFAW)  # [C]
        base = torch.maximum(iss, avail_b)
        pre = torch.where(cf, torch.maximum(base, act_b + tRAS) + tRP,
                          base)
        a = torch.maximum(pre, floor[:, None])             # miss ACT time
        col = torch.where(ms, a + tRCD, col_hit)
        # shared data bus: prefix max over the block's valid lanes
        cadj = col + tCL - lane_tbl
        ccm = pick(torch.where(tril & v[:, None, :], cadj[:, None, :], neg),
                   2)
        fin = lane_tbl1 + torch.maximum(bus[:, None], ccm)
        fin_out = torch.where(v, fin, zero)
        mx = pick(fin_out, 1)                              # [C]
        bus = torch.maximum(bus, mx)
        pmf = torch.maximum(pmf, mx)
        vohb = ohb & v[:, :, None]
        avail = torch.maximum(avail, pick(
            torch.where(vohb, (col + tBL)[:, :, None], neg), 1))
        a_m = pick(torch.where(mv, a, neg), 1)             # [C]
        act = torch.maximum(act, pick(
            torch.where(ohb & mv[:, :, None], a[:, :, None], neg), 1))
        if R == 1:
            hist = torch.maximum(hist, torch.where(
                ohp_m & m_any[:, None], a_m[:, None], neg)[:, None, :])
            ptr = torch.where(m_any[:, None],
                              torch.remainder(ptr_m + 1, 4)[:, None], ptr)
        else:
            hist = torch.maximum(hist, torch.where(
                (ohr_m[:, :, None] & ohp_m[:, None, :])
                & m_any[:, None, None], a_m[:, None, None], neg))
            ptr = torch.where(ohr_m & m_any[:, None],
                              torch.remainder(ptr_m + 1, 4)[:, None], ptr)
        # phase-boundary re-base (shift 0 off-boundary, as in the JAX step)
        shift = pmf.max() if bnd else zero
        lo = shift + NEG_INF32
        avail, act, bus, hist = (torch.maximum(x, lo) - shift
                                 for x in (avail, act, bus, hist))
        if bnd:
            pmf = torch.zeros_like(pmf)
        return (avail, act, bus, hist, ptr, pmf), fin_out

    return step


def dram_serve_ref(issue: torch.Tensor, meta: torch.Tensor,
                   boundary: torch.Tensor, timing: torch.Tensor,
                   state: State):
    """Serve a blocked ``[S, C, K]`` program from ``state`` (the 6-tuple
    in-scan carry); returns ``(finish[S, C, K], state)``."""
    S, C, K = issue.shape
    avail, act, bus, hist, ptr, pmf = state
    B = avail.shape[1]
    R = hist.shape[1]
    step = make_serve_step(timing.tolist(), C, B, R, K, B // R,
                           issue.device)
    live = ((meta & META_VALID) != 0).flatten(1).any(dim=1) | (boundary != 0)
    idx = torch.nonzero(live).flatten()
    n_live = int(idx[-1]) + 1 if len(idx) else 0
    bnd = boundary[:n_live].tolist()
    fin = torch.zeros_like(issue)
    state = tuple(state)
    for s in range(n_live):
        state, fin[s] = step(state, issue[s], meta[s], bnd[s])
    if n_live < S:
        # the all-invalid tail: mx = 0 clamps bus and pmf at 0, and the
        # zero-shift re-base clamps the time carry at NEG_INF32
        avail, act, bus, hist, ptr, pmf = state
        avail, act, hist = (torch.clamp_min(x, NEG_INF32)
                            for x in (avail, act, hist))
        bus = torch.clamp_min(bus, 0)
        pmf = torch.clamp_min(pmf, 0)
        state = (avail, act, bus, hist, ptr, pmf)
    return fin, state


def _case(x: torch.Tensor, m: int, batched: bool) -> torch.Tensor:
    return x[m] if batched else x


def dram_serve_batch_ref(issue: torch.Tensor, meta: torch.Tensor,
                         boundary: torch.Tensor, timing: torch.Tensor,
                         state: State):
    """:func:`dram_serve_ref` over M cases: ``timing[M, 7]``, each carry
    with a leading case axis, and the program either stacked
    (``issue``/``meta`` ``[M, S, C, K]``, ``boundary[M, S]``) or shared by
    every case (``[S, C, K]``, ``[S]``).  Returns ``(finish[M, S, C, K],
    state)``, case by case."""
    batched = issue.dim() == 4
    fins, states = [], []
    for m in range(timing.shape[0]):
        fin, st = dram_serve_ref(
            _case(issue, m, batched), _case(meta, m, batched),
            _case(boundary, m, batched), timing[m],
            tuple(x[m] for x in state))
        fins.append(fin)
        states.append(st)
    return torch.stack(fins), tuple(torch.stack(xs) for xs in zip(*states))


def serve_prepass_batch_ref(issue: torch.Tensor, meta: torch.Tensor,
                            boundary: torch.Tensor, timing: torch.Tensor,
                            banks_per_rank: int, R: int,
                            S_pad: int) -> torch.Tensor:
    """:func:`serve_prepass_ref` over M cases (program stacked or shared,
    as :func:`dram_serve_batch_ref` takes it): records ``[M, C, S_pad, K,
    2]``."""
    batched = issue.dim() == 4
    return torch.stack([
        serve_prepass_ref(_case(issue, m, batched), _case(meta, m, batched),
                          _case(boundary, m, batched), timing[m],
                          banks_per_rank, R, S_pad)
        for m in range(timing.shape[0])])


def serve_records_batch_ref(rec: torch.Tensor, timing: torch.Tensor,
                            state: State, S: int):
    """:func:`serve_records_ref` over the M cases of batched records."""
    fins, states = [], []
    for m in range(rec.shape[0]):
        fin, st = serve_records_ref(rec[m], timing[m],
                                    tuple(x[m] for x in state), S)
        fins.append(fin)
        states.append(st)
    return torch.stack(fins), tuple(torch.stack(xs) for xs in zip(*states))


#: record-only bits of the serve's pre-pass (``csrc/dram_serve.cu``): the
#: block holds a valid miss, the miss's rank (8 bits), the step ends a
#: phase, the block holds no valid lane
REC_M_ANY = 1 << 16
REC_RANK_SHIFT = 17
REC_BOUNDARY = 1 << 25
REC_EMPTY = 1 << 26


def serve_prepass_ref(issue: torch.Tensor, meta: torch.Tensor,
                      boundary: torch.Tensor, timing: torch.Tensor,
                      banks_per_rank: int, R: int,
                      S_pad: int) -> torch.Tensor:
    """The carry-free part of every step of a ``[S, C, K]`` program, as
    int32 records ``[C, S_pad, K, 2]``: lane ``k`` of channel ``c`` at
    step ``s`` holds ``x`` (the lane's issue for a miss, else ``own``, the
    max over lanes ``j <= k`` on its bank of ``iss_j - rank_j * tBL``) and
    ``meta'`` (meta's low 16 bits, ``REC_M_ANY``, the miss rank, the
    boundary flag, ``REC_EMPTY``).  Steps past S are empty blocks."""
    S, C, K = issue.shape
    tBL = int(timing[4])
    b = meta & 0xFF
    ms = (meta & META_MISS) != 0
    v = (meta & META_VALID) != 0
    rb_tbl = ((meta >> META_RB_SHIFT) & META_RB_MASK) * tBL
    lane = torch.arange(K, device=issue.device)
    tril = lane[:, None] >= lane[None, :]
    same = (b[..., :, None] == b[..., None, :]) & tril        # [S, C, K, K]
    own = torch.where(same, (issue - rb_tbl)[..., None, :],
                      NEG_INF32).amax(dim=-1)
    mv = ms & v
    rank = (torch.div(b, banks_per_rank, rounding_mode="floor") if R > 1
            else torch.zeros_like(b))
    rank_m = torch.where(mv, rank, 0).amax(dim=-1, keepdim=True)
    flags = (torch.where(mv.any(dim=-1, keepdim=True), REC_M_ANY, 0)
             | ((rank_m & 0xFF) << REC_RANK_SHIFT)
             | torch.where(boundary != 0, REC_BOUNDARY, 0)[:, None, None]
             | torch.where(v.any(dim=-1, keepdim=True), 0, REC_EMPTY))
    rec = torch.zeros((C, S_pad, K, 2), dtype=torch.int32,
                      device=issue.device)
    rec[:, S:, :, 1] = REC_EMPTY
    rec[:, :S, :, 0] = torch.where(ms, issue, own).transpose(0, 1)
    rec[:, :S, :, 1] = ((meta & 0xFFFF) | flags).transpose(0, 1).to(
        torch.int32)
    return rec


def _record_stepper(timing, B: int, R: int, K: int, device):
    """The record walk's step over ``N`` independent rows (a row a
    channel in :func:`serve_records_ref`, a row a (channel, chunk) in the
    chunked emit): ``step(x[N,K], mt[N,K], (avail, act, bus, hist, ptr,
    pmf)) -> (fin_out[N,K], state)``, int32 that wraps, no phase
    boundary (the caller re-bases)."""
    tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (int(t) for t in timing)
    bank_ids = torch.arange(B, device=device)
    rank_ids = torch.arange(R, device=device)
    ptr_ids = torch.arange(4, device=device)
    lane = torch.arange(K, device=device, dtype=torch.int32)
    lane_tbl, lane_tbl1 = lane * tBL, (lane + 1) * tBL
    tril = lane[:, None] >= lane[None, :]

    def step(x, mt, state):
        avail, act, bus, hist, ptr, pmf = state
        b = mt & 0xFF
        ms = (mt & META_MISS) != 0
        cf = (mt & META_CONFL) != 0
        v = (mt & META_VALID) != 0
        rb_tbl = ((mt >> META_RB_SHIFT) & META_RB_MASK) * tBL
        m_any = (mt[:, 0] & REC_M_ANY) != 0                 # [N]
        rank_m = (mt[:, 0] >> REC_RANK_SHIFT) & 0xFF        # [N]
        ohb = b[:, :, None] == bank_ids                     # [N, K, B]
        avail_b = torch.where(ohb, avail[:, None, :], NEG_INF32).amax(2)
        act_b = torch.where(ohb, act[:, None, :], NEG_INF32).amax(2)
        if R == 1:
            ptr_m, hist_m = ptr[:, 0], hist[:, 0]
        else:
            ohr = rank_m[:, None] == rank_ids               # [N, R]
            ptr_m = torch.where(ohr, ptr, 0).amax(1)
            hist_m = torch.where(ohr[:, :, None], hist, NEG_INF32).amax(1)
        hist_p = torch.where(ptr_m[:, None] == ptr_ids, hist_m,
                             NEG_INF32).amax(1)
        last_r = torch.where(torch.remainder(ptr_m + 3, 4)[:, None]
                             == ptr_ids, hist_m, NEG_INF32).amax(1)
        floor = torch.maximum(last_r + tRRD, hist_p + tFAW)
        base = torch.maximum(x, avail_b)
        pre = torch.where(cf, torch.maximum(base, act_b + tRAS) + tRP, base)
        a = torch.maximum(pre, floor[:, None])
        col = torch.where(ms & m_any[:, None], a + tRCD,
                          rb_tbl + torch.maximum(x, avail_b))
        cadj = torch.where(v, col + tCL - lane_tbl, NEG_INF32)
        ccm = torch.where(tril, cadj[:, None, :], NEG_INF32).amax(2)
        fin_out = torch.where(v, lane_tbl1 + torch.maximum(bus[:, None],
                                                           ccm), 0)
        mx = fin_out.amax(1)
        bus = torch.maximum(bus, mx)
        pmf = torch.maximum(pmf, mx)
        mv = ms & v
        avail = torch.maximum(avail, torch.where(
            ohb & v[:, :, None], (col + tBL)[:, :, None], NEG_INF32).amax(1))
        act = torch.maximum(act, torch.where(
            ohb & mv[:, :, None], a[:, :, None], NEG_INF32).amax(1))
        a_m = torch.where(mv, a, NEG_INF32).amax(1)
        r = rank_m if R > 1 else torch.zeros_like(rank_m)
        hit = m_any & (r < R)
        if hit.any():
            hist, ptr = hist.clone(), ptr.clone()
            c = torch.nonzero(hit).flatten()
            rr, p = r[hit].long(), ptr_m[hit]
            ok = (p >= 0) & (p < 4)
            hist[c[ok], rr[ok], p[ok].long()] = torch.maximum(
                hist[c[ok], rr[ok], p[ok].long()], a_m[hit][ok])
            ptr[c, rr] = torch.remainder(p + 1, 4).to(ptr.dtype)
        return fin_out, (avail, act, bus, hist, ptr, pmf)

    return step


def _rebase(state, shift):
    """The phase boundary's re-base of a carry by ``shift`` (one value, or
    one a row), in int32 as the record walk does it."""
    avail, act, bus, hist, ptr, pmf = state
    sh = shift.reshape(-1)

    def down(x):
        by = sh.view((-1,) + (1,) * (x.dim() - 1))
        return torch.maximum(x, by + NEG_INF32) - by

    return down(avail), down(act), down(bus), down(hist), ptr, \
        torch.zeros_like(pmf)


def serve_records_ref(rec: torch.Tensor, timing: torch.Tensor,
                      state: State, S: int):
    """The serve's carry chain over the first ``S`` steps of the records
    of :func:`serve_prepass_ref`, one Python-loop iteration a step, from
    the 6-tuple carry ``state``; returns ``(finish[S, C, K], state)``,
    equal to :func:`dram_serve_ref` on the program the records came
    from."""
    C, _, K, _ = rec.shape
    state = tuple(x.clone() for x in state)
    B, R = state[0].shape[1], state[3].shape[1]
    step = _record_stepper(timing.tolist(), B, R, K, rec.device)
    fin = torch.zeros((S, C, K), dtype=torch.int32, device=rec.device)
    for s in range(S):
        mt = rec[:, s, :, 1]
        fin[s], state = step(rec[:, s, :, 0], mt, state)
        if int(mt[0, 0]) & REC_BOUNDARY:
            state = _rebase(state, state[5].max())
    return fin, state


#: the chunked serve's group: pieces whose matrices the carry walk
#: multiplies into prefix products at a time (``csrc/dram_serve.cu``)
SERVE_GROUP = 32


def serve_state_width(B: int, R: int) -> int:
    """Dp, the length of a channel's state vector in the chunked serve:
    its banks' ``avail`` and ``act``, its ranks' ACT histories (ring in
    absolute order), the bus, the phase makespan, a constant 0 (through
    which the records' times and every constant enter) and one unused
    component that makes the length even."""
    return 2 * B + 4 * R + 4


def _mp_mul(a: torch.Tensor, b: torch.Tensor, zero: int) -> torch.Tensor:
    """Max-plus product of row-major matrices ``a (x) b`` over the last
    two axes, held at ``zero`` from below."""
    return torch.clamp_min((a[..., :, :, None] + b[..., None, :, :]).amax(-2),
                           zero)


def serve_records_chunked_ref(rec: torch.Tensor, timing: torch.Tensor,
                              state: State, S: int, T: int,
                              group: int = SERVE_GROUP):
    """The card's chunked serve (``csrc/dram_serve.cu``, the chunked
    route) in torch: what :func:`serve_records_ref` computes, by its
    passes over tiles of ``T`` steps, every tile side by side.

    A tile is cut after each phase's last step into pieces; piece ``p``
    of the call is the ``p``-th such run of steps.

    1. count: per tile, its phase ends and each (channel, rank)'s blocks
       with a miss (each moves the rank's ring pointer on by one);
    2. scan: each tile's entry ring pointers and first piece;
    3. transfer: with every selection fixed by the records, a piece maps
       a channel's state vector (:func:`serve_state_width`) max-plus
       linearly: lane ``j`` walks the tile from the basis vector ``e_j``
       (int64, every constant through the constant-0 component) and gives
       column ``j`` of each piece's matrix;
    4. compose: within groups of ``group`` pieces, prefix products that
       restart after each phase's last piece;
    5. walk: per case, ``s <- P (x) s`` over the groups' runs, and at each
       phase's end the re-base by the makespan over the channels: every
       run's entry state, every phase's shift and the carry out;
    6. emit: each (channel, tile) walked once more from its entry state,
       in int32 by :func:`serve_records_ref`'s own step, taking each
       phase's shift from the walk.

    Exact wherever the int32 walk does not wrap (the serve's route checks
    a bound on that before it takes this one).  Returns ``(finish[S, C,
    K], state)``."""
    C, _, K, _ = rec.shape
    state = tuple(x.clone() for x in state)
    avail, act, bus, hist, ptr, pmf = state
    B, R = avail.shape[1], hist.shape[1]
    dev = rec.device
    if S == 0:
        return torch.zeros((0, C, K), dtype=torch.int32, device=dev), state
    tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW = (int(t) for t in
                                             timing.tolist())
    Dp = serve_state_width(B, R)
    HI, BUS = 2 * B, 2 * B + 4 * R
    PMF, Z = BUS + 1, BUS + 2
    NEG = -(1 << 61)
    i64 = dict(dtype=torch.int64, device=dev)
    nt = -(-S // T)

    def tiles(v):                      # [C, S, ...] -> [C, nt, T, ...]
        pad = torch.zeros((C, nt * T - S) + v.shape[2:], dtype=v.dtype,
                          device=dev)
        return torch.cat([v, pad], 1).view((C, nt, T) + v.shape[2:])

    x, mt = tiles(rec[:, :S, :, 0].long()), tiles(rec[:, :S, :, 1].long())
    live = (torch.arange(nt * T, device=dev) < S).view(nt, T)
    mt0 = mt[..., 0]
    bnd = ((mt0[0] & REC_BOUNDARY) != 0) & live                # [nt, T]
    m_any = ((mt0 & REC_M_ANY) != 0) & live                    # [C, nt, T]
    rank = (torch.zeros_like(mt0) if R == 1
            else (mt0 >> REC_RANK_SHIFT) & 0xFF)
    moves = m_any & (rank < R)

    # 1. count
    miss = torch.stack([(moves & (rank == r)).sum(-1) for r in range(R)],
                       -1)                                     # [C, nt, R]
    n_steps = live.sum(-1)
    lastb = bnd[torch.arange(nt, device=dev), n_steps - 1]
    npieces = bnd.sum(-1) + (~lastb).long()

    # 2. scan
    ptr_entry = (ptr.long()[:, None, :] + miss.cumsum(1) - miss) % 4
    ptr_out = (ptr.long() + miss.sum(1)) % 4
    pbase = npieces.cumsum(0) - npieces
    NP = int(npieces.sum())

    # 3. transfer: lane j of every (channel, tile) from e_j
    L = Dp
    eye = torch.arange(Dp, device=dev)
    ident = torch.where(eye[:, None] == eye, 0, NEG).to(torch.int64)
    st = ident.expand(C, nt, L, Dp).clone()                    # [.., j, i]
    p = ptr_entry.clone()
    mats = torch.full((C, NP, Dp, Dp), NEG, **i64)
    ends = torch.zeros(NP, dtype=torch.bool, device=dev)
    local = torch.zeros(nt, dtype=torch.long, device=dev)
    lane_ids = torch.arange(K, device=dev)
    t_ids = torch.arange(nt, device=dev)

    def put(done):
        idx = pbase[done] + local[done]
        mats[:, idx] = torch.clamp_min(st[:, done], NEG).transpose(-1, -2)
        return idx

    for i in range(T):
        xi, mi = x[:, :, i], mt[:, :, i]                       # [C, nt, K]
        zc = st[..., Z][..., None]                             # [C, nt, L, 1]
        b = mi & 0xFF
        ms = (mi & META_MISS) != 0
        cf = (mi & META_CONFL) != 0
        v = (mi & META_VALID) != 0
        rb_tbl = ((mi >> META_RB_SHIFT) & META_RB_MASK) * tBL
        in_b = b < B
        bb = torch.where(in_b, b, 0)

        def comp(idx):                                         # [C,nt,K]
            return torch.gather(st, 3, idx[:, :, None, :].expand(
                C, nt, L, idx.shape[-1]))

        av = torch.where(in_b[:, :, None], comp(bb), zc + NEG_INF32)
        at = torch.where(in_b[:, :, None], comp(B + bb), zc + NEG_INF32)
        base = torch.maximum(zc + xi[:, :, None], av)
        many = m_any[:, :, i]
        rr = torch.zeros_like(rank[:, :, i]) if R == 1 else torch.clamp_max(
            rank[:, :, i], R - 1)
        ok = moves[:, :, i]
        pm = torch.gather(p, 2, rr[..., None]).squeeze(-1)     # [C, nt]
        h_p = comp((HI + 4 * rr + pm)[..., None]).squeeze(-1)
        h_l = comp((HI + 4 * rr + (pm + 3) % 4)[..., None]).squeeze(-1)
        zneg = zc[..., 0] + NEG_INF32
        inr = rank[:, :, i] < R
        h_p = torch.where(inr[..., None], torch.maximum(h_p, zneg), zneg)
        h_l = torch.where(inr[..., None], torch.maximum(h_l, zneg), zneg)
        floor = torch.maximum(h_l + tRRD, h_p + tFAW)          # [C, nt, L]
        pre = torch.where(cf[:, :, None],
                          torch.maximum(base, at + tRAS) + tRP, base)
        a = torch.maximum(pre, floor[..., None])
        col = torch.where((ms & many[..., None])[:, :, None], a + tRCD,
                          rb_tbl[:, :, None] + base)
        cadj = torch.where(v[:, :, None], col + tCL - lane_ids * tBL,
                           zc + NEG_INF32)
        ccm = cadj.cummax(-1).values
        fin = torch.where(v[:, :, None], (lane_ids + 1) * tBL
                          + torch.maximum(st[..., BUS][..., None], ccm), zc)
        mx = fin.amax(-1)
        new = st.clone()
        new[..., BUS] = torch.maximum(st[..., BUS], mx)
        new[..., PMF] = torch.maximum(st[..., PMF], mx)
        idx = bb[:, :, None, :].expand(C, nt, L, K)
        upd = torch.where((v & in_b)[:, :, None], col + tBL, NEG)
        new[..., :B] = torch.maximum(
            st[..., :B].scatter_reduce(3, idx, upd, "amax"), zc + NEG_INF32)
        mv = ms & v
        upd = torch.where((mv & in_b)[:, :, None], a, NEG)
        new[..., B:HI] = torch.maximum(
            st[..., B:HI].scatter_reduce(3, idx, upd, "amax"),
            zc + NEG_INF32)
        a_m = torch.where(mv[:, :, None], a, zc + NEG_INF32).amax(-1)
        hidx = (HI + 4 * rr + pm)[:, :, None, None].expand(C, nt, L, 1)
        h_now = torch.gather(st, 3, hidx).squeeze(-1)
        new.scatter_(3, hidx, torch.where(
            ok[..., None], torch.maximum(h_now, a_m), h_now)[..., None])
        p.scatter_(2, rr[..., None], torch.where(ok, (pm + 1) % 4,
                                                 pm)[..., None])
        st = torch.where(live[:, i][None, :, None, None], new, st)
        done = bnd[:, i]
        if bool(done.any()):
            ends[put(done)] = True
            st[:, done] = ident
            local += done.long()
    put(~lastb)

    # 4. compose: prefix products within a group's runs
    starts = torch.ones(NP, dtype=torch.bool, device=dev)
    starts[1:] = ends[:-1]
    starts[::group] = True
    pref = mats.clone()
    for j in range(1, group):
        ps = torch.arange(j, NP, group, device=dev)
        if len(ps) == 0:
            break
        keep = starts[ps][None, :, None, None]
        pref[:, ps] = torch.where(keep, mats[:, ps],
                                  _mp_mul(mats[:, ps], pref[:, ps - 1], NEG))

    # 5. walk
    s = torch.full((C, Dp), NEG, **i64)
    s[:, :B], s[:, B:HI] = avail.long(), act.long()
    s[:, HI:BUS] = hist.long().view(C, 4 * R)
    s[:, BUS], s[:, PMF], s[:, Z] = bus.long(), pmf.long(), 0
    entry = torch.full((C, NP, Dp), NEG, **i64)
    shift = torch.zeros(NP, **i64)
    run_end = ends.clone()
    run_end[group - 1::group] = True
    run_end[-1] = True
    first = 0
    for q in torch.nonzero(run_end).flatten().tolist():
        entry[:, first] = s
        s = (pref[:, q] + s[:, None, :]).amax(-1)
        if bool(ends[q]):
            sh = s[:, PMF].max()
            s[:, :PMF] = torch.maximum(s[:, :PMF], sh + NEG_INF32) - sh
            s[:, PMF] = 0
            shift[q] = sh
        first = q + 1

    # 6. emit: (channel, tile) rows, from each tile's entry state
    p0 = pbase
    rs = p0.clone()
    while True:
        back = (rs % group != 0) & ~ends[rs - 1]
        if not bool(back.any()):
            break
        rs = torch.where(back, rs - 1, rs)
    e = entry[:, rs]                                           # [C, nt, Dp]
    mid = rs != p0
    e = torch.where(mid[None, :, None], (pref[:, (p0 - 1).clamp_min(0)]
                                         + e[:, :, None, :]).amax(-1), e)
    e = e.to(torch.int32).view(C * nt, Dp)
    row = (e[:, :B], e[:, B:HI], e[:, BUS], e[:, HI:BUS].reshape(-1, R, 4),
           ptr_entry.reshape(C * nt, R).to(ptr.dtype), e[:, PMF])
    step = _record_stepper(timing.tolist(), B, R, K, dev)
    fin = torch.zeros((C, nt, T, K), dtype=torch.int32, device=dev)
    xr = x.to(torch.int32).view(C * nt, T, K)
    mr = mt.to(torch.int32).view(C * nt, T, K)
    piece = p0.repeat(C)
    for i in range(T):
        f, new = step(xr[:, i], mr[:, i], row)
        on = live[:, i].repeat(C)
        fin[:, :, i] = f.view(C, nt, K)
        row = tuple(torch.where(on.view((-1,) + (1,) * (a.dim() - 1)), a, o)
                    for a, o in zip(new, row))
        at_end = bnd[:, i].repeat(C)
        if bool(at_end.any()):
            sh = shift[piece.clamp_max(NP - 1)].to(torch.int32)
            moved = _rebase(row, sh)
            row = tuple(torch.where(at_end.view((-1,) + (1,) * (a.dim() - 1)),
                                    a, o) for a, o in zip(moved, row))
            piece = piece + at_end.long()
    finish = fin.view(C, nt * T, K)[:, :S].transpose(0, 1).contiguous()
    out = (s[:, :B].to(torch.int32), s[:, B:HI].to(torch.int32),
           s[:, BUS].to(torch.int32),
           s[:, HI:BUS].reshape(C, R, 4).to(torch.int32),
           ptr_out.to(ptr.dtype), s[:, PMF].to(torch.int32))
    return finish, out


def serve_records_chunked_batch_ref(rec: torch.Tensor, timing: torch.Tensor,
                                    state: State, S: int, T: int,
                                    group: int = SERVE_GROUP):
    """:func:`serve_records_chunked_ref` over the M cases of batched
    records."""
    fins, states = [], []
    for m in range(rec.shape[0]):
        fin, st = serve_records_chunked_ref(
            rec[m], timing[m], tuple(x[m] for x in state), S, T, group)
        fins.append(fin)
        states.append(st)
    return torch.stack(fins), tuple(torch.stack(xs) for xs in zip(*states))
