"""Public wrappers of the two DRAM-timing kernels.

* ``dram_serve`` — the blocked ``[S, C, K]`` multi-phase serve
  (``csrc/dram_serve.cu``): a carry-free pre-pass (``serve_prepass``)
  and the carry chain over its records (``serve_records``);
* ``dram_serve_batch`` — the same serve for M cases at once (a sweep's
  timing grid: one shared program, or M stacked ones), one CTA a case
  (``serve_prepass_batch``, ``serve_records_batch``);
* ``dram_timing`` — the per-channel ``[C, L]`` scan of one phase as a
  chunked max-plus scan (``csrc/dram_timing.cu``; :func:`dram_timing_chunks`
  takes the chunk length), and :func:`simulate_trace` around it;
* ``dram_timing_serial`` — the same scan by one lane a channel
  (``csrc/dram_timing_serial.cu``), which the chunked scan is held
  against; no path calls it.

Each wrapper checks its inputs, then launches the CUDA kernel for CUDA
tensors or runs the plain version (``ref.py``) for CPU tensors.  There
is no fallback: a CUDA tensor goes to the kernel or the call raises.
The single-case serve launches the batched serve's two kernels on one
case.
``dram_serve.launches`` (the serve's carry chain, from ``dram_serve``
or ``serve_records``), ``serve_prepass.launches``,
``dram_serve_batch.launches`` (from ``dram_serve_batch`` or
``serve_records_batch``), ``serve_prepass_batch.launches``,
``dram_timing.launches`` (from ``dram_timing`` or
``dram_timing_chunks``) and ``dram_timing_serial.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.dram import DRAMConfig
from repro_torch.core.trace import Trace
from repro_torch.core.vectorized import (MAX_PHASE_ISSUE, NEG_INF32,
                                         init_channel_carry, pack_channels,
                                         timing_params)
from repro_torch.device import resolve_device
from repro_torch.kernels import count_launch
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.dram_timing.ref import (dram_serve_batch_ref,
                                                 dram_serve_ref,
                                                 dram_timing_chunked_ref,
                                                 dram_timing_ref,
                                                 dram_timing_serial_ref,
                                                 serve_prepass_batch_ref,
                                                 serve_prepass_ref,
                                                 serve_records_batch_ref,
                                                 serve_records_ref)

State = Tuple[torch.Tensor, ...]


def _check(issue, meta, boundary, timing, state):
    """The input check of :func:`dram_serve`: :func:`_check_batch` on the
    one case.  Returns ``(S, C, K, B, R)``."""
    if not isinstance(issue, torch.Tensor) or issue.dim() != 3:
        raise ValueError("issue must be an [S, C, K] tensor")
    if not isinstance(timing, torch.Tensor):
        raise TypeError(f"expected torch tensors, got {type(timing)}")
    _, S, C, K, B, R = _check_batch(
        issue, meta, boundary, timing[None],
        tuple(x[None] if isinstance(x, torch.Tensor) else x for x in state))
    return S, C, K, B, R


#: records a ring slot of the serve holds, and the shared memory the
#: rings may take (``csrc/dram_serve.cu``)
RING_SLOTS = 4
RING_BYTES = 96 * 1024
MAX_CHUNK_STEPS = 64


def chunk_steps(C: int, K: int) -> int:
    """Steps a ring slot of the serve holds for ``C`` channels of ``K``
    lanes: a power of two, at most 64, at least 2 (a bulk copy moves a
    multiple of 16 bytes), so the rings fit in ``RING_BYTES``."""
    T = MAX_CHUNK_STEPS
    while T > 2 and C * RING_SLOTS * T * K * 8 > RING_BYTES:
        T //= 2
    return T


def dram_serve(issue: torch.Tensor, meta: torch.Tensor,
               boundary: torch.Tensor, timing: torch.Tensor,
               state: State):
    """Serve a blocked ``[S, C, K]`` program from ``state`` (the in-scan
    carry ``(avail[C,B], act[C,B], bus[C], hist[C,R,4], ptr[C,R],
    pmf[C])``), all int32; ``boundary[S]`` is nonzero on each phase's last
    step, ``timing`` the int32[7] vector (tCL, tRCD, tRP, tRAS, tBL, tRRD,
    tFAW).  Returns ``(finish[S, C, K], state)``, bit-identical to the JAX
    package's fused scan.  On the card: the carry-free pre-pass
    (:func:`serve_prepass`), then the serve over its records
    (:func:`serve_records`); on the CPU the plain step loop."""
    S, C, K, B, R = _check(issue, meta, boundary, timing, state)
    if issue.device.type == "cpu":
        return dram_serve_ref(issue, meta, boundary, timing, state)
    if S == 0:
        return torch.empty_like(issue), tuple(x.clone() for x in state)
    rec = serve_prepass(issue, meta, boundary, timing, B // R, R,
                        chunk_steps(C, K))
    return serve_records(rec, timing, state, S)


def serve_prepass(issue: torch.Tensor, meta: torch.Tensor,
                  boundary: torch.Tensor, timing: torch.Tensor,
                  banks_per_rank: int, R: int, T: int) -> torch.Tensor:
    """The carry-free part of every step: int32 records ``[C, S_pad, K,
    2]`` (``S_pad`` = S rounded up to ``T``), lane ``k`` of channel ``c``
    at step ``s`` holding ``(x, meta')`` as :func:`~.ref.serve_prepass_ref`
    defines them.  One launch on the card (the batched pre-pass on one
    case); the plain version for CPU tensors.  Inputs as
    :func:`dram_serve` takes them (checked there)."""
    if issue.device.type == "cpu":
        S_pad = -(-issue.shape[0] // T) * T
        return serve_prepass_ref(issue, meta, boundary, timing,
                                 banks_per_rank, R, S_pad)
    rec = _launch_prepass(issue, meta, boundary, timing[None],
                          banks_per_rank, R, T, "serve_prepass")
    count_launch(serve_prepass)
    return rec[0]


serve_prepass.launches = 0


def serve_records(rec: torch.Tensor, timing: torch.Tensor, state: State,
                  S: int):
    """The serve's carry chain over the first ``S`` steps of the records
    ``rec`` (:func:`serve_prepass`) from ``state``; returns ``(finish[S,
    C, K], state)``.  One launch on the card (the batched serve on one
    case, counted in ``dram_serve.launches``); the plain record walk for
    CPU tensors."""
    if rec.device.type == "cpu":
        return serve_records_ref(rec, timing, state, S)
    fin, out = _launch_records(rec[None], timing[None],
                               tuple(x[None] for x in state), S,
                               "dram_serve")
    count_launch(dram_serve)
    return fin[0], tuple(x[0] for x in out)


dram_serve.launches = 0


#: cases a batched serve takes in one call (the pre-pass puts the case
#: axis on the grid's y dimension)
MAX_CASES = 65535


def _check_batch(issue, meta, boundary, timing, state):
    """The input check of :func:`dram_serve_batch`: :func:`_check`'s
    contract on every case.  Returns ``(M, S, C, K, B, R)``."""
    if len(state) != 6:
        raise ValueError(f"state must be the 6-tuple carry, got "
                         f"{len(state)} arrays")
    dev = issue.device
    for t in (issue, meta, boundary, timing) + tuple(state):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        if t.dtype != torch.int32:
            raise TypeError(f"the serve takes int32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("the serve takes contiguous tensors")
    if timing.dim() != 2 or timing.shape[1] != 7 or timing.shape[0] < 1:
        raise ValueError(f"timing must be [M, 7] with M >= 1, got "
                         f"{tuple(timing.shape)}")
    M = timing.shape[0]
    if M > MAX_CASES:
        raise ValueError(f"at most {MAX_CASES} cases a call, got {M}")
    shared = issue.dim() == 3
    if not shared and issue.dim() != 4:
        raise ValueError(f"issue must be [S, C, K] (shared) or [M, S, C, "
                         f"K], got {tuple(issue.shape)}")
    if not shared and issue.shape[0] != M:
        raise ValueError(f"issue holds {issue.shape[0]} cases, timing {M}")
    S, C, K = issue.shape[-3:]
    avail, act, bus, hist, ptr, pmf = state
    if avail.dim() != 3 or hist.dim() != 4:
        raise ValueError("avail must be [M, C, B] and hist [M, C, R, 4]")
    B, R = avail.shape[2], hist.shape[2]
    lead = () if shared else (M,)
    want = {"meta": (tuple(issue.shape), meta),
            "boundary": (lead + (S,), boundary),
            "avail": ((M, C, B), avail), "act": ((M, C, B), act),
            "bus": ((M, C), bus), "hist": ((M, C, R, 4), hist),
            "ptr": ((M, C, R), ptr), "pmf": ((M, C), pmf)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if C < 1 or K < 1 or K > 32 or K & (K - 1):
        raise ValueError(f"need C >= 1 and K a power of two <= 32, got "
                         f"C={C}, K={K}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the serve runs on CUDA or CPU, not {dev}")
    if dev.type == "cuda" and C > 32:
        raise ValueError(f"the serve runs a warp a channel: C = {C} > 32")
    if R < 1 or B % R:
        raise ValueError(f"banks ({B}) must split evenly over ranks ({R})")
    if S and (int(issue.min()) < 0 or int(issue.max()) >= MAX_PHASE_ISSUE):
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    if any(int(x.min()) < NEG_INF32 for x in (avail, act, bus, hist, pmf)
           if x.numel()):
        raise ValueError("carry holds times below NEG_INF32")
    if ptr.numel() and (int(ptr.min()) < 0 or int(ptr.max()) > 3):
        raise ValueError("ACT-history pointers must lie in [0, 4)")
    return M, S, C, K, B, R


def dram_serve_batch(issue: torch.Tensor, meta: torch.Tensor,
                     boundary: torch.Tensor, timing: torch.Tensor,
                     state: State):
    """Serve M cases of one shape at once: ``timing[M, 7]`` and the
    6-tuple carry with a leading case axis (``avail[M, C, B]``, ...,
    ``pmf[M, C]``), against one program shared by every case
    (``issue``/``meta`` ``[S, C, K]``, ``boundary[S]``) or M stacked
    programs (``[M, S, C, K]``, ``[M, S]``), all int32.  Returns
    ``(finish[M, S, C, K], state)``, case m equal to :func:`dram_serve`
    on case m's inputs.  On the card: the pre-pass for every case
    (:func:`serve_prepass_batch`, one launch), then one CTA a case
    (:func:`serve_records_batch`, one launch); for CPU tensors the plain
    version, case by case."""
    M, S, C, K, B, R = _check_batch(issue, meta, boundary, timing, state)
    if issue.device.type == "cpu":
        return dram_serve_batch_ref(issue, meta, boundary, timing, state)
    if S == 0:
        return (torch.empty((M, 0, C, K), dtype=torch.int32,
                            device=issue.device),
                tuple(x.clone() for x in state))
    rec = serve_prepass_batch(issue, meta, boundary, timing, B // R, R,
                              chunk_steps(C, K))
    return serve_records_batch(rec, timing, state, S)


dram_serve_batch.launches = 0


def serve_prepass_batch(issue: torch.Tensor, meta: torch.Tensor,
                        boundary: torch.Tensor, timing: torch.Tensor,
                        banks_per_rank: int, R: int, T: int) -> torch.Tensor:
    """:func:`serve_prepass` for M cases (inputs as
    :func:`dram_serve_batch` takes them, checked there): records ``[M, C,
    S_pad, K, 2]``, each case's with its own ``tBL``.  One launch on the
    card; the plain version for CPU tensors."""
    if issue.device.type == "cpu":
        S_pad = -(-issue.shape[-3] // T) * T
        return serve_prepass_batch_ref(issue, meta, boundary, timing,
                                       banks_per_rank, R, S_pad)
    rec = _launch_prepass(issue, meta, boundary, timing, banks_per_rank, R,
                          T, "serve_prepass_batch")
    count_launch(serve_prepass_batch)
    return rec


serve_prepass_batch.launches = 0


def serve_records_batch(rec: torch.Tensor, timing: torch.Tensor,
                        state: State, S: int):
    """:func:`serve_records` for M cases, one CTA a case, over the records
    of :func:`serve_prepass_batch`; returns ``(finish[M, S, C, K],
    state)``.  One launch on the card (counted in
    ``dram_serve_batch.launches``); the plain record walk for CPU
    tensors."""
    if rec.device.type == "cpu":
        return serve_records_batch_ref(rec, timing, state, S)
    fin, out = _launch_records(rec, timing, state, S, "dram_serve_batch")
    count_launch(dram_serve_batch)
    return fin, out


def _launch_prepass(issue, meta, boundary, timing, banks_per_rank, R, T,
                    name):
    """One launch of the pre-pass for ``timing[M, 7]`` against a shared
    ``[S, C, K]`` program or M stacked ones; returns the records ``[M, C,
    S_pad, K, 2]``."""
    M = timing.shape[0]
    shared = issue.dim() == 3
    S, C, K = issue.shape[-3:]
    S_pad = -(-S // T) * T
    rec = torch.empty((M, C, S_pad, K, 2), dtype=torch.int32,
                      device=issue.device)
    with torch.cuda.device(issue.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_dram_serve_prepass_batch(
            issue.data_ptr(), meta.data_ptr(), boundary.data_ptr(),
            timing.data_ptr(), rec.data_ptr(), S, S_pad, C, K, R,
            banks_per_rank, M, int(shared), stream)
    check_launch(code, name)
    return rec


def _launch_records(rec, timing, state, S, name):
    """One launch of the serve, a CTA for each of the M cases of the
    records ``rec[M, C, S_pad, K, 2]``, from ``state`` (case axis first);
    returns ``(finish[M, S, C, K], state)``."""
    M, C, S_pad, K, _ = rec.shape
    B, R = state[0].shape[2], state[3].shape[2]
    T = chunk_steps(C, K)
    if S_pad % T or S_pad < S:
        raise ValueError(f"records of {S_pad} steps do not cover {S} steps "
                         f"in chunks of {T}")
    fin = torch.empty((M, S, C, K), dtype=torch.int32, device=rec.device)
    out = tuple(torch.empty_like(x) for x in state)
    with torch.cuda.device(rec.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = library().repro_dram_serve_batch(
            rec.data_ptr(), timing.data_ptr(),
            *(x.data_ptr() for x in state), fin.data_ptr(),
            *(x.data_ptr() for x in out), S, S_pad, T, C, K, B, R, M, stream)
    check_launch(code, name)
    return fin, out


def _check_timing(issue, bank, row, valid, timing, carry):
    if len(carry) != 7:
        raise ValueError(f"carry must be the 7-tuple channel carry, got "
                         f"{len(carry)} arrays")
    dev = issue.device
    for t in (issue, bank, row, valid, timing) + tuple(carry):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected torch tensors, got {type(t)}")
        want = torch.bool if t is valid else torch.int32
        if t.dtype != want:
            raise TypeError(f"dram_timing takes int32 tensors and a bool "
                            f"valid mask, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("dram_timing takes contiguous tensors")
    if issue.dim() != 2:
        raise ValueError(f"issue must be [C, L], got {tuple(issue.shape)}")
    C, L = issue.shape
    open_row, act_time, bank_avail, bus_free, hist, ptr, last = carry
    if open_row.dim() != 2 or ptr.dim() != 2:
        raise ValueError("open_row must be [C, B] and act_ptr [C, R]")
    B, R = open_row.shape[1], ptr.shape[1]
    want = {"bank": ((C, L), bank), "row": ((C, L), row),
            "valid": ((C, L), valid), "timing": ((7,), timing),
            "open_row": ((C, B), open_row), "act_time": ((C, B), act_time),
            "bank_avail": ((C, B), bank_avail), "bus_free": ((C,), bus_free),
            "act_hist": ((C, R, 4), hist), "act_ptr": ((C, R), ptr),
            "last_act": ((C, R), last)}
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if C < 1 or R < 1 or B % R:
        raise ValueError(f"need C >= 1 and banks ({B}) split evenly over "
                         f"ranks ({R}), got C={C}")
    # the kernel's int32 contract, as the packer asserts it: issues are
    # phase-relative and in range; banks and pointers index the carry
    if issue.numel() and (int(issue.min()) < 0
                          or int(issue.max()) >= MAX_PHASE_ISSUE):
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    if bank.numel() and (int(bank.min()) < 0 or int(bank.max()) >= B):
        raise ValueError(f"bank ids must lie in [0, {B})")
    if ptr.numel() and (int(ptr.min()) < 0 or int(ptr.max()) > 3):
        raise ValueError("ACT-history pointers must lie in [0, 4)")
    return C, L, B, R


#: chunk lengths the chunked scan is built for, the chunks its carry scan
#: composes at a time (as ``dram_timing`` runs it, and at most), the kind
#: it gives a slot whose step leaves the int32 range, and its launches, in
#: order (``csrc/dram_timing.cu``)
CHUNK_LENS = (64, 128, 256, 512, 1024, 2048, 4096)
GROUP, MAX_GROUP = 32, 64
KIND_WRAPPED = 3
LAUNCHES = ("summary", "entry_scan", "transfer", "compose", "chain",
            "expand", "emit")


def _check_chunked(C, B, R):
    if R > 32 or B > 256 or B // R > 32:
        raise ValueError(f"the chunked scan takes at most 32 ranks, 256 "
                         f"banks a channel and 32 banks a rank, got R={R}, "
                         f"B={B}")


def chunk_len(C: int, L: int, R: int) -> int:
    """The chunk length ``dram_timing`` runs a ``[C, L]`` phase of ``R``
    ranks a channel with on the card."""
    return int(library().repro_dram_timing_chunk_len(C, L, R))


def _launch_timing(entry, args, carry, C, L, extra=()):
    issue = args[0]
    finish = torch.empty_like(issue)
    kind = torch.empty((C, L), dtype=torch.int8, device=issue.device)
    out = tuple(torch.empty_like(x) for x in carry)
    B, R = carry[0].shape[1], carry[5].shape[1]
    with torch.cuda.device(issue.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = entry(*(a.data_ptr() for a in args),
                     *(x.data_ptr() for x in carry),
                     finish.data_ptr(), kind.data_ptr(),
                     *(x.data_ptr() for x in out),
                     C, L, B, R, B // R, *extra, stream)
    return code, finish, kind, out


def _check_wrapped(kind: torch.Tensor) -> None:
    """The chunked scan's one departure: raise where a valid slot's step
    left the int32 range (the int32 scan would wrap there)."""
    if kind.numel() and int(kind.max()) == KIND_WRAPPED:
        raise ValueError("a step leaves the int32 range (the int32 scan "
                         "would wrap); chunk the trace")


def dram_timing(issue: torch.Tensor, bank: torch.Tensor, row: torch.Tensor,
                valid: torch.Tensor, timing: torch.Tensor, carry: State):
    """Serve one phase of per-channel ``[C, L]`` streams (issue, bank,
    row int32; valid bool) from ``carry``, the 7-tuple ``(open_row[C,B],
    act_time[C,B], bank_avail[C,B], bus_free[C], act_hist[C,R,4],
    act_ptr[C,R], last_act[C,R])``, all int32; ``timing`` is the int32[7]
    vector (tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW).  Returns
    ``(finish int32[C, L], kind int8[C, L], carry)``, bit-identical to
    the JAX package's per-channel scan.  On the card the chunked scan
    (chunks of :func:`chunk_len` slots) computes in int64 and raises
    ``ValueError`` where a step leaves the int32 range, the one place the
    int32 scan would wrap; on the CPU the plain per-slot scan."""
    C, L, B, R = _check_timing(issue, bank, row, valid, timing, carry)
    if issue.device.type == "cpu":
        return dram_timing_ref(issue, bank, row, valid, timing, carry)
    if issue.device.type != "cuda":
        raise ValueError(f"dram_timing runs on CUDA or CPU, not "
                         f"{issue.device}")
    _check_chunked(C, B, R)
    code, finish, kind, out = _launch_timing(
        library().repro_dram_timing, (issue, bank, row, valid, timing),
        carry, C, L)
    check_launch(code, "dram_timing")
    count_launch(dram_timing)
    _check_wrapped(kind)
    return finish, kind, out


dram_timing.launches = 0


def dram_timing_chunks(issue: torch.Tensor, bank: torch.Tensor,
                       row: torch.Tensor, valid: torch.Tensor,
                       timing: torch.Tensor, carry: State, T: int,
                       group: int = GROUP, time_passes: bool = False):
    """:func:`dram_timing` with chunks of ``T`` slots (one of
    :data:`CHUNK_LENS`), the carry scan composing ``group`` chunks'
    matrices at a time (1 to :data:`MAX_GROUP`; 1 walks the chunks one by
    one); returns ``(finish, kind, carry, pass_ms)``, where
    ``pass_ms`` is, with ``time_passes`` on the card, the milliseconds of
    each launch (:data:`LAUNCHES`; compose, chain and expand make the carry
    scan) by CUDA events, else None.  Counted in ``dram_timing.launches``;
    for CPU tensors the plain chunked version
    (:func:`~.ref.dram_timing_chunked_ref`)."""
    C, L, B, R = _check_timing(issue, bank, row, valid, timing, carry)
    if T not in CHUNK_LENS:
        raise ValueError(f"chunk length must be one of {CHUNK_LENS}, got {T}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"group must lie in [1, {MAX_GROUP}], got {group}")
    if issue.device.type == "cpu":
        return dram_timing_chunked_ref(issue, bank, row, valid, timing,
                                       carry, T) + (None,)
    if issue.device.type != "cuda":
        raise ValueError(f"dram_timing runs on CUDA or CPU, not "
                         f"{issue.device}")
    _check_chunked(C, B, R)
    ms = (ctypes.c_float * len(LAUNCHES))() if time_passes else None
    code, finish, kind, out = _launch_timing(
        library().repro_dram_timing_chunks,
        (issue, bank, row, valid, timing), carry, C, L,
        (T, group, ctypes.cast(ms, ctypes.c_void_p) if ms else None))
    check_launch(code, "dram_timing")
    count_launch(dram_timing)
    _check_wrapped(kind)
    return finish, kind, out, list(ms) if ms else None


def dram_timing_serial(issue: torch.Tensor, bank: torch.Tensor,
                       row: torch.Tensor, valid: torch.Tensor,
                       timing: torch.Tensor, carry: State):
    """:func:`dram_timing` by the serial kernel: one lane a channel walks
    its slots in int32 that wraps as the JAX scan does.  The plain
    version (:func:`~.ref.dram_timing_serial_ref`) for CPU tensors."""
    C, L, B, R = _check_timing(issue, bank, row, valid, timing, carry)
    if issue.device.type == "cpu":
        return dram_timing_serial_ref(issue, bank, row, valid, timing,
                                      carry)
    if issue.device.type != "cuda":
        raise ValueError(f"dram_timing_serial runs on CUDA or CPU, not "
                         f"{issue.device}")
    code, finish, kind, out = _launch_timing(
        library().repro_dram_timing_serial,
        (issue, bank, row, valid, timing), carry, C, L)
    check_launch(code, "dram_timing_serial")
    count_launch(dram_timing_serial)
    return finish, kind, out


dram_timing_serial.launches = 0


def simulate_trace(trace: Trace, cfg: DRAMConfig, device=None):
    """End-to-end on ``device`` (default the card): trace -> per-channel
    pack -> one ``dram_timing`` call from a cold carry.  Returns
    ``(finish int32[C, L], kind int8[C, L], makespan)`` as NumPy arrays
    and an int; the counterpart of the JAX package's
    ``simulate_trace_kernel``."""
    device = resolve_device(device)
    packed = pack_channels(trace, cfg)
    carry = init_channel_carry(cfg.channels, cfg.banks_per_channel,
                               cfg.org.banks, device)

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    finish, kind, _ = dram_timing(
        to(packed.issue), to(packed.bank), to(packed.row), to(packed.valid),
        to(timing_params(cfg.timing)), carry)
    finish, kind = finish.cpu().numpy(), kind.cpu().numpy()
    valid = packed.valid
    makespan = int(finish[valid].max()) if valid.any() else 0
    return finish, kind, makespan
