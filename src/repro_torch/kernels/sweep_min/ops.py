"""Asynchronous min-relaxation sweep of one vertex-centric block.

Two hand-written CUDA kernels, each behind its own wrapper and counter:

- ``sweep_min_rounds(values, x0, block, add, max_rounds, status)``: one
  cooperative launch of ``csrc/sweep_min_rounds.cu``, the sweep of one
  :class:`SweepBlock` (destination-sorted in-edges) as exact parallel
  rounds, at most ``max_rounds`` of them; counted in
  ``sweep_min_rounds.launches``;
- ``sweep_min(values, src, dst, add)``, the serial route and the
  Pallas-free counterpart of the JAX package's scan: every edge in edge
  order, ``values[dst] = min(values[dst], values[src] + add)``, in place,
  against the current values, on one thread (``csrc/sweep_min.cu``); any
  edge order; counted in ``sweep_min.launches``.

``sweep_min_block(values, block, add)``, the engine's entry point, runs
the rounds up to a budget and, if they do not converge, restores the
values and takes the serial route.  For CPU tensors the kernels' wrappers
run their plain versions (``ref.py``: :func:`sweep_min_rounds_ref`, the
round algorithm in torch ops, and :func:`sweep_min_ref`, the sequential
loop) and ``sweep_min_block`` runs the sequential loop.  No fallback: a
CUDA tensor goes to a kernel or the call raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import count_launch
from repro_torch.kernels.build import check_launch, library
from repro_torch.kernels.spmv_ell.ops import SlicedEll, pack_in_edges
# the plain versions live in ref.py; importing them here keeps
# ``ops.sweep_min_ref`` / ``ops.sweep_min_rounds_ref`` working
from repro_torch.kernels.sweep_min.ref import (_check_edges, _check_peak,
                                               _check_values, _rounds,
                                               sweep_min_ref,
                                               sweep_min_rounds_ref)

#: the serial route's time per edge (its fastest, on a path) and a
#: round's fixed cost and time per slot on an H100 (chip_smoke.py's
#: `sweep_paths` and `main_block` lines; PERF.md): the budget of rounds is
#: the serial sweep's time over a round's, so a sweep that runs out of
#: budget costs at most about twice the serial route
SERIAL_NS_PER_EDGE = 103.0
ROUND_NS = 13_500.0
ROUND_NS_PER_SLOT = 0.0096
MIN_ROUNDS = 2


def sweep_min(values: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              add: int) -> None:
    """Relax ``values`` (int32[n], updated in place) over the edges
    ``src -> dst`` (int32[m]) in order."""
    _check_edges(values, src, dst)
    if values.device.type == "cpu":
        sweep_min_ref(values, src, dst, add)
        return
    if values.device.type != "cuda":
        raise ValueError(f"sweep_min runs on CUDA or CPU, not "
                         f"{values.device}")
    lib = library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_sweep_min(values.data_ptr(), src.data_ptr(),
                                   dst.data_ptr(), src.shape[0], int(add),
                                   stream)
    check_launch(code, "sweep_min")
    count_launch(sweep_min)


sweep_min.launches = 0


def _check_block(src: torch.Tensor, dst: torch.Tensor, n: int) -> None:
    _check_edges(torch.empty(n, dtype=torch.int32, device=dst.device),
                 src, dst)
    if dst.numel() > 1 and bool((dst[1:] < dst[:-1]).any()):
        raise ValueError("a sweep block's dst must be non-decreasing (each "
                         "destination one run, in ascending order)")


@dataclasses.dataclass(frozen=True)
class SweepBlock:
    """One block's in-edges ``src -> dst`` (int32[m] on one device,
    ``dst`` non-decreasing, endpoints in ``[0, n)``; checked, raises
    otherwise) and, for a block on the card, the same edges as a
    sources-only :class:`SlicedEll` for the round kernel (``ell``; None
    on the CPU, where no round kernel runs).

    The sliced ELL alone does not serve: it reorders rows by width and a
    heavy row's edges by source, while the serial route and the
    sequential sweep need the edges in their destination-sorted order,
    and the round kernel's exactness rests on ``dst`` being sorted."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    ell: Optional[SlicedEll] = dataclasses.field(init=False)

    def __post_init__(self):
        _check_block(self.src, self.dst, self.n)
        object.__setattr__(self, "ell", pack_in_edges(
            self.src, self.dst, self.n, None, device=self.dst.device)
            if self.dst.device.type == "cuda" else None)

    @property
    def m(self) -> int:
        return self.src.shape[0]

    @property
    def slots(self) -> int:
        """The sliced ELL's slots (padding included); card blocks only."""
        if self.ell is None:
            raise ValueError("a CPU SweepBlock has no sliced ELL")
        return self.ell.cols.numel()


def pack_sweep_block(src, dst, n: int, device=None) -> SweepBlock:
    """A :class:`SweepBlock` of a block's destination-sorted in-edges (int
    arrays or tensors) on ``device`` (default: ``dst``'s device if it is a
    tensor, else the CPU)."""
    if device is None:
        device = dst.device if isinstance(dst, torch.Tensor) else "cpu"
    return SweepBlock(n, *(torch.as_tensor(a, device=device)
                           .to(torch.int32).contiguous() for a in (src, dst)))


def sweep_min_rounds(values: torch.Tensor, x0: torch.Tensor,
                     block: SweepBlock, add: int, max_rounds: int,
                     status: torch.Tensor) -> None:
    """At most ``max_rounds`` rounds of ``block``'s sweep over ``values``
    (int32[n], in place; ``x0`` an untouched copy of it), as the round
    kernel runs them.  ``status`` (int32[3], zeros on entry) receives {the
    last round that lowered a value, counted from 1 (0: none); the rounds
    run; 1 if the last round changed nothing, else 0}; when it is 1,
    ``values`` holds the serial sweep's result.  Checks no precondition
    that needs a read of the card (``sweep_min_block`` does): ``add >=
    0`` and ``x0.max() + add < 2**31`` are the caller's."""
    if values.device.type == "cpu":
        rounds, done = _rounds(values, block.src, block.dst, add,
                               max_rounds)
        status.copy_(torch.tensor([rounds - int(done), rounds, int(done)],
                                  dtype=torch.int32))
        return
    if values.device.type != "cuda":
        raise ValueError(f"sweep_min_rounds runs on CUDA or CPU, not "
                         f"{values.device}")
    a = block.ell
    lib = library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_sweep_min_rounds(
            values.data_ptr(), x0.data_ptr(), a.cols.data_ptr(),
            a.slice_ptr.data_ptr(), a.slice_rows.data_ptr(), a.n_slices,
            a.chunk_ptr.data_ptr(), a.chunk_rows.data_ptr(), a.n_chunks,
            block.n, int(add), int(max_rounds), status.data_ptr(), stream)
    check_launch(code, "sweep_min_rounds")
    count_launch(sweep_min_rounds)


sweep_min_rounds.launches = 0


class SweepResult(NamedTuple):
    """What one :func:`sweep_min_block` did: ``rounds`` run by the round
    kernel (0 on the CPU), and the ``route`` that gave the result:
    ``"rounds"``, ``"serial"`` (the budget ran out) or ``"plain"`` (CPU
    tensors)."""

    rounds: int
    route: str


def round_budget(block: SweepBlock) -> int:
    """Rounds worth one serial sweep of ``block``'s edges on the card."""
    serial = SERIAL_NS_PER_EDGE * block.m
    one = ROUND_NS + ROUND_NS_PER_SLOT * block.slots
    return max(MIN_ROUNDS, int(serial / one))


def sweep_min_block(values: torch.Tensor, block: SweepBlock,
                    add: int) -> SweepResult:
    """The serial sweep of ``block`` over ``values`` (int32[n], in place),
    bit for bit.  On the card: the round kernel, at most
    :func:`round_budget` rounds; if they do not converge, the values are
    restored and the serial kernel sweeps them.  Needs ``add >= 0`` and
    ``values.max() + add < 2**31``; raises otherwise (on the card after
    the round launch, with the values restored: the peak is read in the
    same synchronisation as the kernel's status)."""
    if not isinstance(block, SweepBlock):
        raise TypeError("sweep_min_block takes a SweepBlock "
                        "(pack_sweep_block)")
    _check_values(values, block.n, add, block.dst.device)
    if values.device.type == "cpu":
        if block.n:
            _check_peak(int(values.max()), add)
        sweep_min_ref(values, block.src, block.dst, add)
        return SweepResult(0, "plain")
    if values.device.type != "cuda":
        raise ValueError(f"sweep_min_block runs on CUDA or CPU, not "
                         f"{values.device}")
    if block.n == 0:
        return SweepResult(0, "rounds")
    x0 = values.clone()
    status = torch.zeros(4, dtype=torch.int32, device=values.device)
    sweep_min_rounds(values, x0, block, add, round_budget(block),
                     status[:3])
    status[3:].copy_(x0.amax(0, keepdim=True))
    _, rounds, converged, peak = status.tolist()
    if peak + int(add) >= 2**31:
        values.copy_(x0)
        _check_peak(peak, add)
    if converged:
        return SweepResult(rounds, "rounds")
    values.copy_(x0)
    sweep_min(values, block.src, block.dst, add)
    return SweepResult(rounds, "serial")
