"""Plain versions of the sweep kernels (``csrc/sweep_min.cu``,
``csrc/sweep_min_rounds.cu``): :func:`sweep_min_ref`, the sequential
sweep one Python-loop iteration per edge, and :func:`sweep_min_rounds_ref`,
the round algorithm in torch ops; with the input checks the wrappers in
``ops.py`` share."""

from __future__ import annotations

import torch


def _wrap32(x: int) -> int:
    """int32 two's-complement wrap, as the device arithmetic does."""
    return (x + 2**31) % 2**32 - 2**31


def sweep_min_ref(values: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, add: int) -> None:
    """The plain sequential sweep, one Python-loop iteration per edge."""
    vals = values.tolist()
    for s, d in zip(src.tolist(), dst.tolist()):
        vals[d] = min(vals[d], _wrap32(vals[s] + add))
    values.copy_(torch.tensor(vals, dtype=values.dtype))


def _check_edges(values, src, dst) -> None:
    for t in (values, src, dst):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError("sweep_min takes 1-D int32 tensors")
        if not t.is_contiguous():
            raise ValueError("sweep_min takes contiguous tensors")
        if t.device != values.device:
            raise ValueError(f"tensors on {t.device} and {values.device}")
    if src.shape != dst.shape:
        raise ValueError("src and dst differ in length")
    n, m = values.shape[0], src.shape[0]
    if m and (int(torch.minimum(src.min(), dst.min())) < 0
              or int(torch.maximum(src.max(), dst.max())) >= n):
        raise ValueError("edge endpoints out of range")


def _check_values(values: torch.Tensor, n: int, add: int, device) -> None:
    """Everything but the values' peak, which needs a read of the card."""
    if values.dtype != torch.int32 or values.dim() != 1:
        raise TypeError("sweep values must be 1-D int32")
    if not values.is_contiguous():
        raise ValueError("sweep values must be contiguous")
    if values.shape[0] != n:
        raise ValueError(f"{values.shape[0]} values for a block of {n} "
                         f"vertices")
    if values.device != torch.device(device):
        raise ValueError(f"values on {values.device}, block on {device}")
    if int(add) < 0:
        raise ValueError(f"the round sweep needs add >= 0, got {add}")


def _check_peak(peak: int, add: int) -> None:
    if peak + int(add) >= 2**31:
        raise ValueError("values.max() + add must stay below 2**31 (the "
                         "rounds are exact only where nothing wraps)")


def _rounds(values, src, dst, add, max_rounds) -> tuple:
    """The synchronous rounds, at most ``max_rounds`` (None: no limit):
    (rounds run, whether the last one changed nothing)."""
    s, d = src.long(), dst.long()
    up, down = s > d, s < d
    base = values.scatter_reduce(0, d[up], values[s[up]] + add, "amin")
    d_down, s_down = d[down], s[down]
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        y = base.scatter_reduce(0, d_down, values[s_down] + add, "amin")
        y = torch.minimum(y, values)
        if torch.equal(y, values):
            return rounds, True
        values.copy_(y)
    return rounds, False


def sweep_min_rounds_ref(values: torch.Tensor, block, add: int) -> int:
    """The round algorithm in torch ops, synchronous, over ``block``'s
    in-edges ``u -> v`` (a ``SweepBlock``: ``n``, ``src``, ``dst`` with
    ``dst`` non-decreasing): from ``x0 = values``, each round sets ``y[v]
    = min(y[v], x0[u] + add for u > v, y_prev[u] + add for u < v)``,
    until a round changes nothing.  Updates ``values`` in place (to the
    serial sweep's result) and returns the rounds, the last one included.
    The kernel reads values of the same round too, so it needs at most as
    many."""
    _check_values(values, block.n, add, block.dst.device)
    if values.numel():
        _check_peak(int(values.max()), add)
    return _rounds(values, block.src, block.dst, add, None)[0]
