"""Device selection shared by every entry point of the port, and the
host's waits on the card.

The entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and with no CUDA device they raise instead of
carrying on on the CPU.  Tests pass ``device="cpu"`` explicitly.

Every blocking wait of the host on the card on the static sweep path
(a copy of a result to the host, a device or event synchronisation)
goes through :func:`to_host` or :func:`wait`, which count it.  A call
counts on the CPU too, where nothing waits, so a path's count is the
same on both.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import locks

#: bumped from the sweep's serving threads at once: ``+=`` is not atomic
_wait_lock = locks.make_lock("host-waits")
_host_waits = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on "
            "the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _count_wait() -> None:
    global _host_waits
    with _wait_lock:
        _host_waits += 1


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a blocking copy from the card (``t`` itself on
    the CPU); counted either way."""
    _count_wait()
    return t.cpu()


def wait(on) -> None:
    """Block the host until the card has done the work enqueued on
    ``on``: a device (all of its streams) or a ``torch.cuda.Event``;
    counted, and nothing on the CPU."""
    _count_wait()
    if isinstance(on, torch.device):
        if on.type == "cuda":
            torch.cuda.synchronize(on)
    else:
        on.synchronize()


def host_wait_count() -> int:
    """The waits counted since the last :func:`zero_host_wait_count`."""
    with _wait_lock:
        return _host_waits


def zero_host_wait_count() -> None:
    global _host_waits
    with _wait_lock:
        _host_waits = 0
