"""DRAM simulation backends behind one program-level interface.

A backend exposes the :class:`~repro_torch.core.accel.VectorizedDRAM`
surface the trace models and the dynamic path drive (``run_program``,
``run_phase``, ``invalidate_lines`` and the accumulated statistics).  ``"vectorized"`` is the fused serve: the CUDA kernel on the
card, its plain version on the CPU.  The element-granularity
``"event"`` backend comes with a later slice.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.accel import VectorizedDRAM
from repro_torch.core.dram import DRAMConfig

BACKENDS: Dict[str, type] = {
    "vectorized": VectorizedDRAM,
}


def make_backend(backend: str, cfg: DRAMConfig, device=None):
    """Instantiate a DRAM backend by name for device ``cfg``, serving on
    ``device`` (default the card)."""
    if backend == "event":
        raise NotImplementedError(
            "the event backend is not ported yet; see ROADMAP.md")
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: "
            f"{sorted(BACKENDS) + ['event']}") from None
    return cls(cfg, device=device)
