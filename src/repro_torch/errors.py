"""Typed errors shared by the port: preset resolution and kernels.

Every user-facing axis that resolves names against a registry (graph
presets, ordering transforms, memory and cache presets, accelerators,
variants, update streams) raises :class:`UnknownPresetError` on a miss:
a :class:`KeyError` subclass that names the *axis*, lists the valid
names, and suggests the nearest valid preset.  A kernel that fails to
build, load or launch raises :class:`KernelError`.
"""

from __future__ import annotations

import difflib
from typing import Iterable, Optional


class UnknownPresetError(KeyError):
    """An unknown string name on a preset-resolved axis."""

    def __init__(self, axis: str, name: str, available: Iterable[str]):
        self.axis = axis
        self.name = name
        self.available = sorted(available)
        self.suggestion: Optional[str] = None
        matches = difflib.get_close_matches(name, self.available, n=1,
                                            cutoff=0.5)
        if matches:
            self.suggestion = matches[0]
        msg = (f"unknown {axis} preset {name!r}; "
               f"available: {self.available}")
        if self.suggestion is not None:
            msg += f" (did you mean {self.suggestion!r}?)"
        super().__init__(msg)

    def __str__(self) -> str:        # KeyError quotes its arg by default
        return self.args[0]


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, to load or to launch.

    Never transient: :func:`repro_torch.serve.chaos.is_transient` is False
    for a failure with one anywhere on its cause chain, so the service
    fails the case at once instead of retrying a broken kernel (whose
    ``OSError`` from ``ctypes`` or "out of memory" message would otherwise
    look like an I/O blip)."""
