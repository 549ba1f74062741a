"""Typed preset-resolution errors shared by every string-named axis.

Every user-facing axis that resolves names against a registry (graph
presets, ordering transforms, memory and cache presets, accelerators,
variants, update streams) raises :class:`UnknownPresetError` on a miss:
a :class:`KeyError` subclass that names the *axis*, lists the valid
names, and suggests the nearest valid preset.
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
