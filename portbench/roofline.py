"""Bytes a serve call needs, from its shapes, and the peaks they are held
against (``peaks.json``, by the name the card reports).

A serve call takes a blocked program of ``[S, C, K]`` steps, channels and
lanes (``issue`` and ``meta``, 4 bytes a lane-step each, and 4 bytes of
phase boundary a step), one timing vector of 7 words a case, and a carry
a case in and out (bank free times and activate times, ``C * B`` words
each; bus and in-phase makespan, ``C`` each; the rank activate history,
pointer and last activate, ``5 * C * R``); it writes a finish word a
lane-step a case.  Each byte is counted once: the program once when every
case shares it, once a case when each has its own.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def serve_bytes(S: int, C: int, K: int, B: int, R: int, M: int = 1,
                shared: bool = True) -> int:
    carry = 2 * C * B + 2 * C + 5 * C * R
    programs = 1 if shared else M
    return (programs * (S * C * K * 8 + S * 4)
            + M * (7 * 4 + S * C * K * 4 + 2 * carry * 4))


def peak(kind: str, key: str) -> Optional[float]:
    """The card's published peak ``key``; None for a card not in the
    table."""
    row = json.loads(PEAKS.read_text()).get(kind)
    return None if row is None else float(row[key])
