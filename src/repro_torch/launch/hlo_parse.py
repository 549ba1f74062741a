"""Computation-aware HLO analysis (a port of ``repro.launch.hlo_parse``:
string functions over XLA HLO text, copied; nothing of the port produces
HLO, so they read what ``repro`` compiles).

XLA's ``cost_analysis()`` (and any naive text scan) counts a while-loop
body ONCE, not x trip-count — verified empirically (see EXPERIMENTS.md
§Roofline).  Our layer stacks are ``lax.scan``s, so collective bytes
parsed from the flat module text would be understated by ~n_layers.

This parser splits the HLO module into computations, finds every
``while`` op's (condition, body) pair, extracts the trip count from the
largest integer constant in the condition computation (jax scans lower
to ``i < C`` conditions), and multiplies collective bytes accordingly —
recursively for nested scans (layers x attention chunks).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\b")
_SHAPE_RE = re.compile(r"\b(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|"
                       r"u8|pred|f8e4m3fn|f8e5m2)\[([0-9,]*)\]")
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
}
_COMP_START = re.compile(r"^(%?[\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\), condition=(%?[\w\.\-]+), body=(%?[\w\.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def split_computations(hlo: str) -> Dict[str, List[str]]:
    """computation name -> its lines (brace-matched, top-level only)."""
    comps: Dict[str, List[str]] = {}
    cur = None
    depth = 0
    for raw in hlo.splitlines():
        line = raw.rstrip()
        if cur is None:
            # computations are flush-left lines "name (params...) -> T {"
            if (line and not line.startswith(" ")
                    and line.rstrip().endswith("{") and "->" in line):
                stripped = line.strip()
                if stripped.startswith("ENTRY "):
                    stripped = stripped[len("ENTRY "):]
                cur = stripped.split("(", 1)[0].strip().lstrip("%")
                comps[cur] = []
                depth = 1
            continue
        depth += line.count("{") - line.count("}")
        if depth <= 0:
            cur = None
            continue
        comps[cur].append(line)
    return comps


def _result_bytes(line: str) -> int:
    """Bytes of the op's result type (text before the call parens)."""
    rhs = line.split("=", 1)[1] if "=" in line else line
    head = rhs.split("(", 1)[0]
    if not _SHAPE_RE.search(head) and rhs.lstrip().startswith("("):
        # tuple result of an async -start op
        head = rhs.split(")", 1)[0]
    nbytes = 0
    for dt, dims in _SHAPE_RE.findall(head):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        nbytes += n * _DTYPE_BYTES[dt]
    return nbytes


def analyze_collectives(hlo: str) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Returns (bytes_by_kind, op_counts) with while-trip multiplication.

    Bytes are per-device (the SPMD module is per-device); the result type
    is the per-device wire proxy.
    """
    comps = split_computations(hlo)

    # map body computation -> trip count, and find each computation's
    # nested while calls
    trip: Dict[str, int] = {}
    nests: Dict[str, List[str]] = {c: [] for c in comps}
    for cname, lines in comps.items():
        for line in lines:
            m = _WHILE_RE.search(line)
            if m:
                cond, body = (m.group(1).lstrip("%"),
                              m.group(2).lstrip("%"))
                consts = [int(x) for x in _CONST_RE.findall(
                    "\n".join(comps.get(cond, [])))]
                trip[body] = max(consts) if consts else 1
                nests[cname].append(body)

    # multiplier of each computation = product of trip counts on the
    # path from an entry computation
    mult: Dict[str, int] = {}

    def resolve(c: str, m: int) -> None:
        mult[c] = max(mult.get(c, 0), m)
        for body in nests.get(c, []):
            resolve(body, m * trip.get(body, 1))

    called = {b for bs in nests.values() for b in bs}
    for c in comps:
        if c not in called and c not in trip:
            resolve(c, 1)
    # computations only reachable via fusion/call keep multiplier 1 if
    # unseen (collectives never live in fusions)
    bytes_by: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for cname, lines in comps.items():
        m = mult.get(cname, 1)
        for line in lines:
            s = line.strip()
            if "=" not in s or "-done" in s.split("(", 1)[0]:
                continue
            rhs_head = s.split("=", 1)[1].split("(", 1)[0]
            mm = _COLLECTIVE_RE.search(rhs_head)
            if not mm and s.split("=", 1)[1].lstrip().startswith("("):
                mm = _COLLECTIVE_RE.search(s.split("=", 1)[1])
            if not mm:
                continue
            kind = mm.group(1)
            nb = _result_bytes(s) * m
            bytes_by[kind] = bytes_by.get(kind, 0) + nb
            counts[kind] = counts.get(kind, 0) + m
    return bytes_by, counts
