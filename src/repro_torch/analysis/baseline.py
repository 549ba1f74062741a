"""Committed-baseline handling with a drift gate.

The baseline (``analysis_baseline.json`` at the repo root) records
findings that are *known and accepted*; the gate then enforces three
invariants on every run:

1. **No new findings** — anything not matched by a baseline entry fails.
2. **No stale entries** — a baseline entry whose finding no longer
   exists fails too ("drift gate"): fixed findings must be removed from
   the baseline in the same change, so the baseline only ever shrinks
   silently, never rots.
3. **Every entry is justified** — a baseline entry without a one-line
   ``justification`` fails.  ``--update-baseline`` writes placeholder
   ``"UNREVIEWED"`` justifications for new entries precisely so the run
   stays red until a human writes the reason down.

Entries are fingerprinted by ``(rule, path, symbol)`` — never by line —
so unrelated edits to a file do not invalidate its baseline.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.framework import Finding

BASELINE_VERSION = 1
UNREVIEWED = "UNREVIEWED"


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    justification: str = ""

    KEY_EXEMPT_FIELDS = {
        "justification": "free-text audit note; editing it must not "
                         "invalidate the entry it justifies",
    }

    @property
    def fingerprint(self):
        return (self.rule, self.path, self.symbol)


def load_baseline(path: Path) -> List[BaselineEntry]:
    if not path.exists():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: baseline version {data.get('version')!r} != "
            f"{BASELINE_VERSION}")
    return [BaselineEntry(rule=e["rule"], path=e["path"],
                          symbol=e.get("symbol", ""),
                          justification=e.get("justification", ""))
            for e in data.get("entries", [])]


def save_baseline(path: Path, entries: Sequence[BaselineEntry]) -> None:
    payload = {
        "version": BASELINE_VERSION,
        "entries": [dataclasses.asdict(e) for e in sorted(
            entries, key=lambda e: e.fingerprint)],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n",
                    encoding="utf-8")


@dataclasses.dataclass
class GateResult:
    new_findings: List[Finding]
    stale_entries: List[BaselineEntry]
    unjustified_entries: List[BaselineEntry]
    baselined: int = 0

    @property
    def ok(self) -> bool:
        return not (self.new_findings or self.stale_entries
                    or self.unjustified_entries)


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[BaselineEntry]) -> GateResult:
    by_fp: Dict[Tuple, BaselineEntry] = {
        e.fingerprint: e for e in entries}
    matched = set()
    new: List[Finding] = []
    baselined = 0
    for f in findings:
        entry = by_fp.get(f.fingerprint)
        if entry is None:
            new.append(f)
        else:
            matched.add(entry.fingerprint)
            baselined += 1
    stale = [e for e in entries if e.fingerprint not in matched]
    unjustified = [e for e in entries
                   if e.fingerprint in matched
                   and (not e.justification
                        or e.justification == UNREVIEWED)]
    return GateResult(new_findings=new, stale_entries=stale,
                      unjustified_entries=unjustified,
                      baselined=baselined)


def update_baseline(findings: Sequence[Finding],
                    entries: Sequence[BaselineEntry]
                    ) -> List[BaselineEntry]:
    """New entry set covering exactly the current findings, keeping
    existing justifications; new entries get the ``UNREVIEWED``
    placeholder (which the gate rejects until replaced)."""
    old = {e.fingerprint: e for e in entries}
    out: Dict[Tuple, BaselineEntry] = {}
    for f in findings:
        fp = f.fingerprint
        prior = old.get(fp)
        out[fp] = prior if prior is not None else BaselineEntry(
            rule=f.rule, path=f.path, symbol=f.symbol or f.message,
            justification=UNREVIEWED)
    return list(out.values())
