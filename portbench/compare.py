"""The comparison that decides ``correct``.

The simulator's results are exact: every report field is an integer
count or a ratio of integer counts, so the program's report of a grid
point must equal the reference's field for field, phase for phase.  Each
number compared has the limit 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from portbench.reference import PHASE_FIELDS, REPORT_FIELDS


def as_fields(report) -> dict:
    """The compared fields of a program's ``SimReport`` (or of a dict
    with the same keys), phases as dicts."""
    if isinstance(report, dict):
        return report
    out = {f: getattr(report, f) for f in REPORT_FIELDS}
    out["phases"] = [{f: getattr(ph, f) for f in PHASE_FIELDS}
                     for ph in report.phases]
    return out


def field_diffs(got: dict, want: dict) -> List[str]:
    """The names of the fields in which ``got`` differs from ``want``
    (a phase field as ``phases[i].field``; a phase count that differs as
    ``phases``)."""
    diffs = [f for f in REPORT_FIELDS
             if f != "phases" and got.get(f) != want[f]]
    gp, wp = got.get("phases") or [], want["phases"]
    if len(gp) != len(wp):
        diffs.append("phases")
    for i, (g, w) in enumerate(zip(gp, wp)):
        diffs += [f"phases[{i}].{f}" for f in PHASE_FIELDS
                  if g.get(f) != w[f]]
    return diffs


@dataclasses.dataclass
class Verdict:
    reports: int = 0              # reports compared
    failed_points: int = 0        # points a call did not deliver
    mismatched_reports: int = 0
    mismatched_fields: int = 0
    max_runtime_rel_gap: float = 0.0
    first_diffs: Optional[List[str]] = None

    @property
    def correct(self) -> bool:
        return (self.reports > 0 and self.failed_points == 0
                and self.mismatched_fields == 0
                and self.max_runtime_rel_gap == 0.0)

    def checks(self) -> Dict[str, dict]:
        """Each number compared, beside its limit."""
        return {"mismatched_fields": {"value": self.mismatched_fields,
                                      "limit": 0},
                "max_runtime_rel_gap": {"value": self.max_runtime_rel_gap,
                                        "limit": 0},
                "failed_points": {"value": self.failed_points, "limit": 0}}


def judge(calls: List[Optional[List[dict]]], expected: List[dict],
          verdict: Optional[Verdict] = None) -> Verdict:
    """Hold every report of every call against the reference of its grid
    point; a call that delivered nothing (``None``) fails all its
    points."""
    v = verdict or Verdict()
    for rows in calls:
        if rows is None or len(rows) != len(expected):
            v.failed_points += len(expected)
            continue
        for got, want in zip(rows, expected):
            v.reports += 1
            diffs = field_diffs(got, want)
            if diffs:
                v.mismatched_reports += 1
                v.mismatched_fields += len(diffs)
                if v.first_diffs is None:
                    v.first_diffs = diffs[:8]
            rt = got.get("runtime_ns")
            if isinstance(rt, (int, float)) and want["runtime_ns"]:
                v.max_runtime_rel_gap = max(
                    v.max_runtime_rel_gap,
                    abs(rt - want["runtime_ns"]) / want["runtime_ns"])
    return v
