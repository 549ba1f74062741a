"""CLI: ``python -m repro_torch.analysis [paths...]``.

Runs the repo-aware lint suite over the given paths (default
``src/repro_torch``) with the port's config (``analysis_torch.cfg``),
applies the port's committed baseline (``analysis_torch_baseline.json``),
and exits non-zero on any new finding, stale baseline entry, or
unjustified baseline entry.  It imports no ``torch``.

Common invocations::

    python -m repro_torch.analysis                    # the gate
    python -m repro_torch.analysis --list-rules       # what runs
    python -m repro_torch.analysis --update-baseline  # accept current
                                                      # state (justify!)
    python -m repro_torch.analysis --no-baseline      # raw findings
    python -m repro_torch.analysis --config analysis.cfg \\
        --baseline analysis_baseline.json src/repro   # the JAX package's
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.framework import (CONFIG_FILENAME, RULES,
                                            load_config, run_analysis)

DEFAULT_BASELINE = "analysis_torch_baseline.json"
DEFAULT_PATHS = ("src/repro_torch",)


def _find_root(start: Path, config: str) -> Path:
    """Nearest ancestor carrying the analysis config (or a .git dir);
    falls back to ``start``."""
    for cand in (start, *start.parents):
        if (cand / config).exists() or (cand / ".git").exists():
            return cand
    return start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-aware static-analysis suite (cache-key "
                    "soundness, determinism, dtype pinning, kernel "
                    "parity, exception hygiene, quarantined imports)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: walk up from cwd to the "
                         "config / .git)")
    ap.add_argument("--config", default=CONFIG_FILENAME,
                    help="config file name under the root (default: "
                         f"{CONFIG_FILENAME})")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/"
                         f"{DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current "
                         "findings (new entries get UNREVIEWED "
                         "justifications, which still fail the gate)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis import rules as _rules  # noqa: F401
        for rule in sorted(RULES.values(), key=lambda r: r.name):
            print(f"{rule.name:26s} {rule.severity:8s} "
                  f"{rule.description}")
        return 0

    root = (args.root or _find_root(Path.cwd(), args.config)).resolve()
    config = load_config(root, args.config)
    paths = [Path(p) for p in (args.paths or DEFAULT_PATHS)]
    findings = run_analysis(paths, root, config)

    if args.no_baseline:
        for f in findings:
            print(f.format())
        print(f"{len(findings)} finding(s) "
              f"({sum(1 for f in findings if f.severity == 'error')} "
              "error)")
        return 1 if findings else 0

    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE
    entries = bl.load_baseline(baseline_path)

    if args.update_baseline:
        new_entries = bl.update_baseline(findings, entries)
        bl.save_baseline(baseline_path, new_entries)
        fresh = [e for e in new_entries
                 if e.justification == bl.UNREVIEWED]
        print(f"baseline written: {baseline_path} "
              f"({len(new_entries)} entries, {len(fresh)} UNREVIEWED)")
        if fresh:
            print("add a one-line justification to each UNREVIEWED "
                  "entry — the gate rejects placeholders")
        return 0

    gate = bl.apply_baseline(findings, entries)
    for f in gate.new_findings:
        print(f.format())
    for e in gate.stale_entries:
        print(f"{e.path}: stale-baseline[{e.rule}] entry "
              f"{e.symbol!r} no longer matches any finding — remove "
              "it from the baseline")
    for e in gate.unjustified_entries:
        print(f"{e.path}: unjustified-baseline[{e.rule}] entry "
              f"{e.symbol!r} needs a one-line justification")
    ok = gate.ok
    print(f"analysis: {len(findings)} finding(s), "
          f"{gate.baselined} baselined, {len(gate.new_findings)} new, "
          f"{len(gate.stale_entries)} stale, "
          f"{len(gate.unjustified_entries)} unjustified -> "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
