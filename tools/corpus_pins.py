#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 11 (the corpus) from the JAX
package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/corpus_pins.py [--write]

Runs ``chip_smoke.corpus_runs`` through ``repro.sim`` (the same calls the
phase makes through ``repro_torch.sim`` on the card), with the graphs
built afresh (``REPRO_GRAPH_CACHE=0``), and prints the constants the phase
holds the card to: every graph's name, size and fingerprint, every row's
report pin, the sweepers' counters, the contracts' directions, the
ScenarioSpec run, its deprecation warning and every epoch of the dynamic
run.  ``--write`` puts them into ``chip_smoke.py`` between its corpus-pin
markers.  Takes a few minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BEGIN = "# ---- corpus pins: written by tools/corpus_pins.py ----\n"
END = "# ---- end of corpus pins ----\n"


def pins(smoke, sim) -> dict:
    """The pin constants, by name, from one run of the phase's calls."""
    t0 = time.perf_counter()
    out = smoke.corpus_runs(sim)
    print(f"corpus runs {time.perf_counter() - t0:.1f} s, parts "
          f"{out['seconds']}", file=sys.stderr)
    rows = smoke.corpus_keyed(out)
    assert out["spec"] == out["spec_keywords"]
    assert out["dynamic_spec"] == out["dynamic"].report
    return {
        "CORPUS_GRAPHS": {sel: smoke.graph_pin(g)
                          for sel, g in out["graphs"].items()},
        "CORPUS_PINS": {k: smoke.report_pin(r.report)
                        for k, r in rows.items()},
        "CORPUS_STATS": out["stats"],
        "CORPUS_CONTRACTS": smoke.corpus_contracts(rows),
        "CORPUS_SPEC_PIN": smoke.report_pin(out["spec"]),
        "CORPUS_SPEC_WARNINGS": out["spec_warnings"],
        "CORPUS_DYNAMIC_PIN": smoke.report_pin(out["dynamic"].report),
        "CORPUS_EPOCH_PINS": [smoke.epoch_pin(e)
                              for e in out["dynamic"].epochs],
    }


def literal(value) -> str:
    """``value`` as Python source, a dict or list one entry a line (an
    entry longer than a line puts its value on the next)."""
    if isinstance(value, dict):
        items = []
        for k, v in value.items():
            head, text = f"    {k!r}:", literal(v).replace("\n", "\n    ")
            fits = "\n" in text or len(head) + len(text) < 78
            sep = " " if fits else "\n        "
            items.append(f"{head}{sep}{text},\n")
        return "{\n" + "".join(items) + "}"
    if isinstance(value, list):
        return "[\n" + "".join(f"    {v!r},\n" for v in value) + "]"
    return repr(value)


def block(constants: dict) -> str:
    lines = [BEGIN, "#: the JAX package's numbers for phase 11, made on the "
             "CPU by the same calls\n"]
    for name, value in constants.items():
        lines.append(f"{name} = {literal(value)}\n")
    lines.append(END)
    return "".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the pins in chip_smoke.py")
    args = ap.parse_args()
    os.environ["REPRO_GRAPH_CACHE"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro import sim
    text = block(pins(chip_smoke, sim))
    if not args.write:
        print(text, end="")
        return 0
    path = ROOT / "chip_smoke.py"
    src = path.read_text()
    head, rest = src.split(BEGIN)
    _, tail = rest.split(END)
    path.write_text(head + text + tail)
    print(f"wrote the corpus pins into {path.name}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
