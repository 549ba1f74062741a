#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 12 (the service and the
tuner) from the JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/service_pins.py [--write]

Runs ``chip_smoke.service_runs`` through ``repro`` (the same calls the
phase makes through ``repro_torch`` on the card), with the graphs built
afresh (``REPRO_GRAPH_CACHE=0``): the clean service, the resident graph
and the tuner.  The faulted service is left out: what the phase holds it
to is the clean rows and the chaos plans, which are a pure function of
the seed, the site and the case key.  Prints the constants the phase
holds the card to: both stand-ins' name, size and fingerprint, every
clean row's report pin by case key, every case's chaos plan at each site,
the resident graph's epochs, the search's front, rungs and counters, the
exhaustive sweep's objective vectors and the sweepers' counters.
``--write`` puts them into ``chip_smoke.py`` between its service-pin
markers.  Takes a few minutes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BEGIN = "# ---- service pins: written by tools/service_pins.py ----\n"
END = "# ---- end of service pins ----\n"


def block(constants: dict, literal) -> str:
    lines = [BEGIN, "#: the JAX package's numbers for phase 12, made on the "
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
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]
    import chip_smoke
    from corpus_pins import literal
    t0 = time.perf_counter()
    out = chip_smoke.service_runs("repro",
                                  parts=("clean", "resident", "tuner"))
    print(f"service runs {time.perf_counter() - t0:.1f} s, parts "
          f"{out['seconds']}", file=sys.stderr)
    n_jobs = chip_smoke.SERVICE_CLIENTS * chip_smoke.SERVICE_JOBS_PER_CLIENT
    assert out["clean"]["done"] == n_jobs, out["clean"]
    text = block(chip_smoke.service_pin_values(out), literal)
    if not args.write:
        print(text, end="")
        return 0
    path = ROOT / "chip_smoke.py"
    src = path.read_text()
    head, rest = src.split(BEGIN)
    _, tail = rest.split(END)
    path.write_text(head + text + tail)
    print(f"wrote the service pins into {path.name}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
