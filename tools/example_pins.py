#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 19 (the examples) from the
JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/example_pins.py [--write]

Makes the calls of ``examples/quickstart.py`` through ``repro.sim`` at its
own size (WCC on ``rmat(13, 8)`` on both accelerators, the four §5
variants in one ``sweep``, the event-driven cross-check on
``rmat(9, 4)``) and prints what the phase holds
``examples/torch_quickstart.py``'s run on the card to
(``chip_smoke.quickstart_pin``).  ``--write`` stores
``tools/example_pins.json``.  Takes about 10 s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PINS = ROOT / "tools" / "example_pins.json"
SCALE = 13
SMALL_SCALE = 9
VARIANTS = ("baseline", "prefetch_skip", "partition_skip", "both")


def repro_quickstart(scale: int = SCALE) -> dict:
    """``examples/quickstart.py``'s reports through ``repro.sim``, by the
    parts ``examples/torch_quickstart.py``'s ``run`` returns."""
    from repro.graphs.generators import rmat
    from repro.sim import get_accelerator, simulate, sweep
    g = rmat(scale, 8, seed=0).undirected_view()
    hg = simulate(g, "wcc", accelerator="hitgraph", partition_elements=2048)
    ag = simulate(g, "wcc", accelerator="accugraph", partition_elements=2048)
    ag_cfg = get_accelerator("accugraph").make_config(partition_elements=2048)
    rows = sweep(graphs=[g], problems=["wcc"], accelerators=["accugraph"],
                 variants=list(VARIANTS), configs={"accugraph": ag_cfg})
    gs = rmat(SMALL_SCALE, 4, seed=0).undirected_view()
    cross = {b: simulate(gs, "wcc", accelerator="accugraph", backend=b)
             for b in ("vectorized", "event")}
    return {"hitgraph": hg, "accugraph": ag, "variants": rows,
            "cross_check": cross}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="store the pins in tools/example_pins.json")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    t0 = time.perf_counter()
    pins = {"scale": SCALE,
            "quickstart": chip_smoke.quickstart_pin(repro_quickstart())}
    print(f"quickstart {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    print(json.dumps(pins, indent=1))
    if args.write:
        PINS.write_text(json.dumps(pins, indent=1) + "\n")
        print(f"wrote {PINS.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
