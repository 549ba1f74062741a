#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 17 cost part (``lm_cost``)
from the JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_cost_pins.py [--write]

Runs ``chip_smoke.lm_cost_runs`` through ``repro.core.hbm_adapter`` and
``repro.launch.roofline`` — the calls the phase makes through the port on
the card: the four access patterns' bandwidth fractions
(``pattern_fractions()``, 16,384 lines a trace), each family's and
decode's effective fraction, and the roofline row of every architecture
at every shape it supports on the "16x16" mesh (256 chips, 5e9
collective bytes a chip), and prints a summary.  ``--write`` stores them
in ``tools/lm_cost_pins.json``, which the phase reads.  Takes a few
seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def repro_api():
    """``repro``'s side of ``chip_smoke.lm_cost_runs``."""
    from repro.configs import ARCHS, get_config
    from repro.core import hbm_adapter as H
    from repro.launch import roofline as R
    from repro.launch import specs
    return types.SimpleNamespace(
        pattern_fractions=H.pattern_fractions,
        effective_bandwidth_fraction=H.effective_bandwidth_fraction,
        analyze_cell=R.analyze_cell, render_table=R.render_table,
        shape_supported=specs.shape_supported, SHAPES=specs.SHAPES,
        ARCHS=ARCHS, get_config=get_config)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="store the pins in tools/lm_cost_pins.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    pins = smoke.lm_cost_runs(repro_api())
    print("fractions", pins["fractions"])
    print("families", pins["families"])
    print(pins["table"])
    if args.write:
        smoke.LM_COST_PINS.write_text(json.dumps(pins, indent=1) + "\n")
        print(f"wrote {smoke.LM_COST_PINS.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
