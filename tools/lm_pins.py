#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 15 (the LM serve path) from
the JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_pins.py [--write]

Runs ``chip_smoke.lm_pinned_runs`` (qwen3-0.6b at full width, float32,
cut to ``LM_PINNED_LAYERS`` layers) and ``chip_smoke.lm_family_runs`` (the
ten smoke configurations, float32) through ``repro.models`` with the
NumPy weights of ``chip_smoke.lm_numpy_params`` — the calls the phase
makes through ``repro_torch.models`` on the card — and prints a summary
of the pins: each logit set's top ids and values, the greedy tokens and
each step's top-2 margin.  ``--write`` stores them in
``tools/lm_pins.json``, which the phase reads.  Takes about 90 s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def repro_api():
    """``repro``'s model, engine, configs and its way to take the NumPy
    tree (as JAX arrays)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS, get_config
    from repro.models import lm_engine, model

    def to_params(tree, cfg):
        return jax.tree.map(jnp.asarray, tree)

    return model, lm_engine, get_config, ARCHS, to_params


def runs(smoke, archs=None) -> tuple:
    """The pinned runs and the family runs through ``repro``."""
    M, E, get_config, ARCHS, to_params = repro_api()
    t0 = time.perf_counter()
    pinned = smoke.lm_pinned_runs(M, E, smoke.lm_pinned_config(get_config),
                                  to_params)
    print(f"pinned {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    families = {}
    for arch in archs or ARCHS:
        t0 = time.perf_counter()
        families[arch] = smoke.lm_family_runs(M, E, get_config, to_params,
                                              arch)
        print(f"{arch} {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return pinned, families


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="store the pins in tools/lm_pins.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    pinned, families = runs(smoke)
    pins = {"pinned": smoke.lm_pinned_pin(pinned),
            "families": {arch: smoke.lm_family_pin(r)
                         for arch, r in families.items()}}
    p = pins["pinned"]
    print("pinned tokens", p["tokens"])
    print("pinned min margin",
          min(min(row) for row in p["margins"]))
    for arch, f in pins["families"].items():
        print(arch, "tokens", f["tokens"], "min margin",
              min(min(row) for row in f["margins"]))
    if args.write:
        smoke.LM_PINS.write_text(json.dumps(pins, separators=(",", ":"))
                                 + "\n")
        print(f"wrote {smoke.LM_PINS.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
