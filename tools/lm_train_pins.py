#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 16 (LM training) from the
JAX package on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_train_pins.py [--write]

Runs ``chip_smoke.lm_train_runs`` through ``repro.train`` with the NumPy
weights of ``chip_smoke.lm_numpy_params`` — the calls the phase makes
through ``repro_torch.train`` on the card: qwen3-0.6b at full width
(d = 1,024, vocab 151,936) cut to ``LM_PINNED_LAYERS`` layers in float32,
3 AdamW steps and 3 with ``grad_accum=2``, then one step of each of the
ten smoke configurations (and one with ``grad_accum=2`` for
``LM_TRAIN_ACCUM``).  It records each step's loss, step 1's global and
per-leaf grad norms, the lr, and a sample of every parameter after the
last step, and prints a summary.  ``--write`` stores them in
``tools/lm_train_pins.json``, which the phase reads.  The full-width part
holds the weights, gradients and both moments of 217 M parameters and
their NumPy copies at once: the process peaks at about 7 GB of host
memory.  Takes about 90 s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def repro_api(smoke):
    """``repro``'s side of ``chip_smoke.lm_train_runs``: its data, loss
    and gradients (``jax.value_and_grad(lm_loss)``), optimizer and step,
    each jitted as ``make_train_step(jit=True)`` compiles it."""
    import jax
    import jax.numpy as jnp

    from repro.train import data as D
    from repro.train import optimizer as O
    from repro.train import step as S

    hp = O.AdamWConfig(**smoke.LM_TRAIN_HP)
    grads = jax.jit(jax.value_and_grad(S.lm_loss), static_argnums=2)
    schedule = jax.jit(lambda s: O._schedule(s, hp))

    def arrays(batch):
        return {k: jnp.asarray(v) for k, v in batch.items()}

    def make_step(cfg, ga):
        step = jax.jit(S.make_train_step(cfg, hp, ga, jit=False))
        return lambda p, s, b: step(p, s, arrays(b))

    return types.SimpleNamespace(
        to_params=lambda tree, cfg: jax.tree.map(jnp.asarray, tree),
        init_opt=O.init,
        make_batch=lambda cfg, data, i: D.make_batch(
            cfg, D.DataConfig(**data), i),
        loss_and_grads=lambda p, b, cfg: grads(p, arrays(b), cfg),
        global_norm=O.global_norm,
        schedule=lambda i: float(schedule(jnp.asarray(i, jnp.int32))),
        make_step=make_step)


def runs(smoke, archs=None, pinned=True) -> tuple:
    """The pinned runs and the family runs through ``repro``."""
    from repro.configs import ARCHS, get_config
    api = repro_api(smoke)
    out = None
    if pinned:
        t0 = time.perf_counter()
        out = smoke.lm_train_runs(api, smoke.lm_pinned_config(get_config),
                                  smoke.LM_TRAIN_PINNED_DATA,
                                  smoke.LM_TRAIN_PINNED_STEPS, (1, 2))
        print(f"pinned {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    families = {}
    for arch in archs or ARCHS:
        t0 = time.perf_counter()
        families[arch] = smoke.lm_train_runs(
            api, smoke.lm_train_family_config(get_config, arch),
            smoke.LM_TRAIN_FAMILY_DATA, smoke.LM_TRAIN_FAMILY_STEPS,
            smoke.lm_train_family_accums(arch))
        print(f"{arch} {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return out, families


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="store the pins in tools/lm_train_pins.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke

    pinned, families = runs(smoke)
    pins = {"pinned": smoke.lm_train_pin(pinned),
            "families": {arch: smoke.lm_train_pin(r)
                         for arch, r in families.items()}}
    for name, r in [("pinned", pinned), *families.items()]:
        assert r["grads_finite"], f"{name}: repro's gradients not finite"
        print(name, "losses", {k: r[k]["losses"] for k in r
                               if k.startswith("accum")},
              "grad norm", r["grad_norm"])
    if args.write:
        smoke.LM_TRAIN_PINS.write_text(
            json.dumps(pins, separators=(",", ":")) + "\n")
        print(f"wrote {smoke.LM_TRAIN_PINS.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
