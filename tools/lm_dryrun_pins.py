#!/usr/bin/env python3
"""Make the pins of ``chip_smoke.py``'s phase 18 dry-run part
(``lm_dryrun``) and of ``tests/test_torch_lm_dryrun.py``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_dryrun_pins.py \\
        [--write] [--jobs N] [--archs a,b] [--skip-grid]
        [--cells arch/shape,...]

Three parts, each in processes of its own:

* ``script``: ``tests/test_dryrun_small.py``'s ``SCRIPT`` configuration
  (qwen3-smoke with 2 layers and vocab 512; ``train_4k`` cut to 128 x 8,
  ``decode_32k`` to 256 x 8) through ``repro``'s dry-run machinery on an
  ``Auto``-axis ``(4, 2)`` mesh of 8 XLA host devices (XLA's memory and
  cost analyses, ``hlo_parse.analyze_collectives``, every argument
  leaf's shard bytes), and through the port's ``launch.dryrun.measure``
  on a fake world of 8 ranks as ``make_host_mesh``'s ``(4, 2)``;
* ``port``: ``python -m repro_torch.launch.dryrun --arch A --shape S
  [--multi-pod] --device cpu`` for every architecture, shape and mesh,
  ``--jobs`` at once: every cell's ``CellReport`` at the published
  config (full depth); and each cell of CUT_CELLS cut in depth
  (``cuts``);
* ``repro``: ``repro.launch.dryrun.run_cell`` on every cell, one process
  an architecture, its ``make_production_mesh`` replaced by an
  ``Auto``-axis mesh (``jax.make_mesh``'s default ``Explicit`` axes make
  ``repro``'s ``constrain`` raise under JAX 0.9.0); ``repro`` is not
  edited;
* ``leaves``: the cells of LEAF_CELLS on both production meshes, leaf by
  leaf: ``repro``'s ``_build_fn_and_args`` compiled on the ``Auto``-axis
  mesh (every argument leaf's and output leaf's shard bytes, the leaves
  ``jax.jit`` drops as unused, XLA's argument and output sizes) and the
  port's ``measure`` on the fake world (``local_bytes_by_leaf`` of its
  arguments and outputs).

A part that does not finish within its time limit (PART_TIMEOUT_S) leaves
its cells out, and the JSON lists them (``left_out``).  The fake step runs
op by op from Python, but a prefill's recurrences count a few iterations
and scale them (``models.ssm.scan``), so no cell comes near the limit.
``--write`` stores ``tools/lm_dryrun_pins.json``; without it the tool
prints a summary.  The grid takes about 25 minutes with 6 jobs.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PINS = ROOT / "tools" / "lm_dryrun_pins.json"
#: ``tests/test_dryrun_small.py``'s cut of the configuration and shapes
SCRIPT_CONFIG = {"arch": "qwen3_0_6b", "smoke": True, "n_layers": 2,
                 "vocab": 512, "mesh": [4, 2],
                 "shapes": {"train_4k": ["train", 128, 8],
                            "decode_32k": ["decode", 256, 8]}}
PART_TIMEOUT_S = 1800
#: the architectures whose train step differentiates a long Python loop
#: (sLSTM's 4,096 steps): their cells start first
RECURRENT = ("xlstm_1_3b", "hymba_1_5b")
#: cells run cut in depth (``--layers``; the widths as published), for
#: ``chip_smoke.py``'s phase 18: ``(arch, shape, multi_pod, layers)``
CUT_CELLS = [["xlstm_1_3b", "train_4k", True, 8]]
#: the cells whose bytes differed from ``repro``'s before the port's
#: logits layout was repaired, compared leaf by leaf (``ROADMAP.md`` §3)
LEAF_CELLS = [["phi_3_vision_4_2b", "decode_32k"],
              ["whisper_tiny", "decode_32k"],
              ["whisper_tiny", "prefill_32k"],
              ["hymba_1_5b", "long_500k"]]

#: ``repro``'s side of ``script``: prints one JSON object
REPRO_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, re, sys
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import context as dctx, sharding as shd
from repro.launch import specs as SP
from repro.launch.hlo_parse import analyze_collectives

conf = json.loads(sys.argv[1])
mesh = jax.make_mesh(tuple(conf["mesh"]), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_config(conf["arch"], smoke=conf["smoke"]),
                          n_layers=conf["n_layers"], vocab=conf["vocab"])
SP.SHAPE_SPECS = dict(SP.SHAPE_SPECS)
for name, (kind, seq, batch) in conf["shapes"].items():
    SP.SHAPE_SPECS[name] = SP.ShapeSpec(name, kind, seq, batch)
from repro.launch.dryrun import _build_fn_and_args


def key(path):
    return "/".join(re.findall(r"\[['\"]?([^\]'\"]+)['\"]?\]",
                               jax.tree_util.keystr(path)))


out = {}
with dctx.use(shd.make_ctx(cfg, mesh, False)):
    for shape in conf["shapes"]:
        fn, args, in_sh, out_sh = _build_fn_and_args(cfg, shape, mesh, False)
        jt = (jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
              if out_sh is not None else jax.jit(fn, in_shardings=in_sh))
        compiled = jt.lower(*args).compile()
        mem = compiled.memory_analysis()
        cost = compiled.cost_analysis() or {}
        coll, counts = analyze_collectives(compiled.as_text())
        shs = jax.tree.leaves(in_sh, is_leaf=lambda x: isinstance(
            x, jax.sharding.Sharding))
        per = {}
        for (path, a), s in zip(jax.tree_util.tree_leaves_with_path(args),
                                shs):
            per[key(path)] = (int(np.prod(s.shard_shape(a.shape)))
                              * a.dtype.itemsize)
        out[shape] = {
            "arg_bytes_per_device": int(mem.argument_size_in_bytes),
            "output_bytes_per_device": int(mem.output_size_in_bytes),
            "temp_bytes_per_device": int(mem.temp_size_in_bytes),
            "collective_bytes": coll, "collective_counts": counts,
            "flops": float(cost.get("flops", 0.0)),
            "hlo_bytes": float(cost.get("bytes accessed", 0.0)),
            "output_leaves": len(jax.tree.leaves(jax.eval_shape(fn, *args))),
            "arg_bytes_by_leaf": per}
print(json.dumps(out))
"""

#: ``repro``'s ``run_cell`` over one architecture's cells on an
#: ``Auto``-axis production mesh: prints one JSON list
REPRO_CELLS = r"""
import json, sys
import repro.launch.dryrun as DR        # sets XLA_FLAGS (512 devices) first
import jax
from jax.sharding import AxisType
from repro.launch.specs import SHAPES


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))


DR.make_production_mesh = auto_mesh
reports = [DR.run_cell(sys.argv[1], s, mp, verbose=False).to_json()
           for s in SHAPES for mp in (False, True)]
print(json.dumps(reports))
"""


#: ``repro``'s side of ``leaves``: prints one JSON object, a cell each
REPRO_LEAVES = r"""
import json, re, sys
import repro.launch.dryrun as DR        # sets XLA_FLAGS (512 devices) first
import jax
import numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.distributed import context as dctx, sharding as shd


def key(path):
    return "/".join(re.findall(r"\[['\"]?([^\]'\"]+)['\"]?\]",
                               jax.tree_util.keystr(path)))


def shard_bytes(tree, shardings):
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.Sharding))
    return [(key(path), int(np.prod(s.shard_shape(a.shape)))
             * a.dtype.itemsize) for (path, a), s in
            zip(jax.tree_util.tree_leaves_with_path(tree), shs)]


out = {}
for arch, shape in json.loads(sys.argv[1]):
    for mp in (False, True):
        n = (2, 16, 16) if mp else (16, 16)
        mesh = jax.make_mesh(n, ("pod", "data", "model")[-len(n):],
                             axis_types=(AxisType.Auto,) * len(n))
        cfg = get_config(arch)
        with dctx.use(shd.make_ctx(cfg, mesh, mp)):
            fn, args, in_sh, out_sh = DR._build_fn_and_args(cfg, shape,
                                                            mesh, mp)
            jt = (jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
                  if out_sh is not None else
                  jax.jit(fn, in_shardings=in_sh))
            lowered = jt.lower(*args)
            compiled = lowered.compile()
        kept = lowered._lowering.compile_args["kept_var_idx"]
        arg = shard_bytes(args, in_sh)
        mem = compiled.memory_analysis()
        out[f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"] = {
            "arg_bytes_by_leaf": dict(arg),
            "unused_args": [k for i, (k, _) in enumerate(arg)
                            if i not in kept],
            "output_bytes_by_leaf": dict(shard_bytes(
                jax.eval_shape(fn, *args), compiled.output_shardings)),
            "arg_bytes_per_device": int(mem.argument_size_in_bytes),
            "output_bytes_per_device": int(mem.output_size_in_bytes)}
print(json.dumps(out))
"""


def port_leaves() -> dict:
    """The port's side of ``leaves``, in this process: each cell of
    LEAF_CELLS on both fake production worlds."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for arch, shape in LEAF_CELLS:
        for mp in (False, True):
            detail = {}
            with DR.fake_world(512 if mp else 256):
                mesh = make_production_mesh(multi_pod=mp, device="cpu")
                got = DR.measure(get_config(arch), shape, mesh, mp, "cpu",
                                 detail)
            out[f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"] = {
                "arg_bytes_by_leaf": DR.local_bytes_by_leaf(
                    tuple(detail["args"])),
                "output_bytes_by_leaf": DR.local_bytes_by_leaf(
                    tuple(detail["out"])),
                "arg_bytes_per_device": got["arg_bytes_per_device"],
                "output_bytes_per_device": got["output_bytes_per_device"]}
    return out


def _env(jax: bool):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(cmd, jax: bool, timeout: float):
    """A command's last stdout line as JSON, or the reason it has none."""
    try:
        res = subprocess.run(cmd, env=_env(jax), capture_output=True,
                             text=True, timeout=timeout, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return None, f"timed out after {timeout:.0f} s"
    if res.returncode not in (0, 1):
        return None, f"exit {res.returncode}: {res.stderr[-500:]}"
    # the result is the last line that parses as JSON (JAX's, XLA's and
    # the dry run's own prints may surround it)
    for line in reversed(res.stdout.splitlines()):
        try:
            return json.loads(line), ""
        except ValueError:
            continue
    return None, f"no JSON line: {res.stdout[-500:]}"


def port_script() -> dict:
    """The port's side of ``script``, in this process (fake world of 8)."""
    import dataclasses
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_host_mesh

    conf = SCRIPT_CONFIG
    cfg = dataclasses.replace(
        get_config(conf["arch"], smoke=conf["smoke"]),
        n_layers=conf["n_layers"], vocab=conf["vocab"])
    saved = dict(SP.SHAPE_SPECS)
    try:
        for name, (kind, seq, batch) in conf["shapes"].items():
            SP.SHAPE_SPECS[name] = SP.ShapeSpec(name, kind, seq, batch)
        out = {}
        for shape in conf["shapes"]:
            detail = {}
            with DR.fake_world(conf["mesh"][0] * conf["mesh"][1]):
                mesh = make_host_mesh(conf["mesh"][1], device="cpu")
                got = DR.measure(cfg, shape, mesh, False, "cpu", detail)
            by_leaf = {}
            for i, a in enumerate(detail["args"]):
                for k, n in DR.local_bytes_by_leaf(a, f"{i}/").items():
                    by_leaf[k] = n
            out[shape] = {**got, "collective_counts_by_axis":
                          detail["by_axis"], "arg_bytes_by_leaf": by_leaf}
        return out
    finally:
        SP.SHAPE_SPECS.clear()
        SP.SHAPE_SPECS.update(saved)


def port_cells(arch: str, shape: str, timeout: float, multi_pod: bool,
               layers=None):
    """The port's cell of ``arch`` x ``shape`` on one production mesh, at
    full depth or cut to ``layers`` (the report then says so)."""
    cut = [] if layers is None else ["--layers", str(layers)]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "cells.json")
        _, why = _run([sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       *["--multi-pod"] * multi_pod, *cut, "--device",
                       "cpu", "--out", out], False,
                      timeout)
        if not os.path.exists(out):
            return None, why or "no report"
        with open(out) as f:
            cells = json.load(f)
        if layers is not None:
            for c in cells:
                c["layers"] = layers
        return cells, ""


def repro_cells(arch: str, timeout: float):
    return _run([sys.executable, "-c", REPRO_CELLS, arch], True, timeout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="store the pins in tools/lm_dryrun_pins.json")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--archs", default=None,
                    help="comma-separated architectures (default: all)")
    ap.add_argument("--skip-grid", action="store_true",
                    help="the script and leaves parts only; keep the "
                         "pinned grids")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape: the port's cells "
                         "to remake (both meshes) beside the script, "
                         "leaves and cuts parts; keep the other pinned "
                         "cells")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS
    from repro_torch.launch.specs import SHAPES

    archs = args.archs.split(",") if args.archs else list(ARCHS)
    old = json.loads(PINS.read_text()) if PINS.exists() else {}
    pins = {"script": {"config": SCRIPT_CONFIG}, "port": [], "repro": [],
            "left_out": [], "cuts": [], "leaves": {"cells": LEAF_CELLS}}
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        rep_script = pool.submit(_run, [sys.executable, "-c", REPRO_SCRIPT,
                                        json.dumps(SCRIPT_CONFIG)], True,
                                 PART_TIMEOUT_S)
        grid = {("cuts", a, (s, mp, n)): pool.submit(
            port_cells, a, s, PART_TIMEOUT_S, mp, n)
            for a, s, mp, n in CUT_CELLS}
        chosen = ([tuple(c.split("/")) for c in args.cells.split(",")]
                  if args.cells else [])
        if not args.skip_grid:
            # a process a cell, the trained recurrences (the longest)
            # first: each process has PART_TIMEOUT_S from its start
            cells = sorted(((a, s, mp) for a in archs for s in SHAPES
                            for mp in (False, True)
                            if not chosen or (a, s) in chosen),
                           key=lambda c: (c[1] != "train_4k",
                                          c[0] not in RECURRENT))
            for arch, shape, mp in cells:
                grid[("port", arch, (shape, mp))] = pool.submit(
                    port_cells, arch, shape, PART_TIMEOUT_S, mp)
            for arch in [] if chosen else archs:
                grid[("repro", arch, None)] = pool.submit(
                    repro_cells, arch, PART_TIMEOUT_S)
        rep_leaves = pool.submit(_run, [sys.executable, "-c", REPRO_LEAVES,
                                        json.dumps(LEAF_CELLS)], True,
                                 PART_TIMEOUT_S)
        pins["script"]["port"] = port_script()
        pins["leaves"]["port"] = port_leaves()
        pins["script"]["repro"], why = rep_script.result()
        if why:
            raise SystemExit(f"repro's script part failed: {why}")
        pins["leaves"]["repro"], why = rep_leaves.result()
        if why:
            raise SystemExit(f"repro's leaves part failed: {why}")
        for (side, arch, shape), fut in grid.items():
            cells, why = fut.result()
            if cells is None:
                pins["left_out"].append({"side": side, "arch": arch,
                                         "shape": shape, "reason": why})
            else:
                pins[side].extend(cells)
    pins["port"].sort(key=lambda c: (c["arch"], SHAPES.index(c["shape"]),
                                     c["mesh"]))
    if args.skip_grid:
        for k in ("port", "repro"):
            pins[k] = old.get(k, [])
        pins["left_out"] += [c for c in old.get("left_out", [])
                             if c["side"] != "cuts"]
    elif chosen:
        pins["port"] += [c for c in old.get("port", [])
                         if (c["arch"], c["shape"]) not in chosen]
        pins["port"].sort(key=lambda c: (c["arch"],
                                         SHAPES.index(c["shape"]),
                                         c["mesh"]))
        pins["repro"] = old.get("repro", [])
        pins["left_out"] += [
            c for c in old.get("left_out", []) if c["side"] == "repro"
            or (c["side"] == "port"
                and (c["arch"], c["shape"][0]) not in chosen)]
    for shape in SCRIPT_CONFIG["shapes"]:
        p, r = pins["script"]["port"][shape], pins["script"]["repro"][shape]
        print(shape, {k: (p[k], r[k]) for k in (
            "arg_bytes_per_device", "output_bytes_per_device",
            "temp_bytes_per_device")},
            "coll", sum(p["collective_bytes"].values()),
            sum(r["collective_bytes"].values()))
    for cell, p in pins["leaves"]["port"].items():
        r = pins["leaves"]["repro"][cell]
        print(cell, {f: (p[f], r[f]) for f in (
            "arg_bytes_per_device", "output_bytes_per_device")},
            "unused", r["unused_args"], "outputs differing", {
                k: (v, r["output_bytes_by_leaf"].get(k))
                for k, v in p["output_bytes_by_leaf"].items()
                if v != r["output_bytes_by_leaf"].get(k)})
    for c in pins["cuts"]:
        print("cut", c["arch"], c["shape"], c["mesh"], c["layers"],
              c["status"], c["compile_seconds"])
    for side in ("port", "repro"):
        cells = pins[side]
        print(side, len(cells), "cells:",
              {s: sum(c["status"] == s for c in cells)
               for s in ("ok", "skipped", "failed")})
    for c in pins["left_out"]:
        print("left out", c)
    if args.write:
        PINS.write_text(json.dumps(pins, indent=1) + "\n")
        print(f"wrote {PINS.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
