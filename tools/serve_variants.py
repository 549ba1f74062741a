#!/usr/bin/env python3
"""A/B of the serve's carry chain on one GPU.

    python3 tools/serve_variants.py [--out FILE] [--baseline FILE] \\
        [--reps N] [--tiles 256,512] [--groups 32] \\
        [--windows 8192:1,1024:4] [--windows-only]

Builds the two full main-path programs of ``chip_smoke.py`` (the
wiki-talk stand-in, WCC on HitGraph ``[745472, 4, 8]`` and on AccuGraph
``[860160, 1, 8]``), runs the pre-pass once for each program and case
count, and times each variant over the same records from a cold carry:
CUDA events, one warm-up run, then ``--reps`` rounds in which every
variant runs once, ``committed`` first and again last.  Each variant's
finishes and carry must hash to ``committed``'s; a variant that differs
is reported and the script exits non-zero.

Programs: each full program for one case and for its DDR3 / DDR4 speed
grades sharing it (4 / 5 cases, ``TIMING_PRESETS``), and windows of
HitGraph's program, ``--windows`` as ``steps:cases`` (by default its first
8,192 steps for one case and first 1,024 steps for four, the short
windows of ``PERF.md`` §6); ``--windows-only`` times the windows alone.

Variants:

- ``committed``: the package's serve over the records by the route
  ``ops.serve_route`` picks (the plan read once beforehand, as the
  serve's check reads it before the pre-pass);
- ``walk``: the package's record walk (one launch, a warp a channel),
  the route short programs take;
- ``chunked T=..,G=..``: the chunked route at each tile length of
  ``--tiles`` and group of ``--groups``, with the milliseconds of its six
  launches (count, scan, transfer, compose, walk, emit) from one more run
  (``ops.serve_records_chunks``);
- ``baseline`` (``--baseline FILE``): another source of the serve with
  the ``repro_dram_serve_batch`` entry point, built as it is, e.g. an
  earlier commit's (``git show <commit>:src/repro_torch/csrc/
  dram_serve.cu > build/baseline.cu``), to time a change against it.

Prints one JSON line per program and variant, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.algorithms.common import Problem  # noqa: E402
from repro_torch.core import accel, vectorized as vec  # noqa: E402
from repro_torch.graphs.datasets import instantiate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dram_timing import ops  # noqa: E402
from repro_torch.sim import SimSession, get_accelerator  # noqa: E402
from repro_torch.sim.memory import TIMING_PRESETS  # noqa: E402
from repro_torch.sim.session import resolve_run_config  # noqa: E402

OUT_DIR = ROOT / "build" / "serve_variants"

#: the speed grades that share each program in its batched serve
GRADES = {"hitgraph": ("ddr3-1066", "ddr3-1333", "ddr3-1866"),
          "accugraph": ("ddr4-2133", "ddr4-2666", "ddr4-2933", "ddr4-3200")}


def build_baseline(source: Path):
    """Compile ``source`` alone; its ``repro_dram_serve_batch``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / "baseline.cu", OUT_DIR / "baseline.so"
    cu.write_text(source.read_text())
    p = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                        str(cu), "-o", str(so)], capture_output=True,
                       text=True, timeout=900)
    if p.returncode:
        raise SystemExit(f"the baseline does not build:\n{p.stderr[-4000:]}")
    fn = ctypes.CDLL(str(so)).repro_dram_serve_batch
    fn.argtypes, fn.restype = build.SIGNATURES["repro_dram_serve_batch"]
    return fn


def full_program(wt, acc, dev):
    sess = SimSession(wt)
    spec = get_accelerator(acc)
    cfg = resolve_run_config(spec)
    run = sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev)
    program = sess.model_for(spec, cfg).build_program(Problem.WCC, run)
    packed = accel.pack_program(program, cfg.dram_config())
    streams = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
               .to(dev) for a in (packed.issue, packed.meta,
                                  packed.boundary)]
    timings = [vec.timing_params(cfg.dram_config().timing)] + [
        vec.timing_params(TIMING_PRESETS[k]) for k in GRADES[acc]]
    timing = torch.as_tensor(np.stack(timings).astype(np.int32), device=dev)
    return streams, timing, packed.n_banks, packed.banks_per_rank


def digest(fin, out) -> str:
    h = hashlib.sha256(fin.cpu().numpy().tobytes())
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="time the committed serve against this source")
    ap.add_argument("--tiles", default="",
                    help="comma-separated tile lengths of the chunked route")
    ap.add_argument("--groups", default=str(ops.SERVE_GROUP),
                    help="comma-separated groups of the chunked route")
    ap.add_argument("--windows", default="8192:1,1024:4",
                    help="windows of HitGraph's program, steps:cases")
    ap.add_argument("--windows-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    build.build()
    baseline = build_baseline(args.baseline) if args.baseline else None
    grid = [(int(t), int(g)) for t in filter(None, args.tiles.split(","))
            for g in args.groups.split(",")]
    wt = instantiate("wt", 1.0).undirected_view()
    lines, bad = [], []
    for acc in ("hitgraph", "accugraph"):
        if args.windows_only and acc != "hitgraph":
            continue
        streams, grades, n_banks, bpr = full_program(wt, acc, dev)
        S_full = streams[0].shape[0]
        shapes = [] if args.windows_only else [(S_full, 1),
                                               (S_full, len(grades))]
        if acc == "hitgraph":
            shapes += [tuple(int(v) for v in w.split(":"))
                       for w in filter(None, args.windows.split(","))]
        for S, M in shapes:
            part = [x[:S].contiguous() for x in streams]
            _, C, K = part[0].shape
            R = n_banks // bpr
            T = ops.chunk_steps(C, K)
            timing = grades[:M].contiguous()
            rec = ops.serve_prepass_batch(*part, timing, bpr, R, T)
            cold = vec._cold_batch_state(M, C, n_banks, bpr, dev)
            plan, _ = ops._records_plan(rec, timing, cold, S)
            variants = {
                "committed": lambda: ops._serve(rec, timing, cold, S, plan,
                                                "committed"),
                "walk": lambda: ops._launch_records(rec, timing, cold, S,
                                                    "walk")}
            for t, g in grid:
                variants[f"chunked T={t},G={g}"] = (
                    lambda t=t, g=g: ops._launch_chunked(
                        rec, timing, cold, S, plan.phase_ends, t, g,
                        "chunked")[:2])
            if baseline is not None:
                def call_baseline():
                    fin = torch.empty((M, S, C, K), dtype=torch.int32,
                                      device=dev)
                    out = tuple(torch.empty_like(x) for x in cold)
                    code = baseline(
                        rec.data_ptr(), timing.data_ptr(),
                        *(x.data_ptr() for x in cold), fin.data_ptr(),
                        *(x.data_ptr() for x in out), S, rec.shape[2], T,
                        C, K, n_banks, R, M,
                        torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise SystemExit(f"baseline: CUDA error {code}")
                    return fin, out
                variants["baseline"] = call_baseline
            digests = {}
            for name, fn in variants.items():
                fin, out = fn()
                torch.cuda.synchronize()
                digests[name] = digest(fin, out)
                del fin, out
            times = {name: [] for name in variants}
            order = list(variants) + ["committed"]
            for _ in range(args.reps):
                for name in order:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    variants[name]()
                    b.record()
                    b.synchronize()
                    times[name].append(a.elapsed_time(b))
            for name in variants:
                ms = times[name]
                exact = digests[name] == digests["committed"]
                if not exact:
                    bad.append((acc, S, M, name))
                line = {"program": acc, "shape": [S, C, K], "cases": M,
                        "variant": name, "exact": exact, "ms": ms,
                        "mean_ms": sum(ms) / len(ms)}
                if name == "committed":
                    line["route"] = plan.route
                if name.startswith("chunked"):
                    t, g = (int(v.split("=")[1])
                            for v in name.split()[1].split(","))
                    line["pass_ms"] = ops.serve_records_chunks(
                        rec, timing, cold, S, t, g, time_passes=True)[2]
                lines.append(line)
                print(json.dumps(line), flush=True)
            del rec, cold
            torch.cuda.empty_cache()
        del streams
    line = {"serve_routes": ops.serve_routes()}
    lines.append(line)
    print(json.dumps(line), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines)
                            + card + "\n")
    if bad:
        print(f"variants that differ from the committed serve: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
