#!/usr/bin/env python3
"""Where the device pack's time goes, on one GPU.

    python3 tools/profile_device_pack.py [--out FILE]

Builds the two full main-path programs of ``chip_smoke.py`` (the
wiki-talk stand-in, WCC on HitGraph and on AccuGraph), packs each once on
the card to warm up, then times by the host clock (synchronised) the
whole ``pack_program_device`` call and, apart, the host's share of it
that the port no longer does (the int64 range checks and the int32
padding of the JAX package's packer) beside the copies of the int64
trace to the card, and traces one more pack with ``torch.profiler``: the
device time by operator, largest first (an operator's row and its
kernels' rows both appear; the first traced call also carries the
profiler's own buffer set-up).  Each program's device pack is
held array for array to the host pack first.

Prints one JSON line per program, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def device_us(event) -> float:
    """An operator's own device time (us), under either attribute name
    torch has used for it."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def host_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also append the JSON lines to FILE")
    ap.add_argument("--top", type=int, default=12,
                    help="operators listed by device time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_device_pack: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import accel
    from repro_torch.core import vectorized as vec
    from repro_torch.graphs.datasets import instantiate
    from repro_torch.sim import SimSession, get_accelerator
    from repro_torch.sim.session import resolve_run_config

    dev = torch.device("cuda")
    wt = instantiate("wt", 1.0).undirected_view()
    lines = []
    for acc in ("hitgraph", "accugraph"):
        spec = get_accelerator(acc)
        cfg = resolve_run_config(spec)
        dram = cfg.dram_config()
        sess = SimSession(wt)
        run = sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev)
        prog = sess.model_for(spec, cfg).build_program(Problem.WCC, run)
        host = accel.pack_program(prog, dram)
        packed = accel.pack_program_device(prog, dram, device=dev)
        for name in ("issue", "meta", "boundary", "open_row_final"):
            assert np.array_equal(getattr(packed, name).cpu().numpy(),
                                  getattr(host, name)), (acc, name)
        del packed, host
        N = len(prog)
        N_pad = accel._bucket(N)

        def narrow_on_host():
            np.any(prog.issue < 0) or np.any(
                prog.issue >= vec.MAX_PHASE_ISSUE)
            int(prog.line_addr.max())
            for a in (prog.line_addr, prog.issue):
                out = np.zeros(N_pad, dtype=np.int32)
                out[:N] = a

        row = {
            "accelerator": acc, "requests": N,
            "whole_ms": host_s(lambda: accel.pack_program_device(
                prog, dram, device=dev)) * 1e3,
            "host_narrowing_ms": host_s(narrow_on_host) * 1e3,
            "copy_int64_ms": host_s(lambda: [
                torch.from_numpy(a).to(dev)
                for a in (prog.line_addr, prog.issue)]) * 1e3}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            accel.pack_program_device(prog, dram, device=dev)
            torch.cuda.synchronize()
        ops = sorted(prof.key_averages(), key=device_us, reverse=True)
        row["by_operator_ms"] = {e.key: device_us(e) / 1e3
                                 for e in ops[:args.top] if device_us(e) > 0}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
