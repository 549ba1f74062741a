#!/usr/bin/env python3
"""A/B of design variants of the serve's carry chain on one GPU.

    python3 tools/serve_variants.py [--out FILE] [--baseline FILE]

Each variant is ``src/repro_torch/csrc/dram_serve.cu`` with a few
textual edits (below, each edit must match exactly once).  All variants
compile in parallel, one ``nvcc`` each, into ``build/serve_variants/``
and load by ``ctypes`` beside each other.  The script builds the two
full main-path programs of ``chip_smoke.py`` (the wiki-talk stand-in,
WCC on HitGraph ``[745472, 4, 8]`` and on AccuGraph ``[860160, 1, 8]``),
runs the pre-pass once, and times each variant's serve over the same
records from a cold carry: CUDA events, one warm-up run, then
``--reps`` rounds in which every variant runs once, the committed
source first and again last.  Each variant's finishes and final carry
must hash to the committed source's; a variant that differs is
reported and the script exits non-zero.

Variants:

- ``committed``: the source as it is.
- ``butterfly``: the step's makespan by a log2(K) shuffle butterfly in
  place of one ``redux.sync`` warp reduction.
- ``shuffle_bank``: a bank's new time as the max over its valid lanes by
  shuffles, stored by the bank's last lane (no shared ``atomicMax``).
- ``atomics_first``: the ``atomicMax`` updates of the bank times moved
  ahead of the bus scan.
- ``allpairs_prefix``: ``atomics_first`` with the bus prefix max as K
  all-pairs shuffles in place of the log2(K) scan.
- ``register_banks``: the bank times ``avail``/``act`` in lane registers
  (lane b holds bank b; needs at most 32 banks), read by one shuffle and
  updated by K shuffles in place of shared memory and ``atomicMax``.
- ``direct_stores``: each finish stored by its lane, one global store a
  lane a step, in place of staging a ring chunk's finishes in shared
  memory and storing them by the whole warp.
- ``baseline`` (``--baseline FILE``, in place of the variants above):
  another source of the serve with the same ``repro_dram_serve_batch``
  entry point (or an earlier source's single-case ``repro_dram_serve``,
  which takes no case count), built as it is, e.g. an earlier commit's
  (``git show <commit>:src/repro_torch/csrc/dram_serve.cu >
  build/baseline.cu``), to A/B a change of the committed source against
  it.

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
from repro_torch.sim.session import resolve_run_config  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "dram_serve.cu"
OUT_DIR = ROOT / "build" / "serve_variants"

_REDUX = """        const int mx = __reduce_max_sync(FULL, fin_out);
        const int a_m = m_any ? __reduce_max_sync(FULL, mv ? a : NEG_INF32)
                              : NEG_INF32;
"""
_WRITE_PHASE = """        __syncwarp();
        // ---- write phase: the carry only ever grows (max updates) ----
        if (writer && v && in_b) atomicMax(&s_avail[b], wadd(col, tBL));
        if (m_any) {
          if (writer && mv && in_b) atomicMax(&s_act[b], a);
          if (lane == 0) {
"""
_SCAN_HEAD = "        // shared data bus: prefix max over the valid lanes j <= k\n"
_SCAN = """        int ccm = v ? wadd(col, tcl_lane) : NEG_INF32;
#pragma unroll
        for (int off = 1; off < K; off <<= 1) {
          const int up = __shfl_up_sync(FULL, ccm, off, K);
          if (k >= off) ccm = max(ccm, up);
        }
"""
_ATOMICS_FIRST = [
    (_WRITE_PHASE, """        if (m_any) {
          if (lane == 0) {
"""),
    (_SCAN_HEAD, """        __syncwarp();
        if (writer && v && in_b) atomicMax(&s_avail[b], wadd(col, tBL));
        if (m_any && writer && mv && in_b) atomicMax(&s_act[b], a);
""" + _SCAN_HEAD),
]

VARIANTS = {
    "committed": [],
    "butterfly": [(_REDUX, """        const int mx = seg_max(fin_out, K);
        const int a_m = m_any ? seg_max(mv ? a : NEG_INF32, K) : NEG_INF32;
""")],
    "shuffle_bank": [
        ("""        const int avail_b = in_b ? s_avail[b] : NEG_INF32;
""", """        const int avail_b = in_b ? s_avail[b] : NEG_INF32;
        // valid lanes on this lane's bank, and whether this lane is the
        // last of them
        const bool vb = v && in_b;
        unsigned same = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int bj = __shfl_sync(FULL, b, j, K);
          const int vj = __shfl_sync(FULL, vb ? 1 : 0, j, K);
          same |= (vj && bj == b) ? (1u << j) : 0u;
        }
        const bool last_of_bank = writer && vb && (same >> (k + 1)) == 0;
"""),
        (_WRITE_PHASE, """        // the bank's new time: max over its valid lanes, stored by the last
        const int val = wadd(col, tBL);
        int best = val;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int vj = __shfl_sync(FULL, val, j, K);
          if ((same >> j) & 1) best = max(best, vj);
        }
        __syncwarp();
        if (last_of_bank) s_avail[b] = max(avail_b, best);
        if (m_any) {
          if (writer && mv && in_b) atomicMax(&s_act[b], a);
          if (lane == 0) {
"""),
    ],
    "atomics_first": _ATOMICS_FIRST,
    "allpairs_prefix": _ATOMICS_FIRST + [(_SCAN, """        const int cv = v ? wadd(col, tcl_lane) : NEG_INF32;
        int ccm = cv;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int cj = __shfl_sync(FULL, cv, j, K);
          if (j < k) ccm = max(ccm, cj);
        }
""")],
    "register_banks": [
        ("""  int pmf = pmf_in[c];
""", """  int pmf = pmf_in[c];
  // lane b holds bank b's times (B <= 32)
  int r_avail = lane < B ? avail_in[c * B + lane] : NEG_INF32;
  int r_act = lane < B ? act_in[c * B + lane] : NEG_INF32;
"""),
        ("""        const int avail_b = in_b ? s_avail[b] : NEG_INF32;
""", """        const int avail_sh = __shfl_sync(FULL, r_avail, b & 31);
        const int avail_b = in_b ? avail_sh : NEG_INF32;
"""),
        ("""          const int act_b = in_b ? s_act[b] : NEG_INF32;
""", """          const int act_sh = __shfl_sync(FULL, r_act, b & 31);
          const int act_b = in_b ? act_sh : NEG_INF32;
"""),
        ("""        if (writer && v && in_b) atomicMax(&s_avail[b], wadd(col, tBL));
        if (m_any) {
          if (writer && mv && in_b) atomicMax(&s_act[b], a);
""", """        {
          const int nv = (v && in_b) ? wadd(col, tBL) : INT_MIN;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int bj = __shfl_sync(FULL, b, j);
            const int vj = __shfl_sync(FULL, nv, j);
            if (bj == lane) r_avail = max(r_avail, vj);
          }
        }
        if (m_any) {
          const int na = (mv && in_b) ? a : INT_MIN;
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int bj = __shfl_sync(FULL, b, j);
            const int aj = __shfl_sync(FULL, na, j);
            if (bj == lane) r_act = max(r_act, aj);
          }
"""),
        ("""        for (int i = lane; i < B; i += 32) {
          s_avail[i] = wsub(max(s_avail[i], lo), shift);
          s_act[i] = wsub(max(s_act[i], lo), shift);
        }
""", """        if (lane < B) {
          r_avail = wsub(max(r_avail, lo), shift);
          r_act = wsub(max(r_act, lo), shift);
        }
"""),
        ("""  for (int i = lane; i < B; i += 32) {
    avail_out[c * B + i] = s_avail[i];
    act_out[c * B + i] = s_act[i];
  }
""", """  if (lane < B) {
    avail_out[c * B + lane] = r_avail;
    act_out[c * B + lane] = r_act;
  }
"""),
    ],
    "direct_stores": [
        ("""  const long long fstride = static_cast<long long>(C) * K;
""", """  const long long fstride = static_cast<long long>(C) * K;
  int* fout = fin + c * K + k;
"""),
        ("    for (int i = 0; i < steps; ++i) {",
         "    for (int i = 0; i < steps; ++i, fout += fstride) {"),
        ("        if (writer) s_fin[i * K + k] = 0;\n",
         "        if (writer) *fout = 0;\n"),
        ("        if (writer) s_fin[i * K + k] = fin_out;\n",
         "        if (writer) *fout = fin_out;\n"),
        ("""    // the chunk's finishes, from shared memory, by the whole warp
    __syncwarp();
    for (int e = lane; e < steps * K; e += 32)
      fin[(ch * T + e / K) * fstride + c * K + e % K] = s_fin[e];
    __syncwarp();
""", ""),
    ],
}


def variant_source(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        n = src.count(old)
        if n != 1:
            raise SystemExit(f"an edit matches {n} times, not once:\n{old}")
        src = src.replace(old, new)
    return src


def build_all(names, baseline=None):
    """Compile every variant (and ``baseline``, a source file, when
    given) in parallel; name -> loaded library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(baseline.read_text() if name == "baseline"
                      else variant_source(VARIANTS[name]))
        so = OUT_DIR / f"{name}.so"
        procs.append((name, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(so)], stderr=subprocess.PIPE, text=True)))
    libs = {}
    argtypes, restype = build.SIGNATURES["repro_dram_serve_batch"]
    for name, so, p in procs:
        err = p.communicate(timeout=600)[1]
        if p.returncode:
            raise SystemExit(f"{name} does not build:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(so))
        if hasattr(lib, "repro_dram_serve_batch"):
            # one case: M = 1 before the stream
            fn, cases = lib.repro_dram_serve_batch, (1,)
            fn.argtypes = argtypes
        else:
            # a source from before the case axis: the same arguments
            # without M
            fn, cases = lib.repro_dram_serve, ()
            fn.argtypes = argtypes[:-2] + argtypes[-1:]
        fn.restype = restype
        libs[name] = (fn, cases)
    return libs


def full_program(wt, acc, dev):
    sess = SimSession(wt)
    spec = get_accelerator(acc)
    cfg = resolve_run_config(spec)
    run = sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev)
    program = sess.model_for(spec, cfg).build_program(Problem.WCC, run)
    packed = accel.pack_program(program, cfg.dram_config())
    full = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)
            for a in (packed.issue, packed.meta, packed.boundary,
                      packed.timing)]
    C = cfg.dram_config().channels
    cold = tuple(vec.init_lean_carry(C, packed.n_banks,
                                     packed.banks_per_rank, dev)) + (
        torch.zeros(C, dtype=torch.int32, device=dev),)
    return full, cold


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="time the committed source against this serve "
                         "source alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    names = (list(VARIANTS) if args.baseline is None
             else ["committed", "baseline"])
    libs = build_all(names, args.baseline)
    wt = instantiate("wt", 1.0).undirected_view()
    lines, bad = [], []
    for acc in ("hitgraph", "accugraph"):
        full, cold = full_program(wt, acc, dev)
        S, C, K = full[0].shape
        B, R = cold[0].shape[1], cold[3].shape[1]
        T = ops.chunk_steps(C, K)
        rec = ops.serve_prepass(*full, B // R, R, T)
        fin = torch.empty((S, C, K), dtype=torch.int32, device=dev)
        out = tuple(torch.empty_like(x) for x in cold)
        names = [n for n in libs if n != "register_banks" or B <= 32]

        def call(name):
            stream = torch.cuda.current_stream().cuda_stream
            fn, cases = libs[name]
            code = fn(rec.data_ptr(), full[3].data_ptr(),
                      *(x.data_ptr() for x in cold), fin.data_ptr(),
                      *(x.data_ptr() for x in out), S, rec.shape[1], T, C,
                      K, B, R, *cases, stream)
            if code:
                raise SystemExit(f"{name}: CUDA error {code}")

        digests = {}
        for name in names:
            call(name)
            torch.cuda.synchronize()
            h = hashlib.sha256(fin.cpu().numpy().tobytes())
            for x in out:
                h.update(x.cpu().numpy().tobytes())
            digests[name] = h.hexdigest()
        times = {name: [] for name in names}
        order = names + ["committed"]
        for _ in range(args.reps):
            for name in order:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                call(name)
                b.record()
                b.synchronize()
                times[name].append(a.elapsed_time(b))
        for name in names:
            ms = times[name]
            exact = digests[name] == digests["committed"]
            if not exact:
                bad.append((acc, name))
            line = {"program": acc, "shape": [S, C, K], "variant": name,
                    "exact": exact, "ms": ms, "mean_ms": sum(ms) / len(ms),
                    "us_per_step": sum(ms) / len(ms) * 1e3 / S}
            lines.append(line)
            print(json.dumps(line), flush=True)
        del rec, fin, out, full, cold
        torch.cuda.empty_cache()
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
        print(f"variants that differ from the committed source: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
