#!/usr/bin/env python3
"""A/B of ``csrc/cache_lookup.cu``'s thread path on the card.

Each variant is a few textual edits of the committed source, compiled
alone (``build.nvcc_path()``, ``build.NVCC_FLAGS`` and ``-shared``) into
``build/lookup_variants/`` and loaded with ``ctypes``.  Every variant is
timed by CUDA events on two seeded streams shaped like the two full-size
lookups of ``chip_smoke.py``'s cached path (``chip_smoke.lookup_case``:
2,048 sets of ~2,265 reads and 65,536 sets of ~71 reads, 16 ways), in
turns (the variants in order, then in reverse), the state restored
before each launch; an exact variant's hits and state are held to the
plain version.  The committed source is also timed on its warp path,
and ``--baseline FILE`` times another source of the kernel with the
one-path C interface it had before the thread path (``seg_ptr, tag, pos,
tags, age, hit, U, W, stream``), e.g. the parent commit's.  Prints a
JSON line a measurement and writes them to ``--out``.

    git show HEAD~1:src/repro_torch/csrc/cache_lookup.cu \\
        > build/baseline_lookup.cu
    python3 tools/lookup_variants.py --baseline build/baseline_lookup.cu \\
        --out chiprun_out/lookup_variants.jsonl

on a machine with the card (about a minute of command).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref  # noqa

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "cache_lookup.cu"
OUT_DIR = ROOT / "build" / "lookup_variants"

#: the committed staging: 16-byte cp.async copies a thread
_COPIES = '''#pragma unroll
      for (int q = 0; q < kTagRun / 2; ++q)
        copy16(&s_tag[tid][s][2 * q], tag + at + 2 * q);
#pragma unroll
      for (int q = 0; q < kPosRun / 4; ++q)
        copy16(&s_pos[tid][s][4 * q], pos + ap + 4 * q);
      mbar_arrive_copies(bar);'''
_STEPS = "#pragma unroll\n    for (int j = 0; j < kChunk; ++j) {"
_STEP = """      const unsigned m = held_by(st, c);
      // the slot that comes to the front (none where the lane is idle)
      const unsigned front = upd ? (m ? m : oldest) : 1u;
      ways.to_front(front);
      shift_in(st, front - 1u, upd ? c : st[0]);
      if (upd) hit[s_pos[tid][s][off_p + j]] = m ? 1 : 0;"""
_MISS_STEP = """      bool held = false;
#pragma unroll
      for (int r = 0; r < WM; ++r) held |= st[r] == c;
      if (__any_sync(kFull, upd && held)) {
""" + _STEP + """
      } else if (upd) {
        ways.to_front(oldest);
        shift_in(st, oldest - 1u, c);
        hit[s_pos[tid][s][off_p + j]] = 0;
      }"""
_HELPERS = ("// the thread's arrival on `bar` once its earlier cp.async "
            "copies land")

#: ``name -> (exact, [(old, new), ...])``
VARIANTS = {
    "committed": (True, []),
    # one bulk copy (cp.async.bulk, the TMA) a run, completed on the
    # mbarrier by its bytes
    "bulk": (True, [
        (_HELPERS, '''__device__ __forceinline__ void arrive_tx(
    unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)), "l"(src), "r"(bytes),
      "r"(smem(bar)) : "memory");
}
''' + _HELPERS),
        (_COPIES, '''asm volatile("fence.proxy.async.shared::cta;" :::
                   "memory");
      arrive_tx(bar, kTagRun * 8 + kPosRun * 4);
      bulk_load(&s_tag[tid][s][0], tag + at, kTagRun * 8, bar);
      bulk_load(&s_pos[tid][s][0], pos + ap, kPosRun * 4, bar);''')]),
    # no staging: each step loads its read from device memory
    "unstaged": (True, [
        ("while (next_issue < chunks && next_issue < kStages) issue();", ""),
        ("if (k < chunks) {", "if (false) {"),
        ("const long long cur = s_tag[tid][s][off_t + j];",
         "const long long cur = tag[min(b + t, N - 1)];"),
        ("if (upd) hit[s_pos[tid][s][off_p + j]] = m ? 1 : 0;",
         "if (upd) hit[pos[b + t]] = m ? 1 : 0;")]),
    # timing only: the steps without their hit stores
    "no_hit_store": (False, [
        ("if (upd) hit[s_pos[tid][s][off_p + j]] = m ? 1 : 0;", "")]),
    # a register a slot for the ways at 16 ways too
    "ways_unpacked": (True, [("bool kPacked = (WM <= 16)>",
                              "bool kPacked = false>")]),
    # the steps of a chunk not unrolled
    "unroll_1": (True, [(_STEPS, _STEPS.replace("unroll", "unroll 1"))]),
    # two stages in flight; chunks of 8 reads; blocks of 32 sets
    "stages_2": (True, [("kStages = 3;", "kStages = 2;")]),
    "chunk_8": (True, [("kChunk = 16;", "kChunk = 8;")]),
    "threads_32": (True, [("kThreads = 64;", "kThreads = 32;")]),
    # a shorter path for a step where no lane of the warp hits (a vote
    # and a branch a step)
    "miss_path": (True, [(_STEP, _MISS_STEP)]),
    # timing only: the ways left in place
    "no_ways": (False, [("ways.to_front(front);", "")]),
    # timing only: the tags left in place
    "no_shift": (False, [
        ("shift_in(st, front - 1u, upd ? c : st[0]);", "")]),
}

STREAMS = {"default-like": (2048, 2265), "vertex64m-like": (65536, 71)}


def compile_variant(name, edits, source=SOURCE):
    src = Path(source).read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: anchor not found: {old!r}")
        src = src.replace(old, new)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                          str(cu), "-o", str(so)], capture_output=True,
                         text=True)
    if res.returncode:
        print(f"variant {name} failed to build:\n{res.stderr[-2000:]}",
              file=sys.stderr)
        return None
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_cache_lookup.argtypes = ([P] * 6 + [I, I, P] if name ==
                                       "baseline" else
                                       [P] * 6 + [I, I, L, I, P])
    lib.repro_cache_lookup.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--baseline", default=None,
                    help="another source of the kernel, one path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lookup_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs.card_line()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda kv: compile_variant(kv[0], kv[1][1]), VARIANTS.items())))
    if args.baseline:
        libs["baseline"] = compile_variant("baseline", [], args.baseline)
    libs = {k: v for k, v in libs.items() if v is not None}
    rows = []
    for stream, (U, per) in STREAMS.items():
        arrays = cs.lookup_case(np.random.default_rng(5), U, 16, U * per)
        seg_ptr, tag, pos, tags0, age0 = (torch.as_tensor(a, device=dev)
                                          for a in arrays)
        t_p, a_p = tags0.clone(), age0.clone()
        want = cache_lookup_ref(seg_ptr, tag, pos, t_p, a_p)
        t_k, a_k = tags0.clone(), age0.clone()

        def prep():
            t_k.copy_(tags0)
            a_k.copy_(age0)

        def run(lib, warp):
            hit = torch.empty(tag.shape[0], dtype=torch.bool, device=dev)
            ptrs = (seg_ptr.data_ptr(), tag.data_ptr(), pos.data_ptr(),
                    t_k.data_ptr(), a_k.data_ptr(), hit.data_ptr(), U, 16)
            stream = torch.cuda.current_stream().cuda_stream
            code = (lib.repro_cache_lookup(*ptrs, stream)
                    if lib is libs.get("baseline") else
                    lib.repro_cache_lookup(*ptrs, tag.shape[0], int(warp),
                                           stream))
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")
            return hit

        runs = [(name, False) for name in libs] + [("committed", True)]
        times = {r: [] for r in runs}
        for order in (runs, runs[::-1]):
            for name, warp in order:
                times[name, warp].append(cs.launch_ms(
                    prep, lambda: run(libs[name], warp), reps=args.reps))
        for name, warp in runs:
            prep()
            hit = run(libs[name], warp)
            torch.cuda.synchronize()
            err = max(cs.max_abs_diff(hit.int(), want.int()),
                      cs.max_abs_diff(t_k, t_p), cs.max_abs_diff(a_k, a_p))
            exact = VARIANTS.get(name, (True, []))[0]
            row = {"stream": stream, "sets": U, "reads": int(tag.numel()),
                   "hottest_set_reads": int((seg_ptr[1:]
                                             - seg_ptr[:-1]).max()),
                   "variant": name,
                   "path": "warp" if warp or name == "baseline" else "thread",
                   "ms": times[name, warp], "max_abs_err": err,
                   "exact_required": exact,
                   "bound_ms": cs.lookup_bytes(int(tag.numel()), U, 16)
                   / cs.HBM_BYTES_PER_S * 1e3, "card": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if exact and err:
                raise SystemExit(f"variant {name} differs: {err}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
