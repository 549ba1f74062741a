#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — require CUDA; report the card (``nvidia-smi``).
2. build    — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernels  — each CUDA kernel against its plain PyTorch version on the
              card: ``dram_serve`` on seeded random programs (4 memories x
              block widths K=1/8, carry chained across two calls) and on
              blocks the packer never makes (several misses, banks past
              the channel's), its pre-pass's records against theirs,
              ``dram_timing`` on seeded random traces (DDR3, DDR4, HBM2, a
              2-rank DDR4, and one bulk trace that trips the tFAW window;
              carry chained across two calls; also at chunks of 64 slots,
              and the serial kernel ``dram_timing_serial``), the round sweep
              (``sweep_min_block``) and the serial sweep on rmat(12, 4)
              (add 0 and 1, from ``arange`` and a warm start), bit for bit; ``segment_reduce`` (sum/min/max in f32,
              sum in bf16; and on run layouts: sorted, unsorted, one
              run over many tiles, runs ending at thread, warp and tile
              edges, d = 1 and 3), ``edge_scatter`` (copy/add/mul) and
              ``spmv_ell`` (the row-major entry point at narrow and wide
              k; the sliced-ELL pull at three heavy thresholds) on seeded
              cases with out-of-range ids, to the stated tolerances;
              ``cache_lookup`` on seeded set-sorted streams (1, 16, 32
              ways on the thread path, 33 and 64 on the warp path, a hot
              set; tags past 2**31, rows and reads handed to the warp
              path; a stream shaped like the default cache's), each also
              through the warp path alone, bit for bit;
              ``dram_serve_batch`` and its pre-pass's records on seeded
              programs, one shared by every case and M stacked ones whose
              phase boundaries fall on different steps (M = 1, 3, 5; C =
              1, 4; K = 1, 8; each case its own timing vector), and a
              shared program of M = 133 cases, bit for bit.
4. goldens  — the 24 rmat7/rmat8 keys of ``tests/goldens/simreports.json``
              (HitGraph, AccuGraph and the reference machine) through
              ``simulate`` on the card; then the sweep's worst case, an ascending path of
              2^20 vertices (the route, the rounds, the time of each
              route), and a descending path (one round).
5. main     — the main path at full size: the paper's Tab. 1 wiki-talk
              stand-in (2,394,385 vertices, 10 M undirected edges), WCC on
              HitGraph (Tab. 4: q = 256,000, 4 DDR3 channels) and on
              AccuGraph (q = n, 1 DDR4 channel), through
              ``SimSession.run``, with the kernel launch counts zeroed
              just before and read just after: 5 round sweeps, no serial
              one, one pre-pass and one serve a program; the reports'
              runtimes as the serve's first design gave them.
6. dynamic  — the dynamic-graph path at full size on the same graph,
              through ``run_dynamic(..., verify=True)``: HitGraph WCC under
              ``uniform-churn`` (3 epochs, inserts and deletes) and
              AccuGraph WCC under ``pa-growth`` (3 epochs), sharing the
              main path's sessions, with the launch counts zeroed just
              before and read just after (one chunked ``dram_timing`` a
              rewrite phase, no serial one); one row per epoch.  The
              first rewrite phase's kernel inputs are kept for phase 8.
7. stationary — the stationary path at full size on the same graph and
              sessions: PR and SpMV with ``fixed_iters=3`` on HitGraph
              (``edge_scatter`` + ``segment_reduce`` a step over the
              destination-sorted edges) and AccuGraph (one ``spmv_ell``
              launch a step over the sliced ELL), launch counts zeroed
              just before each run and held to one a step; values held
              to a float64 recompute, PR's report to SpMV's; the time of
              each engine's set-up (the sort, the packing) beside.
7b. cache   — the main path with ``cache="default"`` at full size on
              both accelerators, sharing the main sessions: HitGraph's
              8-deep stream prefetcher (its runtime never above the
              uncached one) and AccuGraph's 2 MiB 16-way vertex BRAM
              (every lookup misses at this size), then AccuGraph with a
              64 MiB 16-way vertex cache, which holds an iteration's
              reads (4 of 5 iterations hit); launch and route counts
              zeroed around each case; the ``cache_lookup`` launches are
              kept and held bit for bit to the plain version on the card
              and timed against their byte bound, by the thread path and
              by the warp path; counters and runtimes
              pinned.  Then a cached
              AccuGraph ``pa-growth`` dynamic run (2 epochs,
              ``verify=True``) with the lines each epoch invalidates.
              Every run of phases 5-7b packs on the card: the route
              counters show no host pack.
8. compare  — each full main-path program packed on the card and on the
              host, array for array (``device_pack`` lines: the device
              pack's CUDA-event time, the host pack's seconds); then
              every kernel against its plain version on the paths' own
              inputs: a window of each packed wiki-talk program that
              crosses a phase boundary (served as two chained kernel
              calls; the pre-pass's records too), each full program
              (pre-pass and serve timed apart, finishes and carry held to
              their pinned digest), the AccuGraph block's 5 WCC sweeps
              (each held to the serial kernel; the first also on the
              serial route and by the plain loop), the first rewrite
              phase of each dynamic run, ``[4, 524288]`` (HitGraph) and
              ``[1, 1048576]`` (AccuGraph), whole (the chunked scan held
              bit for bit to the serial kernel, timed pass by pass and at
              every chunk length) and as an 8,192-slot window (two
              chained kernel calls, both kernels held to the plain
              version), and the full-size PR scatter and
              gather (destination-sorted, and in raw edge order) and the
              whole pull step; kernel and plain times on the same
              inputs, one PyTorch call's time where one computes the
              same function (the gather also beside
              ``torch.segment_reduce``), and the pull's bound over the
              edges beside the bound over the slots of the per-bucket
              layout it ran on before.

9. event    — the event-driven side, held to the kernels: ``trace``
              lines, the host's element replay ``simulate_trace`` against
              ``simulate_trace_device`` (one chunked ``dram_timing``
              launch) on 2^20 seeded requests (DDR3-1600K with 4 channels
              and 2 ranks, DDR4-2400R, HBM2 with 8 channels, and a bulk
              trace that trips tFAW), bit for bit on the finishes, kind
              counts and channel makespans; ``event_main`` lines, the main
              path's two full-size WCC runs again through
              ``backend="event"`` on the main sessions, every report field
              equal to the vectorized report and no serve launched;
              ``reference`` lines, WCC and BFS on the reference machine
              (``REFERENCE_SCALE``; its algorithm run equal to AccuGraph's
              ``q = n`` run, its requests to the count its streams imply,
              round sweeps only); ``analytical`` lines, the closed-form
              estimate beside the simulated main-path runtime; a ``study``
              line, ``run_study``'s five AccuGraph variants
              (``STUDY_SCALE``), each variant's values equal to the
              baseline's.
10. sweep   — the sweep engine at full size: ``Sweeper(batch_memories=
              True)`` over WCC on the wiki-talk stand-in, each
              accelerator's default memory and three timing variants of
              it (``SWEEP_KINDS``; 4 cases sharing one pack), launch
              counts zeroed just before and read just after: one
              ``dram_serve_batch`` and one batched pre-pass an
              accelerator, no per-case serve, no host pack; the
              ``SweepStats`` pinned (``SWEEP_STATS``); every row equal to
              ``run_case`` on the same sweeper (``sweep_row`` lines) and
              the default rows to the main path's pinned runtimes; the
              batched serve timed (pre-pass apart; a full serve by one
              call between CUDA events, which also gives the output
              checked) beside the four per-case serves and the bound of
              its own bytes (the shared program read once), every case's
              finishes and carry equal to the per-case kernel's (case
              0's to the pinned digest), and a 1,024-step window held to
              the plain version (``sweep_serve`` lines); the stacked
              route at full size, HitGraph under DDR3-1600K and
              DDR3-1333H (the same structure at a slower clock: two
              programs of one shape) in one ``dram_serve_batch`` launch,
              rows equal to ``run_case``, each case to the per-case
              kernel, timed beside the bound (a ``sweep_serve`` line);
              then the stacked path on a small graph (AccuGraph on
              rmat(8, 5) under two DRAM densities) equal to the CPU
              sweep, ``Sweeper(workers=2)`` over HitGraph's four cases
              equal to the batched rows, and one ``updates="pa-growth"``
              AccuGraph case on ``instantiate("wt", 0.1)`` equal to
              ``run_dynamic`` epoch
              for epoch (``sweep_paths``).
11. corpus  — the corpus at each preset's own size, every graph built
              by the port into a fresh, empty store: the grid of
              ``benchmarks/corpus_sweep.py`` (6 presets x WCC, PR x both
              accelerators x default memory, HBM2: 48 rows) through
              ``Sweeper(workers=2)``; its ordering arms (``powerlaw-
              social:{degree,bfs,shuffle}``, ``road-grid:{bfs,shuffle}``,
              WCC, 10 rows) through a batched sweeper; AccuGraph WCC with
              its BRAM (``cache="default"``) on each grid graph (6 rows);
              one ``ScenarioSpec`` (an ordering, HBM2 and the BRAM) beside
              its keyword form, and one dynamic spec (``pa-growth``)
              beside ``run_dynamic`` on the preset's name.  Every
              fingerprint, row, counter, warning and epoch equal to the
              JAX package's pins (``tools/corpus_pins.py``), the
              benchmark's contracts asserted where those pins hold them,
              and the launch counts zeroed around each part: every
              kernel of the port's paths launched.
12. service — the service and the tuner (``service_runs``), counts zeroed
              around each part: ``benchmarks/service_load.py``'s workload
              (4 clients x 3 one-case HitGraph jobs on the lj and yt
              stand-ins at ``SERVICE_SCALE``) through one resident
              ``SimService`` (every job done, no retry, every row equal
              to the JAX package's pin), then under the benchmark's fault
              mix at chaos seed 0 (the chaos plans pinned, each planned
              fault injected once, every job done and its row equal to
              the clean one); a resident graph (phase 11's dynamic spec)
              taking two update jobs, each epoch equal to its pin and to
              ``run_dynamic`` (run outside the graph's launch count);
              ``benchmarks/autotune.py``'s search on powerlaw-social at
              its own size, with 2 and 1 preparing workers and through
              the service's ``submit_search``, each front equal to the
              pin and non-dominated in the 16-point exhaustive sweep
              (``tools/service_pins.py`` makes the pins).
13. lock_witness — the port's threads on the card under the lock witness
              (``REPRO_ANALYSIS_LOCKS=1`` for this phase only), counts and
              the witness's record zeroed around each part: a cold
              ``SimSession`` on the full-size wiki-talk stand-in taking 16
              WCC runs (HitGraph and AccuGraph, mixed order) from 8
              threads, every report equal to the main path's field for
              field, one algorithm run an engine and one serve a run; a
              ``Sweeper(workers=8)`` timing grid on powerlaw-social (8
              cases, batched serves) equal to ``workers=1``, timed with
              the witness off and on; a ``SimService`` taking two jobs
              twice from 4 submitting threads, repeated submissions'
              rows equal; 8 threads saving powerlaw-social to one key of
              a fresh ``GraphStore`` (one file, no tmp litter, read back
              equal).  No hazard recorded.
14. distributed — the distributed engine and the sharded serve, counts
              zeroed around each part: (a) ``algorithms.distributed``'s
              ``run_wcc`` and ``run_sssp`` (from vertex 0, isolated in the
              stand-in, and from its vertex of highest degree) over a
              one-rank NCCL group (``FileStore`` rendezvous, no network)
              on the full-size wiki-talk stand-in, the labels equal to the
              main path's HitGraph WCC values and the distances to the
              single-process edge-centric engine's; (b) phase 10's
              full-size HitGraph program and its 4 timing variants through
              ``sharded_fused_scan_batch_shared`` over meshes repeating
              the card 4 and 3 times (the second pads 2 cases), and the
              full-size stacked pair through ``sharded_fused_scan_batch``
              over 2, each bit-equal to the unsharded ``fused_scan_batch``
              with one ``dram_serve_batch`` launch a shard, timed beside
              it; (c) ``Sweeper(devices=1)`` over HitGraph's timing grid
              equal to phase 10's rows with no sharded serve, and
              ``Sweeper(devices=cards + 1)`` raising at its first batched
              group, naming the card count.
15. lm       — the LM serve path (``repro_torch.models``), the port's
              kernel launch counts zeroed before and all zero after (it
              reaches no hand-written kernel): ``lm_device``, the matmul
              precision flags (TF32 off for the float32 pins);
              ``lm_pinned``, qwen3-0.6b at full width (d = 1,024, vocab
              151,936; depth cut to 4 layers, since the pins come from
              ``repro`` on a CPU) in float32 from NumPy weights
              (``lm_numpy_params``) through ``generate`` on 2 requests
              (17 and 32 tokens, 8 new), its prefill's top-8 logits held
              to ``repro``'s pins at 1e-3 and its tokens up to the first
              step whose pinned margin is under 1e-2; ``lm_families``,
              the ten smoke configurations in float32 (forward, prefill +
              3 decode steps, generate, a 256-token qwen3-smoke and a
              512-token xlstm-smoke prompt) held to their pins at 1e-4,
              tokens exactly; ``lm_serve``, qwen3-0.6b as published
              (28 layers, bf16) from a seeded ``torch.Generator`` on the
              card: 8 requests of 64..512 tokens, 64 new each, through
              ``generate``, the prefill and each decode step timed,
              decode held to ``forward`` at the same positions (2e-2),
              one 4,096-token prefill through the chunked attention with
              layer 0 held to ``_sdpa`` (2e-2), peak memory; every tensor
              on the card.  The pins are ``tools/lm_pins.json``, made by
              ``tools/lm_pins.py``.
16. lm_train — LM training (``repro_torch.train``, ``distributed.
              checkpoint``, ``fault_tolerance``, ``launch.train``), the
              port's kernel launch counts zeroed before and all zero after:
              ``lm_train_device``, the matmul precision flags (TF32 off);
              ``train_pinned``, qwen3-0.6b at full width cut to 4 layers
              in float32 from NumPy weights, 3 AdamW steps and 3 with
              ``grad_accum=2`` on 2 x 64 tokens: each loss held to
              ``repro``'s pins (step 1 at rtol 1e-5, later 1e-4), step 1's
              global and per-leaf grad norms (1e-4), the lr, and after
              step 3 a sample of every leaf (99.9 % within 1e-5, all
              within 3 * lr * steps); ``train_families``, one step of each
              smoke configuration (and one with ``grad_accum=2`` for
              gemma and the two MoE ones) held the same way, every
              gradient finite; ``train_full``, qwen3-0.6b as published
              (28 layers, bf16 compute, float32 state) through
              ``launch.train.main``: 20 steps of 8 x 512 tokens (the loss
              falls by at least 1 nat), 4 with ``--grad-accum 2``, one
              step with ``remat`` off, step ms, tokens/s, the profiler's
              busy ms and kernel count of a step, peak memory;
              ``train_resume``, 2 layers at full width: ``ElasticTrainer``
              saves at step 2 of 4 and a fresh trainer resumes, equal to
              the uninterrupted run within 1e-6; ``train_total``.  The
              pins are ``tools/lm_train_pins.json``, made by
              ``tools/lm_train_pins.py``.
17. lm_mesh  — the LM cost tooling and the LM on a mesh: ``lm_cost``,
              ``pattern_fractions()`` on the card (the four access
              patterns' line traces through ``simulate_trace_device``,
              4 ``dram_timing`` launches, counts zeroed just before),
              equal to the host route and ``repro``'s pins exactly, every
              family's effective fraction and the roofline row of each
              architecture at each supported shape on "16x16" (256 chips,
              5e9 collective bytes a chip) equal to the pins; the four
              traces at 2^18 lines against ``simulate_trace`` (every
              ``TraceResult`` field), the host's ms, the device call's and
              the ``dram_timing`` launch alone (CUDA events);
              ``lm_sharded``, on a one-rank NCCL group's ``(1, 1)``
              ``make_host_mesh``: qwen3-0.6b as published (28 layers,
              bf16) with ``DTensor`` parameters placed by
              ``tree_shardings`` under ``make_ctx``, its loss and
              gradients on 2 x 256 tokens against the unsharded port
              (each step's ms); the same cut to 4 layers in float32 on
              phase 16's pinned batch against its pinned loss and grad
              norm; a prefill and 8 greedy decode steps under
              ``serve_param_spec`` / ``cache_shardings``, tokens equal to
              the unsharded run's; llama4-scout's smoke MoE in float32
              through the ``a2a`` and ``psum`` paths against
              ``_moe_reference``.  One card: no number here comes from
              more than one.  The pins are ``tools/lm_cost_pins.json``,
              made by ``tools/lm_cost_pins.py``.
18. lm_dryrun, lm_train_mesh — the dry run and training on a mesh, the
              port's kernel launch counts zeroed before and all zero
              after: ``lm_dryrun``, ``python -m repro_torch.launch.dryrun
              --arch qwen3-0.6b`` over both production meshes, one process
              a cell (``long_500k``'s two in one), all started at once at
              the phase's start and read at its end: every cell on fake
              tensors on the card and a ``cuda`` mesh over a fake world of
              256 (512) ranks, every admitted cell ``ok``, its argument
              and output bytes equal to the CPU pins exactly, its
              collectives by kind beside the pins', its seconds; beside
              them hymba-1.5b's and xlstm-1.3b's ``prefill_32k`` on
              16x16 (their recurrences counted by a few iterations) and
              xlstm-1.3b's ``train_4k`` on 2x16x16 cut to 8 of its 48
              layers (one group of 7 mLSTM blocks and an sLSTM block,
              the widths as published), started with phase 15 so that
              they run beside phases 15-17, each ``ok`` with argument and
              output bytes equal to the CPU pins; every cell's temp bytes
              equal the pins' where its collectives do;
              ``lm_train_mesh``, meanwhile, qwen3-0.6b as published (28
              layers, bf16 compute) through ``launch.train.main``, 4 steps
              of 2 x 256 tokens saving every 2, on a one-rank NCCL group
              (the mesh path, ``(1, 1)``) and with no group (unsharded):
              every loss within 1e-6 relative of the other's; then each
              resumed from its step-2 checkpoint, steps 3-4 equal to the
              uninterrupted run's exactly; each step's ms both ways.  The
              pins are ``tools/lm_dryrun_pins.json``, made by
              ``tools/lm_dryrun_pins.py``.  Then the script's wall time.

Then the kernel table, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result.  It needs the repository around it and a
CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)

#: what the JAX package gives for the main path (wiki-talk stand-in,
#: WCC): iterations and packed serve steps, per accelerator
MAIN_EXPECT = {"hitgraph": (8, 743_776), "accugraph": (5, 859_351)}

#: the full-size reports' simulated runtimes (ns) as the serve kernel of
#: the port's first design (one CTA a program, held bit for bit to its
#: plain version on windows of these programs) gave them on the H100
#: (chip_smoke.py, final run of the commit before the serve's redesign):
#: the redesigned serve must give them again.  Keys: (path, accelerator)
#: and, for the stationary path, the problem.
PINNED_RUNTIME_NS = {
    ("main", "hitgraph"): 22798622.5, ("main", "accugraph"): 18188865.0,
    ("dynamic", "hitgraph"): 117134917.5,
    ("dynamic", "accugraph"): 75154640.83333334,
    ("stationary", "hitgraph"): 11096311.25,
    ("stationary", "accugraph"): 10913661.666666668,
}

#: the dynamic path: accelerator -> update stream (3 epochs each)
DYNAMIC_CASES = {"hitgraph": "uniform-churn", "accugraph": "pa-growth"}

#: per-epoch (iterations, total_requests) of the dynamic path, pinned from
#: this script's first H100 run (the port's own numbers: no JAX run of the
#: full-size dynamic case exists to hold them against).  Epoch 0 is the
#: main path (MAIN_EXPECT); every epoch's labelling is also checked
#: against a static recompute (``verify=True``).
DYNAMIC_PINNED = {
    "hitgraph": [(8, 12_306_821), (9, 15_517_544), (10, 16_791_707),
                 (11, 18_799_090)],
    "accugraph": [(5, 4_958_483), (4, 4_565_454), (5, 5_582_023),
                  (4, 4_695_464)],
}
KERNELS = ("dram_serve", "serve_prepass", "dram_serve_batch",
           "serve_prepass_batch", "dram_timing", "dram_timing_serial",
           "sweep_min_rounds", "sweep_min", "segment_reduce", "edge_scatter",
           "spmv_ell", "cache_lookup")

#: the cached main path, pinned from this script's H100 runs:
#: (cache_lookups, cache_hits, prefetch_hits, runtime_ns) per case.
#: ``cache="default"`` is HitGraph's 8-deep stream prefetcher and
#: AccuGraph's 2 MiB 16-way vertex BRAM; at full size AccuGraph's reads
#: span ~927K lines an iteration, far past the BRAM's 32,768, so the LRU
#: thrashes and every lookup misses (the JAX package gives 0 hits above
#: the BRAM too; ``tests/test_torch_cache.py``).  A cache of
#: ``BIG_BRAM_LINES`` (64 MiB, 16-way) holds that footprint, so 4 of the 5
#: iterations hit and the lookup's hit and LRU update branch runs at the
#: path's full shapes.
BIG_BRAM_LINES = 1 << 20
PINNED_CACHE = {
    ("hitgraph", "default"): (0, 0, 3_230_323, 22798622.5),
    ("accugraph", "default"): (4_634_885, 0, 0, 18188865.0),
    ("accugraph", "vertex-64m"): (4_634_885, 3_707_908, 0,
                                  13047101.666666668),
}

#: the cached dynamic run: AccuGraph WCC under ``pa-growth``, 2 epochs,
#: ``cache="default"``; per epoch (iterations, total_requests, cache_hits,
#: cache_lines_invalidated), pinned from the first H100 run
CACHED_DYNAMIC_EPOCHS = 2
PINNED_CACHED_DYNAMIC = ([(5, 4_958_483, 0, 0), (4, 4_565_454, 0, 32_768),
                          (5, 5_582_023, 0, 32_768)], 57117990.833333336)

#: the carry scan's group lengths timed on the full rewrite phases (1: one
#: serial walk over the chunks)
GROUPS = (1, 8, 32, 64)

#: vertices of the sweep's worst case, an ascending path
PATH_N = 1 << 20
#: the worst case may cost at most this many times the serial route
PATH_SLOWDOWN = 2.2

#: SHA-256 of the finishes and final carry of the full main-path programs
#: served from a cold carry, as the serve's first design gave them on the
#: H100 (the plain version would take about 20 minutes a program)
PINNED_SERVE_DIGEST = {
    "hitgraph":
        "65e3b2a45ea9c00b2550e5e4d4e36bd3fcfe83465f98ca5e7451f687033f6fa3",
    "accugraph":
        "c910845c7354b013e83a6061b26b9b5418b69a49a46aad5c9a3ede6a2189bef2",
}

#: the event phase's trace line: (label, preset, requests, bulk), 2^20
#: requests in all; the bulk trace issues every request at cycle 0 over
#: many rows, so that the four-ACT window (tFAW) binds
TRACE_CASES = (("ddr3-1600k-4ch-2rank", "hitgraph", 1 << 18, False),
               ("ddr4-2400r", "accugraph", 1 << 18, False),
               ("hbm2-8ch", "hbm2", 1 << 18, False),
               ("ddr4-2400r-faw", "accugraph", 1 << 18, True))

#: the reference machine's graph, ``instantiate("wt", REFERENCE_SCALE)``:
#: the largest step of the ladder 0.01, 0.02, 0.05, 0.1, 0.2 whose WCC
#: and BFS runs stay within REFERENCE_BUDGET_S on the card's host in this
#: script (``tools/event_scales.py`` times the ladders alone; the host's
#: speed varies by about 1.4x between machines, and 0.2 took 41-77 s; the
#: element replay's cost grows with edges x iterations, so full size is
#: out of reach).  BFS starts at the vertex of highest degree.
REFERENCE_SCALE = 0.1
REFERENCE_BUDGET_S = 60.0
#: ``run_study``'s graph, ``instantiate("wt", STUDY_SCALE)``, at the Fig. 13
#: partition size (q = 1,024,000 at full size, scaled): the largest step of
#: the ladder 0.1, 0.2, 0.5, 1.0 whose five variants stay within
#: STUDY_BUDGET_S in this script (full size took 43-64 s)
STUDY_SCALE = 0.5
STUDY_BUDGET_S = 60.0
#: the event replay may take this long a run before the event_main line
#: would need a cut graph
EVENT_MAIN_LIMIT_S = 150.0

#: phase 10, the sweep: the timing variants of each accelerator's default
#: memory beside it (4 cases sharing one pack), the SweepStats of the
#: batched run over both accelerators (2 algorithm runs and 2 packs, the
#: other 6 cases hits; one batched serve an accelerator), the window of
#: the HitGraph program the batched kernel is held to its plain version
#: on, and the scale of the dynamic case's graph
SWEEP_KINDS = ("ddr3", "hbm2", "ddr4-3200")
SWEEP_STATS = {"cases": 8, "algo_runs": 2, "algo_cache_hits": 6,
               "pack_cache_misses": 2, "pack_cache_hits": 6,
               "batched_cases": 8, "batch_dispatches": 2}
SWEEP_WINDOW = 1024
SWEEP_DYNAMIC_SCALE = 0.1

#: phase 11, the corpus: the grid, the ordering arms and the BRAM cases of
#: benchmarks/corpus_sweep.py at each preset's own size (graph_scale=1.0,
#: no cut), then two scenarios in the ScenarioSpec form
CORPUS = ("karate", "rmat-16", "kron-social", "powerlaw-social",
          "road-grid", "lj-sample")
CORPUS_PROBLEMS = ("wcc", "pr")
CORPUS_ACCELERATORS = ("hitgraph", "accugraph")
CORPUS_MEMORIES = (None, "hbm2")
CORPUS_ORDERINGS = ("powerlaw-social:degree", "powerlaw-social:bfs",
                    "powerlaw-social:shuffle", "road-grid:bfs",
                    "road-grid:shuffle")
CORPUS_SPEC = {"graph": "powerlaw-social", "problem": "wcc",
               "ordering": "degree", "accelerator": "accugraph",
               "memory": "hbm2", "cache": "default"}
CORPUS_DYNAMIC = {"graph": "powerlaw-social", "problem": "wcc",
                  "updates": "pa-growth", "accelerator": "accugraph"}
CORPUS_STAT_KEYS = ("cases", "algo_runs", "algo_cache_hits",
                    "pack_cache_hits", "pack_cache_misses", "batched_cases",
                    "batch_dispatches")
#: the kernels phase 11 must launch (``sweep_min``, the round sweep's
#: serial route past its round budget, may; ``dram_timing_serial`` is
#: on no path)
CORPUS_KERNELS = ("dram_serve", "serve_prepass", "dram_serve_batch",
                  "serve_prepass_batch", "dram_timing", "sweep_min_rounds",
                  "segment_reduce", "edge_scatter", "spmv_ell",
                  "cache_lookup")

# ---- corpus pins: written by tools/corpus_pins.py ----
#: the JAX package's numbers for phase 11, made on the CPU by the same calls
CORPUS_GRAPHS = {
    'karate': ('karate', 34, 156, '0469df9766907f391dec291af8a2306b'),
    'rmat-16': ('rmat-16', 65536, 1048576, 'a305eb5a5c3a2e8720f8a14bb32db287'),
    'kron-social':
        ('kron-social', 65536, 786432, '2418ebcfdc1fe1aed5f5101dbc7b9cbe'),
    'powerlaw-social':
        ('powerlaw-social', 65536, 1048576, '7296b431a2d5cac0f626545f5caa0c8a'),
    'road-grid':
        ('road-grid', 65536, 261120, 'b48e698f188af1a7d6b087a65218a82b'),
    'lj-sample':
        ('lj-sample', 24237, 344968, 'bf569d436e52388cd6c08d3c292a4b5b'),
    'powerlaw-social:degree':
        ('powerlaw-social+degsort', 65536, 1048576, 'be214a8193036b6136bd2a9531434e96'),
    'powerlaw-social:bfs':
        ('powerlaw-social+bfsorder', 65536, 1048576, '76ca63441327faa59e3b393ae2ec2565'),
    'powerlaw-social:shuffle':
        ('powerlaw-social+shuffle', 65536, 1048576, '4cd39aec5b8543f2f48c037b834f3c0f'),
    'road-grid:bfs':
        ('road-grid+bfsorder', 65536, 261120, 'fb071193d9228710283d42e53be95735'),
    'road-grid:shuffle':
        ('road-grid+shuffle', 65536, 261120, '911452fe73280d0f3a78c9f83c249f9d'),
}
CORPUS_PINS = {
    ('karate', 'wcc', 'hitgraph', 'default', 'none'):
        (823.75, 140, 4, 139, 0, 0, 'eb763621d8425a6c'),
    ('karate', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (558.0, 140, 4, 132, 0, 0, 'f5db3981257e201f'),
    ('karate', 'wcc', 'accugraph', 'default', 'none'):
        (274.1666666666667, 53, 3, 52, 0, 0, '91f1a74f0495efe5'),
    ('karate', 'wcc', 'accugraph', 'hbm2', 'none'):
        (245.0, 53, 3, 45, 0, 0, '29b5ab11ec09b1c2'),
    ('karate', 'pr', 'hitgraph', 'default', 'none'):
        (236.25, 39, 1, 38, 0, 0, 'd8296a92d996e50c'),
    ('karate', 'pr', 'hitgraph', 'hbm2', 'none'):
        (147.0, 39, 1, 31, 0, 0, 'df8a2fb88f9c4c9d'),
    ('karate', 'pr', 'accugraph', 'default', 'none'):
        (103.33333333333334, 19, 1, 18, 0, 0, 'fd690427372eb336'),
    ('karate', 'pr', 'accugraph', 'hbm2', 'none'):
        (91.0, 19, 1, 11, 0, 0, '6f7a2eaf5a6c6292'),
    ('rmat-16', 'wcc', 'hitgraph', 'default', 'none'):
        (5168218.75, 1033531, 7, 1019542, 0, 0, '0c7d7825aa951583'),
    ('rmat-16', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (4695053.0, 1033531, 7, 992755, 0, 0, '742561a80a4e4fcd'),
    ('rmat-16', 'wcc', 'accugraph', 'default', 'none'):
        (1366136.6666666667, 303261, 4, 297592, 0, 0, '81259d95963e3859'),
    ('rmat-16', 'wcc', 'accugraph', 'hbm2', 'none'):
        (1315138.0, 303261, 4, 290263, 0, 0, 'f5d7ea1516744a4c'),
    ('rmat-16', 'pr', 'hitgraph', 'default', 'none'):
        (767398.75, 153466, 1, 151031, 0, 0, 'f39cd7767ee43bfb'),
    ('rmat-16', 'pr', 'hitgraph', 'hbm2', 'none'):
        (680647.0, 153466, 1, 146764, 0, 0, '4aea6f547cfe44d1'),
    ('rmat-16', 'pr', 'accugraph', 'default', 'none'):
        (341724.1666666667, 77825, 1, 76120, 0, 0, '41c5bf4fd50f4e1b'),
    ('rmat-16', 'pr', 'accugraph', 'hbm2', 'none'):
        (328771.0, 77825, 1, 74232, 0, 0, '2b7f8a5ceb6c48b9'),
    ('kron-social', 'wcc', 'hitgraph', 'default', 'none'):
        (4689331.25, 937737, 8, 923398, 0, 0, '490a97f37fcd9327'),
    ('kron-social', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (4102804.0, 937737, 8, 901473, 0, 0, 'fb660e08bdd25ff4'),
    ('kron-social', 'wcc', 'accugraph', 'default', 'none'):
        (1038866.6666666667, 237772, 4, 232585, 0, 0, '5c80e1b0ebaa58c5'),
    ('kron-social', 'wcc', 'accugraph', 'hbm2', 'none'):
        (987458.0, 237772, 4, 226843, 0, 0, '738ecbfb2be99e35'),
    ('kron-social', 'pr', 'hitgraph', 'default', 'none'):
        (623808.75, 124748, 1, 122289, 0, 0, 'a8b8276265d40a75'),
    ('kron-social', 'pr', 'hitgraph', 'hbm2', 'none'):
        (526932.0, 124748, 1, 119444, 0, 0, '9757a18963d07864'),
    ('kron-social', 'pr', 'accugraph', 'default', 'none'):
        (259930.83333333334, 61441, 1, 59856, 0, 0, '9cae4b72ec7ba44b'),
    ('kron-social', 'pr', 'accugraph', 'hbm2', 'none'):
        (246851.0, 61441, 1, 58399, 0, 0, '1636adac042e0f11'),
    ('powerlaw-social', 'wcc', 'hitgraph', 'default', 'none'):
        (5262778.75, 1052443, 7, 1038376, 0, 0, '686b5b6e3b7f5919'),
    ('powerlaw-social', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (4748886.0, 1052443, 7, 1013283, 0, 0, 'cc1675aa0daf9a10'),
    ('powerlaw-social', 'wcc', 'accugraph', 'default', 'none'):
        (1707483.3333333335, 376214, 5, 369585, 0, 0, '039fd88973b499fb'),
    ('powerlaw-social', 'wcc', 'accugraph', 'hbm2', 'none'):
        (1643927.0, 376214, 5, 360593, 0, 0, 'f2355cbe94deb075'),
    ('powerlaw-social', 'pr', 'hitgraph', 'default', 'none'):
        (797708.75, 159528, 1, 156791, 0, 0, 'ad75af4132130d03'),
    ('powerlaw-social', 'pr', 'hitgraph', 'hbm2', 'none'):
        (695977.0, 159528, 1, 152920, 0, 0, 'f028ae71b48e2182'),
    ('powerlaw-social', 'pr', 'accugraph', 'default', 'none'):
        (341724.1666666667, 77825, 1, 76120, 0, 0, '6e0d0353bd2620dc'),
    ('powerlaw-social', 'pr', 'accugraph', 'hbm2', 'none'):
        (328771.0, 77825, 1, 74232, 0, 0, '4354416c12c67185'),
    ('road-grid', 'wcc', 'hitgraph', 'default', 'none'):
        (130799573.75, 26151486, 511, 25525151, 0, 0, 'ee3eb93c2856c947'),
    ('road-grid', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (93989416.0, 26151486, 511, 24925927, 0, 0, '209dd6c9e70de949'),
    ('road-grid', 'wcc', 'accugraph', 'default', 'none'):
        (198643.33333333334, 53122, 2, 51081, 0, 0, 'e590d5237f5ee32d'),
    ('road-grid', 'wcc', 'accugraph', 'hbm2', 'none'):
        (165401.0, 53122, 2, 49849, 0, 0, '7e50a99067effc1c'),
    ('road-grid', 'pr', 'hitgraph', 'default', 'none'):
        (306628.75, 61312, 1, 59310, 0, 0, '7268cf7c0052a032'),
    ('road-grid', 'pr', 'hitgraph', 'hbm2', 'none'):
        (204439.0, 61312, 1, 57908, 0, 0, '97d36bc7ac0e3efe'),
    ('road-grid', 'pr', 'accugraph', 'default', 'none'):
        (103339.16666666667, 28609, 1, 27267, 0, 0, '3f05559d4ef79855'),
    ('road-grid', 'pr', 'accugraph', 'hbm2', 'none'):
        (82724.0, 28609, 1, 26612, 0, 0, '68e8c661b36f587a'),
    ('lj-sample', 'wcc', 'hitgraph', 'default', 'none'):
        (2014366.25, 402755, 8, 396729, 0, 0, '96b8b8bbfcd41106'),
    ('lj-sample', 'wcc', 'hitgraph', 'hbm2', 'none'):
        (1794009.0, 402755, 8, 386279, 0, 0, '41c8922c7a1e456a'),
    ('lj-sample', 'wcc', 'accugraph', 'default', 'none'):
        (564539.1666666667, 126786, 5, 123997, 0, 0, '9c6e2959b5b11b0a'),
    ('lj-sample', 'wcc', 'accugraph', 'hbm2', 'none'):
        (541176.0, 126786, 5, 122239, 0, 0, '87b84fb4d3f3f340'),
    ('lj-sample', 'pr', 'hitgraph', 'default', 'none'):
        (268188.75, 53624, 1, 52535, 0, 0, '2e90f02ff91009a4'),
    ('lj-sample', 'pr', 'hitgraph', 'hbm2', 'none'):
        (230522.0, 53624, 1, 50997, 0, 0, '762d210dfec4f9c2'),
    ('lj-sample', 'pr', 'accugraph', 'default', 'none'):
        (112899.16666666667, 26106, 1, 25441, 0, 0, 'fca9fe499d84b675'),
    ('lj-sample', 'pr', 'accugraph', 'hbm2', 'none'):
        (108224.0, 26106, 1, 25072, 0, 0, '2083412d27d247c9'),
    ('powerlaw-social:degree', 'wcc', 'hitgraph', 'default', 'none'):
        (4459081.25, 891720, 6, 880434, 0, 0, '7cbfa0eaa9f01045'),
    ('powerlaw-social:degree', 'wcc', 'accugraph', 'default', 'none'):
        (1024549.1666666667, 225336, 3, 221420, 0, 0, '5f44425808ab7bde'),
    ('powerlaw-social:bfs', 'wcc', 'hitgraph', 'default', 'none'):
        (5249663.75, 1049820, 7, 1036204, 0, 0, '637689e06789f09f'),
    ('powerlaw-social:bfs', 'wcc', 'accugraph', 'default', 'none'):
        (683061.6666666667, 151504, 2, 148721, 0, 0, '6f03029314de5256'),
    ('powerlaw-social:shuffle', 'wcc', 'hitgraph', 'default', 'none'):
        (6019466.25, 1203764, 8, 1187261, 0, 0, 'fdaf3ac5c960d39c'),
    ('powerlaw-social:shuffle', 'wcc', 'accugraph', 'default', 'none'):
        (1707482.5, 376327, 5, 369670, 0, 0, 'ca24edd9ee389560'),
    ('road-grid:bfs', 'wcc', 'hitgraph', 'default', 'none'):
        (130647173.75, 26121006, 511, 25521358, 0, 0, '94ef49815891d096'),
    ('road-grid:bfs', 'wcc', 'accugraph', 'default', 'none'):
        (198643.33333333334, 53122, 2, 51081, 0, 0, 'baa64774a434ef05'),
    ('road-grid:shuffle', 'wcc', 'hitgraph', 'default', 'none'):
        (86771832.5, 17344703, 410, 17161242, 0, 0, '21a985ac421cb09b'),
    ('road-grid:shuffle', 'wcc', 'accugraph', 'default', 'none'):
        (10306110.833333334, 2780527, 106, 2674296, 0, 0, '33f3579b57b66e35'),
    ('karate', 'wcc', 'accugraph', 'default', 'default'):
        (144.16666666666669, 21, 3, 20, 48, 32, 'b137f51bcaec23b5'),
    ('rmat-16', 'wcc', 'accugraph', 'default', 'default'):
        (1366136.6666666667, 303261, 4, 297592, 294916, 0, 'fe136877873644d6'),
    ('kron-social', 'wcc', 'accugraph', 'default', 'default'):
        (1038866.6666666667, 237772, 4, 232585, 229380, 0, '2fe75c1b41c1aa26'),
    ('powerlaw-social', 'wcc', 'accugraph', 'default', 'default'):
        (1707483.3333333335, 376214, 5, 369585, 368645, 0, '79bb519033a7c27d'),
    ('road-grid', 'wcc', 'accugraph', 'default', 'default'):
        (103339.16666666667, 28609, 2, 27267, 49026, 24513, '4ee2acd3eff63fef'),
    ('lj-sample', 'wcc', 'accugraph', 'default', 'default'):
        (424177.5, 28422, 5, 27753, 122955, 98364, '46f0bf696e235074'),
}
CORPUS_STATS = {
    'grid': {
        'cases': 48,
        'algo_runs': 24,
        'algo_cache_hits': 24,
        'pack_cache_hits': 0,
        'pack_cache_misses': 48,
        'batched_cases': 0,
        'batch_dispatches': 0,
    },
    'ordering': {
        'cases': 10,
        'algo_runs': 10,
        'algo_cache_hits': 0,
        'pack_cache_hits': 0,
        'pack_cache_misses': 10,
        'batched_cases': 10,
        'batch_dispatches': 10,
    },
    'bram': {
        'cases': 60,
        'algo_runs': 24,
        'algo_cache_hits': 36,
        'pack_cache_hits': 6,
        'pack_cache_misses': 54,
        'batched_cases': 0,
        'batch_dispatches': 0,
    },
}
CORPUS_CONTRACTS = {
    'powerlaw-social:degree runtime <= shuffle, hitgraph': True,
    'powerlaw-social:degree requests <= shuffle, hitgraph': True,
    'powerlaw-social:bfs runtime <= shuffle, hitgraph': True,
    'powerlaw-social:bfs requests <= shuffle, hitgraph': True,
    'road-grid bfs runtime != shuffle, hitgraph': True,
    'powerlaw-social:degree runtime <= shuffle, accugraph': True,
    'powerlaw-social:degree requests <= shuffle, accugraph': True,
    'powerlaw-social:bfs runtime <= shuffle, accugraph': True,
    'powerlaw-social:bfs requests <= shuffle, accugraph': True,
    'road-grid bfs runtime != shuffle, accugraph': True,
    'karate bram lookups > 0': True,
    'karate bram hit rate > 0': True,
    'karate bram runtime <= uncached': True,
    'rmat-16 bram lookups > 0': True,
    'rmat-16 bram hit rate > 0': False,
    'rmat-16 bram runtime <= uncached': True,
    'kron-social bram lookups > 0': True,
    'kron-social bram hit rate > 0': False,
    'kron-social bram runtime <= uncached': True,
    'powerlaw-social bram lookups > 0': True,
    'powerlaw-social bram hit rate > 0': False,
    'powerlaw-social bram runtime <= uncached': True,
    'road-grid bram lookups > 0': True,
    'road-grid bram hit rate > 0': True,
    'road-grid bram runtime <= uncached': True,
    'lj-sample bram lookups > 0': True,
    'lj-sample bram hit rate > 0': True,
    'lj-sample bram runtime <= uncached': True,
}
CORPUS_SPEC_PIN = (986349.0, 225336, 3, 216067, 221187, 0, 'b75705ae2e266045')
CORPUS_SPEC_WARNINGS = [
    'simulate(graph, problem, accelerator=..., cache=..., memory=...) with per-axis keywords is deprecated; migrate to simulate(ScenarioSpec(graph, problem, accelerator=..., cache=..., memory=...))',
]
CORPUS_DYNAMIC_PIN = (4906457.5, 1126494, 12, 1110391, 0, 0, 'aaea0cd56eaacaab')
CORPUS_EPOCH_PINS = [
    (0, 5, 0, 0, 0, 1707483.3333333335, 376214, '57d8a5824c33a87c'),
    (1, 3, 20972, 0, 0, 1280337.5, 296087, 'b9d65d3ae4bcac16'),
    (2, 2, 21391, 0, 0, 950225.0, 225053, 'd763bbc680a77c1d'),
    (3, 2, 21819, 0, 0, 968411.6666666667, 229140, '5c70bf5c98913445'),
]
# ---- end of corpus pins ----

#: phase 12, the service and the tuner.  The service part mirrors
#: benchmarks/service_load.py: CLIENTS threads of JOBS_PER_CLIENT one-case
#: jobs (HitGraph PR/BFS/WCC, ``fixed_iters`` 2-4, roots 0-3, on the lj and
#: yt stand-ins, undirected, with the comparability configs), WORKERS
#: preparing threads, its retry policy, admission budget and deadlines,
#: clean and under DEFAULT_FAULT_MIX at chaos seed 0 (site: rate,
#: max_attempts, crash).  SERVICE_SCALE cuts the stand-ins from 1.0 to
#: 0.1 (lj: 484,757 vertices, 13.8 M undirected edges), the largest size
#: at which the JAX package makes the pins on a CPU in minutes.  Then a
#: resident graph (phase 11's dynamic spec) taking SERVICE_UPDATES update
#: jobs, and benchmarks/autotune.py's search at each preset's own size
#: (its default graph_scale is 0.02).
SERVICE_SCALE = 0.1
SERVICE_ABBRS = ("lj", "yt")
SERVICE_CLIENTS = 4
SERVICE_JOBS_PER_CLIENT = 3
SERVICE_WORKERS = 2
SERVICE_FAULT_SEED = 0
SERVICE_FAULT_MIX = {"sweep.prepare": (0.4, 2, False),
                     "dram.serve": (0.25, 1, False),
                     "graphstore.read": (0.5, 1, False),
                     "worker.crash": (0.1, 1, True)}
SERVICE_RESIDENT = CORPUS_DYNAMIC
SERVICE_UPDATES = 2
TUNE_GRAPH = "powerlaw-social"
TUNE_PROBLEM = "pr"
TUNE_SEED = 7
TUNE_SPACE = {"n_pes": ["1", "4"], "pipelines": ["8"],
              "partition_elements": ["parts4", "parts16"],
              "memory": ["ddr3", "hbm2"], "cache": ["none", "prefetch-8"]}
TUNE_BUDGET = {"rungs": (2, 4), "initial": 8, "keep": 0.5,
               "max_case_evals": 16}
SERVICE_PARTS = ("clean", "faulted", "resident", "tuner")
#: the kernels each part must launch
SERVICE_KERNELS = {
    "clean": ("dram_serve", "serve_prepass", "edge_scatter",
              "segment_reduce"),
    "faulted": ("dram_serve", "serve_prepass", "edge_scatter",
                "segment_reduce"),
    "resident": ("dram_serve", "serve_prepass", "dram_timing",
                 "sweep_min_rounds"),
    "tuner": ("dram_serve_batch", "serve_prepass_batch", "dram_serve",
              "serve_prepass", "edge_scatter", "segment_reduce"),
}

# ---- service pins: written by tools/service_pins.py ----
#: the JAX package's numbers for phase 12, made on the CPU by the same calls
SERVICE_GRAPHS = {
    'lj':
        ('live-journal_undir', 484757, 13798754, '6f9cd0727cd63b55032dc40c46e3a65d'),
    'yt':
        ('youtube_undir', 115782, 597524, 'eb042eca96d3befac5e8bd734ab50c03'),
}
SERVICE_PLANS = {
    '6f9cd0727cd63b55032dc40c46e3a65d|pr|hitgraph|default|none|baseline|0|2|static':
        (('transient', 1), None, None, None),
    'eb042eca96d3befac5e8bd734ab50c03|bfs|hitgraph|default|none|baseline|1|3|static':
        (None, ('transient', 1), None, None),
    '6f9cd0727cd63b55032dc40c46e3a65d|wcc|hitgraph|default|none|baseline|2|4|static':
        (None, None, None, None),
    'eb042eca96d3befac5e8bd734ab50c03|pr|hitgraph|default|none|baseline|3|2|static':
        (('transient', 2), None, ('transient', 1), None),
    '6f9cd0727cd63b55032dc40c46e3a65d|bfs|hitgraph|default|none|baseline|0|3|static':
        (None, None, None, None),
    'eb042eca96d3befac5e8bd734ab50c03|wcc|hitgraph|default|none|baseline|1|4|static':
        (('transient', 1), None, ('transient', 1), None),
    '6f9cd0727cd63b55032dc40c46e3a65d|pr|hitgraph|default|none|baseline|2|2|static':
        (None, None, None, None),
    'eb042eca96d3befac5e8bd734ab50c03|bfs|hitgraph|default|none|baseline|3|3|static':
        (('transient', 2), ('transient', 1), ('transient', 1), None),
    '6f9cd0727cd63b55032dc40c46e3a65d|wcc|hitgraph|default|none|baseline|0|4|static':
        (None, ('transient', 1), None, None),
    'eb042eca96d3befac5e8bd734ab50c03|pr|hitgraph|default|none|baseline|1|2|static':
        (('transient', 2), None, None, None),
    '6f9cd0727cd63b55032dc40c46e3a65d|bfs|hitgraph|default|none|baseline|2|3|static':
        (('transient', 2), None, ('transient', 1), None),
    'eb042eca96d3befac5e8bd734ab50c03|wcc|hitgraph|default|none|baseline|3|4|static':
        (None, None, None, None),
}
SERVICE_PINS = {
    '6f9cd0727cd63b55032dc40c46e3a65d|bfs|hitgraph|default|none|baseline|0|3|static':
        (30093870.0, 9028021, 6, 8760805, 0, 0, 'b3bb1605eb22398a'),
    '6f9cd0727cd63b55032dc40c46e3a65d|bfs|hitgraph|default|none|baseline|2|3|static':
        (30120174.166666668, 9029489, 6, 8760324, 0, 0, 'c9f34705a4656e28'),
    '6f9cd0727cd63b55032dc40c46e3a65d|pr|hitgraph|default|none|baseline|0|2|static':
        (15453746.666666668, 4636080, 2, 4348888, 0, 0, '871cd3b7f7f1d193'),
    '6f9cd0727cd63b55032dc40c46e3a65d|pr|hitgraph|default|none|baseline|2|2|static':
        (15453746.666666668, 4636080, 2, 4348888, 0, 0, '871cd3b7f7f1d193'),
    '6f9cd0727cd63b55032dc40c46e3a65d|wcc|hitgraph|default|none|baseline|0|4|static':
        (38178016.66666667, 11453265, 6, 10982181, 0, 0, '1b37b4bea91f18b6'),
    '6f9cd0727cd63b55032dc40c46e3a65d|wcc|hitgraph|default|none|baseline|2|4|static':
        (38178016.66666667, 11453265, 6, 10982181, 0, 0, '1b37b4bea91f18b6'),
    'eb042eca96d3befac5e8bd734ab50c03|bfs|hitgraph|default|none|baseline|1|3|static':
        (242330.0, 72691, 1, 72123, 0, 0, 'ecf8e5cac7d3aff8'),
    'eb042eca96d3befac5e8bd734ab50c03|bfs|hitgraph|default|none|baseline|3|3|static':
        (2786466.666666667, 835728, 9, 824737, 0, 0, '037246efcc70e751'),
    'eb042eca96d3befac5e8bd734ab50c03|pr|hitgraph|default|none|baseline|1|2|static':
        (826860.0, 248014, 2, 240282, 0, 0, '79b31d3c591f93d2'),
    'eb042eca96d3befac5e8bd734ab50c03|pr|hitgraph|default|none|baseline|3|2|static':
        (826860.0, 248014, 2, 240282, 0, 0, '79b31d3c591f93d2'),
    'eb042eca96d3befac5e8bd734ab50c03|wcc|hitgraph|default|none|baseline|1|4|static':
        (3151223.3333333335, 945155, 9, 925006, 0, 0, '870a437d415a224a'),
    'eb042eca96d3befac5e8bd734ab50c03|wcc|hitgraph|default|none|baseline|3|4|static':
        (3151223.3333333335, 945155, 9, 925006, 0, 0, '870a437d415a224a'),
}
SERVICE_EPOCH_PINS = [
    (0, 5, 0, 0, 0, 1707483.3333333335, 376214, 'b230681ae5a796a3'),
    (1, 3, 20972, 0, 0, 1280337.5, 296087, 'b9d65d3ae4bcac16'),
    (2, 2, 21391, 0, 0, 950225.0, 225053, 'd763bbc680a77c1d'),
]
TUNE_SEARCH = {
    'front': [
        ('hitgraph|n_pes=4|pipelines=8|partition_elements=parts4|memory=ddr3|cache=none', (1009006.25, 770360.0, 0.0)),
    ],
    'rungs': [
        {'fixed_iters': 2, 'evaluated': 8, 'survivors': 4},
        {'fixed_iters': 4, 'evaluated': 4, 'survivors': 4},
    ],
    'stats': {
        'case_evals': 12,
        'dispatches': 2,
        'generations': 2,
        'sampled': 8,
        'evolved': 0,
        'rejected_invalid': 0,
        'budget_truncations': 0,
        'failed_candidates': 0,
    },
}
TUNE_EXHAUSTIVE = {
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts4|memory=ddr3|cache=none':
        (3852116.25, 770360.0, 0.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts4|memory=ddr3|cache=prefetch-8':
        (3852116.25, 770360.0, 512.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts4|memory=hbm2|cache=none':
        (3114060.0, 770360.0, 0.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts4|memory=hbm2|cache=prefetch-8':
        (3113900.0, 770360.0, 512.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts16|memory=ddr3|cache=none':
        (4781376.25, 956212.0, 0.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts16|memory=ddr3|cache=prefetch-8':
        (4781376.25, 956212.0, 512.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts16|memory=hbm2|cache=none':
        (3576468.0, 956212.0, 0.0),
    'hitgraph|n_pes=1|pipelines=8|partition_elements=parts16|memory=hbm2|cache=prefetch-8':
        (3576148.0, 956212.0, 512.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts4|memory=ddr3|cache=none':
        (1009006.25, 770360.0, 0.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts4|memory=ddr3|cache=prefetch-8':
        (1009006.25, 770360.0, 512.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts4|memory=hbm2|cache=none':
        (3258886.0, 770360.0, 0.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts4|memory=hbm2|cache=prefetch-8':
        (3258886.0, 770360.0, 512.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts16|memory=ddr3|cache=none':
        (1241531.25, 956212.0, 0.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts16|memory=ddr3|cache=prefetch-8':
        (1241531.25, 956212.0, 512.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts16|memory=hbm2|cache=none':
        (1680370.0, 956212.0, 0.0),
    'hitgraph|n_pes=4|pipelines=8|partition_elements=parts16|memory=hbm2|cache=prefetch-8':
        (1680370.0, 956212.0, 512.0),
}
TUNE_SWEEP_STATS = {
    'workers=2': {
        'cases': 12,
        'algo_runs': 2,
        'algo_cache_hits': 10,
        'pack_cache_hits': 0,
        'pack_cache_misses': 12,
        'batched_cases': 12,
        'batch_dispatches': 9,
    },
    'workers=1': {
        'cases': 12,
        'algo_runs': 2,
        'algo_cache_hits': 10,
        'pack_cache_hits': 0,
        'pack_cache_misses': 12,
        'batched_cases': 12,
        'batch_dispatches': 9,
    },
    'exhaustive': {
        'cases': 16,
        'algo_runs': 1,
        'algo_cache_hits': 15,
        'pack_cache_hits': 0,
        'pack_cache_misses': 16,
        'batched_cases': 16,
        'batch_dispatches': 8,
    },
}
# ---- end of service pins ----

#: the stationary path: problems, iterations, and the largest relative
#: error of the values against a float64 recompute.  HitGraph's gather
#: sums in float64; AccuGraph's pull sums a light row in float32 over at
#: most 31 slots on one thread and a heavy row over chunk sums of up to
#: 4,096 slots (377 on the hub), whose rounding drifts by at most ~3e-5,
#: compounded over 3 iterations.
STATIONARY = ("pr", "spmv")
STATIONARY_ITERS = 3
STATIONARY_RTOL = 1e-3

#: phase 13, the lock witness: the threaded full-size session's runs and
#: threads, the seed of their mixed order; the sweeper grid's preset (at
#: its own size), its problem and timing variants (the default memory and
#: these kinds: 4 cases an accelerator sharing one pack) and threads; the
#: service's submitting threads; the store's saving threads and the saves
#: each makes
LOCK_RUNS = 16
LOCK_THREADS = 8
LOCK_SEED = 13
LOCK_GRAPH = "powerlaw-social"
LOCK_KINDS = ("ddr3", "hbm2", "ddr4-3200")
LOCK_SUBMITTERS = 4
LOCK_SAVES = 3


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device)


def cold_state(packed, C, device):
    from repro_torch.core import vectorized as vec
    return tuple(vec.init_lean_carry(C, packed.n_banks,
                                     packed.banks_per_rank, device)) + (
        torch.zeros(C, dtype=torch.int32, device=device),)


def max_abs_diff(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs, after one
    warm-up run.  A sleep kernel keeps the stream busy while the runs are
    enqueued, so host overhead between short launches does not show as
    idle time between the events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(prep, fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` alone over ``reps`` runs, each after
    ``prep`` (outside the events), after one warm-up run; enqueued behind
    a sleep kernel, as in :func:`cuda_ms`, so the host's share of the call
    does not show."""
    prep()
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in pairs:
        prep()
        start.record()
        fn()
        end.record()
    pairs[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` runs after one warm-up
    run, each run between its own pair of events; for a call that reads a
    value back to the host midway (no sleep kernel in front of it)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def timed_call(fn):
    """``fn()`` once between two CUDA events: ``(its result, ms)``.  For
    calls of hundreds of milliseconds whose output is also checked, so
    one run both times and gives the output (no warm-up: the kernels are
    built and launched in earlier phases)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def serve_bytes(S, C, K, B, R, M=1, shared=True) -> int:
    """Bytes the serve of ``M`` cases must move: the program (issue and
    meta, 8 B a lane-step, and the boundary flags) once when every case
    shares it, else once a case; and for each case its timing vector, its
    finishes (4 B a lane-step) and its carry in and out."""
    carry = 2 * C * B + 2 * C + 5 * C * R
    programs = 1 if shared else M
    return (programs * (S * C * K * 8 + S * 4)
            + M * (7 * 4 + S * C * K * 4 + 2 * carry * 4))


def prepass_bytes(S, C, K, T, M=1, shared=True) -> int:
    """Bytes the serve's pre-pass for ``M`` cases must move: the program
    (issue and meta in, 8 B a lane-step, and the boundary flags) once when
    every case shares it, else once a case; and for each case its timing
    vector and its records out (8 B a lane-step over the steps rounded up
    to whole chunks of ``T``)."""
    programs = 1 if shared else M
    return (programs * (S * C * K * 8 + S * 4)
            + M * (7 * 4 + -(-S // T) * T * C * K * 8))


def serve_digest(fin, state) -> str:
    """SHA-256 of a serve's finishes and its 6-tuple carry, as bytes."""
    h = hashlib.sha256(fin.cpu().numpy().tobytes())
    for x in state:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()


def timing_bytes(C, L, B, R) -> int:
    """Bytes the per-channel scan must move: issue, bank, row (4 B each)
    and valid (1 B) in, finish (4 B) and kind (1 B) out per slot, timing,
    and the carry in and out."""
    carry = 3 * C * B + C + 6 * C * R
    return C * L * (13 + 5) + 7 * 4 + 2 * carry * 4


def channel_streams(cfg, rng, n=3000, bulk=False):
    """Per-channel streams of a random trace; ``bulk`` issues every
    request at cycle 0 over many rows, so back-to-back ACTs hit tFAW."""
    from repro_torch.core import vectorized as vec
    from repro_torch.core.trace import Trace
    lines = rng.integers(0, 1 << 24 if bulk else 1 << 16, n)
    issue = (np.zeros(n, dtype=np.int64) if bulk
             else np.sort(rng.integers(0, 4 * n, n)))
    return vec.pack_channels(Trace(lines, np.zeros(n, bool), issue), cfg)


def timing_diff(got, want) -> int:
    """Max absolute difference over two ``(finish, kind, carry)``."""
    return max([max_abs_diff(got[0], want[0]), max_abs_diff(got[1], want[1])]
               + [max_abs_diff(a, b) for a, b in zip(got[2], want[2])])


def timing_both(streams, timing, carry, split):
    """Kernel (two chained calls split at slot ``split``) and plain
    version (one call) on per-channel streams from ``carry``; returns the
    max absolute difference over finishes, kinds and carry."""
    from repro_torch.kernels.dram_timing.ops import dram_timing
    from repro_torch.kernels.dram_timing.ref import dram_timing_ref
    st, fins, kinds = carry, [], []
    for a, b in ((0, split), (split, streams[0].shape[1])):
        f, k, st = dram_timing(*(x[:, a:b].contiguous() for x in streams),
                               timing, st)
        fins.append(f)
        kinds.append(k)
    want = dram_timing_ref(*streams, timing, carry)
    torch.cuda.synchronize()
    return timing_diff((torch.cat(fins, 1), torch.cat(kinds, 1), st), want)


def check_dram_timing(dev) -> dict:
    """``dram_timing`` against its plain version on seeded random traces
    of four memories and one bulk trace that trips the tFAW window; also
    at chunks of 64 slots, which split every trace into many chunks (the
    tFAW trace's ACT ring crossing chunk edges), and the serial kernel."""
    from repro_torch.core import vectorized as vec
    from repro_torch.core.dram import PRESETS, ddr4_2400r
    from repro_torch.kernels.dram_timing.ops import (dram_timing_chunks,
                                                     dram_timing_serial)
    from repro_torch.kernels.dram_timing.ref import dram_timing_ref
    memories = {"ddr3": PRESETS["hitgraph"], "ddr4": PRESETS["accugraph"],
                "hbm2": PRESETS["hbm2"],
                "ddr4-2ch-2rank": lambda: ddr4_2400r(channels=2, ranks=2),
                "ddr4-faw": PRESETS["accugraph"]}
    worst = 0
    for i, (name, make) in enumerate(memories.items()):
        cfg = make()
        bulk = name == "ddr4-faw"
        packed = channel_streams(cfg, np.random.default_rng(200 + i),
                                 bulk=bulk)
        streams = [torch.as_tensor(a, device=dev) for a in
                   (packed.issue, packed.bank, packed.row, packed.valid)]
        t_np = vec.timing_params(cfg.timing)
        timing = torch.as_tensor(t_np, device=dev)
        carry = vec.init_channel_carry(cfg.channels, cfg.banks_per_channel,
                                       cfg.org.banks, dev)
        worst = max(worst, timing_both(streams, timing, carry,
                                       packed.issue.shape[1] // 2 + 1))
        want = dram_timing_ref(*streams, timing, carry)
        for got in (dram_timing_chunks(*streams, timing, carry, 64)[:3],
                    dram_timing_serial(*streams, timing, carry)):
            worst = max(worst, timing_diff(got, want))
        if bulk:
            no_faw = t_np.copy()
            no_faw[6] = 0
            binds = not torch.equal(
                dram_timing_ref(*streams, timing, carry)[0],
                dram_timing_ref(*streams, torch.as_tensor(no_faw,
                                                          device=dev),
                                carry)[0])
            assert binds, "the bulk trace does not reach the tFAW window"
    assert worst == 0, f"dram_timing differs from its plain version: {worst}"
    return {"dram_timing_cases": len(memories),
            "dram_timing_max_abs_diff": worst, "faw_window_binds": True,
            "dram_timing_chunk_lens": ["default", 64],
            "dram_timing_serial_checked": True}


def max_rel_err(got, want) -> float:
    """Largest ``|got - want| / |want|`` over ``want != 0``; where
    ``want`` is 0, ``got`` must be 0 too."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert np.all(np.isfinite(got)), "non-finite values"
    zero = want == 0
    assert np.all(got[zero] == 0), "a value with no contribution is not 0"
    if zero.all():
        return 0.0
    return float(np.max(np.abs(got[~zero] - want[~zero])
                        / np.abs(want[~zero])))


def close(a, b, rtol, atol) -> float:
    """Max absolute difference of two tensors; asserts ``|a - b| <= atol
    + rtol * |b|`` elementwise (exactly equal when both are 0)."""
    a, b = a.float(), b.float()
    if rtol == 0 and atol == 0:
        assert torch.equal(a, b), "kernel differs from its plain version"
    else:
        assert torch.allclose(a, b, rtol=rtol, atol=atol), (
            "kernel differs from its plain version beyond the tolerance")
    return float((a - b).abs().max()) if a.numel() else 0.0


def run_ids(layout, rng):
    """Segment ids of a run layout, and the segment count: ``sorted``
    (destination order, a long hub run), ``unsorted`` (the same ids
    shuffled), ``one-run`` (one id over many 4,096-update tiles) and
    ``edges`` (runs ending one before, at and one after the 16-update
    thread, 512-update warp and 4,096-update tile boundaries); out-of-
    range ids lie inside runs."""
    n = 300
    if layout == "one-run":
        ids = np.full(50_000, 7)
    elif layout == "edges":
        lengths = np.array([15, 1, 16, 17, 511, 1, 513, 4095, 2, 4097,
                            8192, 3, 4096])
        ids = np.repeat(rng.permutation(n)[:len(lengths)], lengths)
    else:
        lengths = rng.integers(0, 60, n)
        lengths[5] = 20_000
        ids = np.repeat(np.arange(n), lengths)
    ids = ids.astype(np.int32)
    inside = rng.random(len(ids)) < 0.002
    ids[inside] = rng.choice([-1, n, n + 9], size=int(inside.sum()))
    if layout == "unsorted":
        ids = rng.permutation(ids)
    return ids, n


def check_stationary_kernels(dev) -> dict:
    """``segment_reduce``, ``edge_scatter`` and ``spmv_ell`` against their
    plain versions on seeded cases at the shapes of the JAX package's
    kernel tests (plus wide ELL rows), with out-of-range ids and padding
    slots that carry nonzero values; ``segment_reduce`` also on run
    layouts (sorted, unsorted, one run over many tiles, runs ending at
    thread, warp and tile edges; d = 1 and 3), and the one-launch pull
    over a sliced ELL of rmat(12, 8) at three heavy thresholds.
    Tolerances: min/max and the scatter exact; f32 sums rtol 1e-5 / atol
    1e-4 (the pull's 1e-6); bf16 sums 5e-2."""
    from repro_torch.kernels.edge_scatter.ops import edge_scatter
    from repro_torch.kernels.edge_scatter.ref import edge_scatter_ref
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels.spmv_ell.ops import (CHUNK_SLOTS, HEAVY_SLOTS,
                                                  pack_in_edges, spmv_ell,
                                                  spmv_sell)
    from repro_torch.kernels.spmv_ell.ref import spmv_ell_ref, spmv_sell_ref
    tol = {("sum", torch.float32): (1e-5, 1e-4),
           ("sum", torch.bfloat16): (5e-2, 5e-2),
           ("min", torch.float32): (0, 0), ("max", torch.float32): (0, 0)}
    worst = {"segment_reduce": 0.0, "edge_scatter": 0.0, "spmv_ell": 0.0}
    cases = {name: 0 for name in worst}
    for m, n, d in ((1000, 300, 1), (513, 128, 4), (128, 700, 2)):
        rng = np.random.default_rng(m + n)
        ids = i32(rng.integers(-2, n + 2, m), dev)
        vals = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                               device=dev)
        if d == 1:
            vals = vals[:, 0].contiguous()
        for (op, dtype), (rtol, atol) in tol.items():
            v = vals.to(dtype)
            worst["segment_reduce"] = max(worst["segment_reduce"], close(
                segment_reduce(ids, v, n, op),
                segment_reduce_ref(ids, v, n, op), rtol, atol))
            cases["segment_reduce"] += 1
    for m, q in ((500, 256), (128, 1000), (77, 33)):
        rng = np.random.default_rng(m + q)
        args = (i32(rng.integers(-2, q + 3, m), dev),
                torch.as_tensor(rng.normal(size=m).astype(np.float32),
                                device=dev),
                torch.as_tensor(rng.normal(size=q).astype(np.float32),
                                device=dev),
                torch.as_tensor((rng.random(q) < 0.5).astype(np.float32),
                                device=dev))
        for op in ("copy", "add", "mul"):
            got, want = edge_scatter(*args, op), edge_scatter_ref(*args, op)
            worst["edge_scatter"] = max(worst["edge_scatter"],
                                        close(got[0], want[0], 0, 0),
                                        close(got[1], want[1], 0, 0))
            cases["edge_scatter"] += 1
    for layout in ("sorted", "unsorted", "one-run", "edges"):
        rng = np.random.default_rng(len(layout))
        ids_np, n = run_ids(layout, rng)
        ids = i32(ids_np, dev)
        for d in (1, 3):
            vals = torch.as_tensor(rng.normal(size=(len(ids_np), d)).astype(
                np.float32), device=dev)
            if d == 1:
                vals = vals[:, 0].contiguous()
            for op in ("sum", "min", "max"):
                for dtype in (torch.float32, torch.bfloat16):
                    rtol, atol = tol.get((op, dtype), (0, 0))
                    v = vals.to(dtype)
                    worst["segment_reduce"] = max(
                        worst["segment_reduce"],
                        close(segment_reduce(ids, v, n, op),
                              segment_reduce_ref(ids, v, n, op), rtol, atol))
                    cases["segment_reduce"] += 1
    for n, k, nx in ((256, 4, 256), (100, 7, 333), (513, 2, 128),
                     (1000, 1, 500), (300, 16, 900), (70, 33, 400),
                     (5, 1000, 3000), (3, 9000, 5000)):
        rng = np.random.default_rng(n * 7 + k)
        cols = rng.integers(0, nx, (n, k)).astype(np.int32)
        pad = rng.random((n, k)) < 0.2
        cols[pad] = rng.choice([nx, nx + 7, -1], size=int(pad.sum()))
        args = (i32(cols, dev),
                torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32),
                                device=dev),
                torch.as_tensor(rng.normal(size=nx).astype(np.float32),
                                device=dev))
        worst["spmv_ell"] = max(worst["spmv_ell"], close(
            spmv_ell(*args), spmv_ell_ref(*args), 1e-5, 1e-4))
        cases["spmv_ell"] += 1
    g = rmat(12, 8, seed=5)
    rng = np.random.default_rng(5)
    w = rng.random(g.m).astype(np.float32)
    x = torch.as_tensor(rng.random(g.n).astype(np.float32), device=dev)
    for heavy, chunk in ((HEAVY_SLOTS, CHUNK_SLOTS), (256, 100), (4, 3)):
        a = pack_in_edges(g.src, g.dst, g.n, w, device=dev, heavy=heavy,
                          chunk=chunk)
        assert a.n_chunks > 0
        worst["spmv_ell"] = max(worst["spmv_ell"], close(
            spmv_sell(a, x), spmv_sell_ref(a, x), 1e-5, 1e-6))
        cases["spmv_ell"] += 1
    torch.cuda.synchronize()
    return {f"{name}_cases": cases[name] for name in worst} | {
        f"{name}_max_abs_diff": worst[name] for name in worst}


def stationary_f64(g, problem: str, iters: int) -> np.ndarray:
    """PR / SpMV (unit weights) recomputed in float64 with NumPy."""
    n = g.n
    if problem == "pr":
        inv = 1.0 / np.maximum(g.out_degrees(), 1)
        x = np.full(n, 1.0 / n)
    else:
        x = np.ones(n)
    for _ in range(iters):
        contrib = x[g.src] * inv[g.src] if problem == "pr" else x[g.src]
        acc = np.bincount(g.dst, weights=contrib, minlength=n)
        x = (1.0 - 0.85) / n + 0.85 * acc if problem == "pr" else acc
    return x


def run_stationary_path(wt, sessions, card, dev):
    """PR and SpMV at full size on both accelerators through
    ``SimSession.run``, reusing the main path's sessions (the models are
    not rebuilt); launch counts zeroed just before each run and read just
    after: one ``edge_scatter`` and one ``segment_reduce`` (HitGraph) or
    one ``spmv_ell`` (AccuGraph) an iteration.  Each line also gives the
    time of the engine's per-run set-up on the card (HitGraph's sort of
    the edges by destination, AccuGraph's sliced-ELL packing), measured
    apart from the run.  Returns the path's total launches by kernel and
    the runs, by (accelerator, problem)."""
    from repro_torch.algorithms.common import Problem, stationary_inputs
    from repro_torch.algorithms.edge_centric import sort_by_dst
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.spmv_ell.ops import pack_in_edges
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.session import resolve_run_config
    total = {name: 0 for name in KERNELS}
    runs, reports = {}, {}
    w_np, _ = stationary_inputs(wt, Problem.PR)
    setup = {
        "hitgraph": ("dst_sort_ms", lambda: sort_by_dst(
            i32(wt.src, dev), i32(wt.dst, dev),
            torch.as_tensor(w_np, device=dev))),
        "accugraph": ("ell_pack_ms", lambda: pack_in_edges(
            wt.src, wt.dst, wt.n, w_np, device=dev))}
    for acc in ("hitgraph", "accugraph"):
        spec = get_accelerator(acc)
        cfg = resolve_run_config(spec)
        setup_key, setup_fn = setup[acc]
        setup_fn()
        setup_ms = host_ms(setup_fn)
        for prob in STATIONARY:
            zero_launch_counts()
            t0 = time.perf_counter()
            r = sessions[acc].run(prob, acc, fixed_iters=STATIONARY_ITERS)
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            for name in KERNELS:
                total[name] += counts[name]
            run = sessions[acc].algorithm_run(spec, Problem(prob), cfg, 0,
                                              STATIONARY_ITERS, dev)
            assert run.values.shape == (wt.n,)
            err = max_rel_err(run.values,
                              stationary_f64(wt, prob, STATIONARY_ITERS))
            emit(phase="stationary", accelerator=acc, problem=prob,
                 memory=cfg.dram_config().name, iterations=r.iterations,
                 requests=r.total_requests, runtime_ns=r.runtime_ns,
                 row_hit_rate=r.row_hit_rate, max_rel_err=err,
                 tolerance=STATIONARY_RTOL,
                 kernel_launches={k: counts[k] for k in KERNELS},
                 stage_seconds=r.stage_seconds, seconds=seconds,
                 **{setup_key: setup_ms}, card=card)
            assert err <= STATIONARY_RTOL, (acc, prob, err)
            assert r.iterations == STATIONARY_ITERS, r.iterations
            assert r.runtime_ns == PINNED_RUNTIME_NS["stationary", acc], (
                acc, prob, r.runtime_ns)
            assert np.isfinite(r.runtime_ns) and r.runtime_ns > 0
            assert counts["dram_serve"] > 0
            need = (("edge_scatter", "segment_reduce") if acc == "hitgraph"
                    else ("spmv_ell",))
            for name in need:
                assert counts[name] == STATIONARY_ITERS, (
                    f"{name} launched {counts[name]} times on {acc} {prob},"
                    f" not once an iteration")
            runs[acc, prob], reports[acc, prob] = run, r
        pr, spmv = reports[acc, "pr"], reports[acc, "spmv"]
        assert dataclasses.replace(pr, problem="spmv") == spmv, (
            f"{acc}: PR's report differs from SpMV's beyond `problem`")
    return total, runs


def bucket_slots(deg) -> int:
    """Slots of the per-bucket ELL the pull ran on before the sliced
    layout: every row with an in-edge padded to the power of two at or
    above its in-degree."""
    d = deg[deg > 0].astype(np.int64)
    return int(np.sum(np.left_shift(1, np.frexp(d - 1)[1])))


def compare_stationary(wt, runs, dev) -> dict:
    """The three stationary kernels against their plain versions on the
    path's own full-size PR inputs, with the kernel's, the plain
    version's and one PyTorch call's device time, and the byte bound:
    HitGraph's scatter and gather over the destination-sorted edges (and,
    as a second line, the raw edge order), with the run's PR values;
    AccuGraph's whole pull step (zeroing memset and one launch) over the
    sliced ELL, with its run's PR values, beside cuSPARSE's CSR mat-vec,
    with the bound over the edges and the bound over the slots of the
    per-bucket layout the pull ran on before."""
    from repro_torch.algorithms.common import Problem, stationary_inputs
    from repro_torch.algorithms.edge_centric import sort_by_dst
    from repro_torch.kernels.edge_scatter.ops import edge_scatter
    from repro_torch.kernels.edge_scatter.ref import edge_scatter_ref
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref
    from repro_torch.kernels.spmv_ell.ops import pack_in_edges, spmv_sell
    from repro_torch.kernels.spmv_ell.ref import spmv_sell_ref
    n, m = wt.n, wt.m
    w_np, _ = stationary_inputs(wt, Problem.PR)
    src_raw, dst_raw = i32(wt.src, dev), i32(wt.dst, dev)
    w_raw = torch.as_tensor(w_np, device=dev)
    src, dst, w = sort_by_dst(src_raw, dst_raw, w_raw)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    deg = wt.in_degrees()
    out = {}

    # HitGraph's scatter: values[src] * w, over the sorted edges
    x = torch.as_tensor(runs["hitgraph", "pr"].values, device=dev)
    upd, valid = edge_scatter(src, w, x, ones, "mul")
    upd_p, valid_p = edge_scatter_ref(src, w, x, ones, "mul")
    err = max(close(upd, upd_p, 0, 0), close(valid, valid_p, 0, 0))
    out["edge_scatter"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: edge_scatter(src, w, x, ones, "mul"), 20),
        "plain_ms": cuda_ms(
            lambda: edge_scatter_ref(src, w, x, ones, "mul"), 5),
        "library_ms": cuda_ms(lambda: x.index_select(0, src) * w, 20),
        "library_call": "values.index_select(0, src) * w",
        "bound_ms": (16 * m + 8 * n) / HBM_BYTES_PER_S * 1e3,
        "raw_order_ms": cuda_ms(
            lambda: edge_scatter(src_raw, w_raw, x, ones, "mul"), 20),
        "shape": {"edges": m, "vertices": n}}
    del upd_p, valid_p, valid

    # HitGraph's gather: the updates summed onto their destinations, in
    # destination order as the path feeds them, and in raw edge order
    upd_raw, _ = edge_scatter(src_raw, w_raw, x, ones, "mul")
    acc = segment_reduce(dst, upd, n, "sum")
    acc_p = segment_reduce_ref(dst, upd, n, "sum")
    rel = max_rel_err(acc.cpu().numpy(), acc_p.cpu().numpy())
    err = close(acc, acc_p, 1e-5, 0)
    acc_raw = segment_reduce(dst_raw, upd_raw, n, "sum")
    err = max(err, close(acc_raw, segment_reduce_ref(dst_raw, upd_raw, n,
                                                     "sum"), 1e-5, 0))
    lengths = torch.as_tensor(deg, device=dev)
    lib_acc = torch.zeros(n, dtype=torch.float32, device=dev)
    lib_seg = torch.segment_reduce(upd, "sum", lengths=lengths)
    assert max_rel_err(lib_seg.cpu().numpy(), acc_p.cpu().numpy()) < 1e-3
    out["segment_reduce"] = {
        "max_abs_err": err, "max_rel_err": rel,
        "ms": cuda_ms(lambda: segment_reduce(dst, upd, n, "sum"), 20),
        "plain_ms": cuda_ms(
            lambda: segment_reduce_ref(dst, upd, n, "sum"), 5),
        "library_ms": cuda_ms(
            lambda: lib_acc.index_add_(0, dst, upd), 10),
        "library_call": "out.index_add_(0, dst, upd), dst-sorted",
        "torch_segment_reduce_ms": cuda_ms(
            lambda: torch.segment_reduce(upd, "sum", lengths=lengths), 10),
        "raw_order_ms": cuda_ms(
            lambda: segment_reduce(dst_raw, upd_raw, n, "sum"), 10),
        "raw_order_index_add_ms": cuda_ms(
            lambda: lib_acc.index_add_(0, dst_raw, upd_raw), 10),
        "dst_sort_ms": cuda_ms(
            lambda: sort_by_dst(src_raw, dst_raw, w_raw), 5),
        "bound_ms": (8 * m + 4 * n) / HBM_BYTES_PER_S * 1e3,
        "shape": {"updates": m, "segments": n,
                  "largest_segment": int(deg.max())}}
    del upd, upd_raw, acc, acc_p, acc_raw, lib_seg

    # AccuGraph's pull: the whole y in one launch over the sliced ELL
    x = torch.as_tensor(runs["accugraph", "pr"].values, device=dev)
    pack_ms = host_ms(lambda: pack_in_edges(wt.src, wt.dst, n, w_np,
                                            device=dev))
    a = pack_in_edges(wt.src, wt.dst, n, w_np, device=dev)
    y = spmv_sell(a, x)
    y_p = spmv_sell_ref(a, x)
    rel = max_rel_err(y.cpu().numpy(), y_p.cpu().numpy())
    err = close(y, y_p, 1e-5, 0)
    order = np.argsort(wt.dst, kind="stable")
    crow = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=crow[1:])
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(crow, device=dev),
        torch.as_tensor(wt.src[order], device=dev),
        torch.as_tensor(w_np[order], device=dev), size=(n, n))
    rows = int((deg > 0).sum())
    slots, old_slots = int(a.cols.numel()), bucket_slots(deg)
    # where the step's time goes: the zeroing alone, the heavy chunks
    # alone and the light slices alone (each with its memset), and the
    # whole step at other heavy thresholds
    heavy_only = dataclasses.replace(a, slice_ptr=a.slice_ptr[:1].clone(),
                                     slice_rows=a.slice_rows[:0].clone())
    light_only = dataclasses.replace(a, chunk_ptr=a.chunk_ptr[:1].clone(),
                                     chunk_rows=a.chunk_rows[:0].clone())
    zeroed = torch.empty(n, dtype=torch.float32, device=dev)
    parts = {"memset_ms": cuda_ms(zeroed.zero_, 20),
             "heavy_only_ms": cuda_ms(lambda: spmv_sell(heavy_only, x), 20),
             "light_only_ms": cuda_ms(lambda: spmv_sell(light_only, x), 20)}
    by_threshold = {}
    for heavy in (16, 32, 64, 128, 256):
        b = pack_in_edges(wt.src, wt.dst, n, w_np, device=dev, heavy=heavy)
        close(spmv_sell(b, x), spmv_sell_ref(b, x), 1e-5, 0)
        by_threshold[heavy] = cuda_ms(lambda: spmv_sell(b, x), 20)
    del b, heavy_only, light_only
    out["spmv_ell"] = {
        "max_abs_err": err, "max_rel_err": rel,
        "ms": cuda_ms(lambda: spmv_sell(a, x), 20),
        "plain_ms": cuda_ms(lambda: spmv_sell_ref(a, x), 3),
        "library_ms": cuda_ms(lambda: csr @ x, 20),
        "library_call": "torch.sparse_csr_tensor(in-edges) @ x",
        "bound_ms": (8 * m + 4 * n + 4 * rows) / HBM_BYTES_PER_S * 1e3,
        "slot_bound_ms": (8 * slots + 4 * n + 4 * rows)
        / HBM_BYTES_PER_S * 1e3,
        "per_bucket_layout": {
            "slots": old_slots, "launches_per_step": int(np.unique(
                np.frexp(deg[deg > 0] - 1)[1]).size),
            "bound_ms": (8 * old_slots + 4 * n + 4 * rows)
            / HBM_BYTES_PER_S * 1e3},
        "pack_ms": pack_ms, "parts": parts,
        "ms_by_heavy_threshold": by_threshold,
        "shape": {"slices": a.n_slices, "heavy_chunks": a.n_chunks,
                  "heavy_rows": int(torch.unique(a.chunk_rows).numel()),
                  "slots": slots, "rows": rows, "nnz": m,
                  "widest_slice": int((a.slice_ptr[1] - a.slice_ptr[0])
                                      // 32) if a.n_slices else 0}}
    return out


def run_dynamic_path(wt, acc, session, main_report, card, phases):
    """One full-size dynamic run through ``run_dynamic(verify=True)``,
    sharing the main path's session (so epoch 0 reuses its algorithm run
    and model); one JSON row per epoch, then the run's totals.  The
    per-channel streams and carry of its first ``ep{e}_apply`` phase, as
    ``VectorizedDRAM.run_phase`` hands them to ``dram_timing``, go to
    ``phases[acc]`` (kept by reference; no launch is added)."""
    from repro_torch.core import vectorized as vec
    from repro_torch.sim import run_dynamic
    preset = DYNAMIC_CASES[acc]
    serve = vec.simulate_packed

    def keep(issue, bank, row, valid, timing, carry):
        phases.setdefault(acc, (issue, bank, row, valid, timing, carry))
        return serve(issue, bank, row, valid, timing, carry)

    vec.simulate_packed = keep
    t0 = time.perf_counter()
    try:
        res = run_dynamic(wt, "wcc", updates=preset, accelerator=acc,
                          session=session, verify=True)
    finally:
        vec.simulate_packed = serve
    seconds = time.perf_counter() - t0
    assert res.n_epochs == 4, res.n_epochs
    # epoch 0 is the static main path, bit for bit (its ``phases`` list
    # is the timeline's own, as in the JAX package, so it has grown by
    # the later epochs' phases)
    ep0 = res.epochs[0].report
    assert dataclasses.replace(
        ep0, phases=ep0.phases[:len(main_report.phases)]) == main_report
    assert res.epochs[0].iterations == MAIN_EXPECT[acc][0]
    assert np.array_equal(res.checkpoint, res.final_values)
    got = [(ep.iterations, ep.report.total_requests) for ep in res.epochs]
    assert got == DYNAMIC_PINNED[acc], (acc, got)
    for ep in res.epochs:
        r = ep.report
        assert np.isfinite(r.runtime_ns) and r.runtime_ns > 0
        apply = None
        if ep.epoch:
            assert ep.touched_partitions > 0 and ep.iterations > 0
            assert r.phases[0].name == f"ep{ep.epoch}_apply"
            apply = {"requests": r.phases[0].requests,
                     "kernel_ms": r.stage_seconds["phase_serve"] * 1e3}
        emit(phase="dynamic_epoch", accelerator=acc, updates=preset,
             epoch=ep.epoch, iterations=ep.iterations,
             requests=r.total_requests, runtime_ns=r.runtime_ns,
             row_hit_rate=r.row_hit_rate, inserted=ep.inserted,
             deleted=ep.deleted, touched_partitions=ep.touched_partitions,
             total_partitions=ep.total_partitions,
             reset_vertices=ep.reset_vertices,
             frontier_vertices=ep.frontier_vertices, apply=apply,
             kernel_launches={k: r.kernel_launches.get(k, 0)
                              for k in KERNELS},
             stage_seconds=r.stage_seconds)
    agg = res.report
    assert agg.runtime_ns == PINNED_RUNTIME_NS["dynamic", acc], (
        acc, agg.runtime_ns)
    emit(phase="dynamic", accelerator=acc, updates=preset,
         epochs=res.n_epochs, iterations=agg.iterations,
         requests=agg.total_requests, runtime_ns=agg.runtime_ns,
         row_hit_rate=agg.row_hit_rate, final_edges=res.final_graph.m,
         verified=True, seconds=seconds, card=card)
    return res


def chunked_ms(streams, timing, carry, T, group=None, reps=3):
    """The chunked scan's launches (chunks of ``T``, the carry scan's
    groups of ``group``, by default as ``dram_timing`` runs it), timed by
    CUDA events around each (the wrapper's final read of ``kind`` left
    out), over ``reps`` warmed runs: (mean total ms, mean ms of each launch
    by name)."""
    from repro_torch.kernels.dram_timing.ops import (GROUP, LAUNCHES,
                                                     dram_timing_chunks)
    group = GROUP if group is None else group
    dram_timing_chunks(*streams, timing, carry, T, group)
    runs = [dram_timing_chunks(*streams, timing, carry, T, group,
                               time_passes=True)[3] for _ in range(reps)]
    passes = {name: sum(r[i] for r in runs) / reps
              for i, name in enumerate(LAUNCHES)}
    return sum(passes.values()), passes


def compare_dram_timing(phases, dev) -> dict:
    """``dram_timing`` on the dynamic path's own inputs: the first
    rewrite phase of each run (``phases``, the streams and carry that
    ``run_phase`` gave the kernel).  On each full phase the chunked scan
    is held bit for bit to the serial kernel (finish, kind, carry) and
    both are timed, the chunked scan launch by launch, at every chunk
    length it is built for, and with the carry scan's groups of 1 (one
    serial walk over the chunks), 8, 32 and 64; on an 8,192-slot window of
    each, entered
    with the kernel's own carry and served as two chained calls, both
    kernels are held to the plain version, whose time is taken there."""
    from repro_torch.kernels.dram_timing.ops import (CHUNK_LENS, GROUP,
                                                     chunk_len, dram_timing,
                                                     dram_timing_chunks,
                                                     dram_timing_serial)
    from repro_torch.kernels.dram_timing.ref import dram_timing_ref
    out = {}
    for acc, (*streams, timing, carry) in phases.items():
        C, L = streams[0].shape
        B, R = carry[0].shape[1], carry[5].shape[1]
        T = chunk_len(C, L, R)
        serial = dram_timing_serial(*streams, timing, carry)
        got = dram_timing(*streams, timing, carry)
        full_diff = timing_diff(got, serial)
        assert full_diff == 0, (
            f"dram_timing differs from the serial kernel on the full {acc} "
            f"phase: {full_diff}")
        del got
        ms, passes = chunked_ms(streams, timing, carry, T)
        by_len = {n: chunked_ms(streams, timing, carry, n, reps=2)[0]
                  for n in CHUNK_LENS}
        by_group = {g: chunked_ms(streams, timing, carry, T, g, reps=2)[0]
                    for g in GROUPS}
        for n, g in [(n, GROUP) for n in CHUNK_LENS] + [(T, g)
                                                        for g in GROUPS]:
            other = dram_timing_chunks(*streams, timing, carry, n, g)[:3]
            full_diff = max(full_diff, timing_diff(other, serial))
        assert full_diff == 0, f"a chunk length differs on {acc}: {full_diff}"
        del serial, other
        serial_ms = cuda_ms(
            lambda: dram_timing_serial(*streams, timing, carry), reps=2)
        call_ms = host_ms(lambda: dram_timing(*streams, timing, carry))
        W = min(8192, L)
        lo = max(0, min(W, L - W))
        st = dram_timing(*(x[:, :lo].contiguous() for x in streams), timing,
                         carry)[2]
        win = [x[:, lo:lo + W].contiguous() for x in streams]
        diff = timing_both(win, timing, st, W // 2)
        want = dram_timing_ref(*win, timing, st)
        diff = max(diff, timing_diff(dram_timing_serial(*win, timing, st),
                                     want))
        assert diff == 0, f"dram_timing differs on the {acc} window: {diff}"
        win_ms = chunked_ms(win, timing, st, chunk_len(C, W, R))[0]
        win_serial_ms = cuda_ms(lambda: dram_timing_serial(*win, timing, st),
                                reps=5)
        plain_ms = host_ms(lambda: dram_timing_ref(*win, timing, st))
        out[acc] = {
            "max_abs_err": diff, "full_phase_max_abs_err": full_diff,
            "full_phase": {
                "shape": [C, L], "valid_slots": int(streams[3].sum()),
                "chunk_len": T, "ms": ms, "serial_ms": serial_ms,
                "call_ms": call_ms,
                "passes_ms": passes,
                "ms_by_chunk_len": by_len, "group": GROUP,
                "ms_by_group": by_group,
                "bound_ms": timing_bytes(C, L, B, R) / HBM_BYTES_PER_S * 1e3},
            "window": {"shape": [C, W], "start": lo,
                       "valid_slots": int(win[3].sum()), "ms": win_ms,
                       "serial_ms": win_serial_ms, "plain_ms": plain_ms,
                       "bound_ms": timing_bytes(C, W, B, R)
                       / HBM_BYTES_PER_S * 1e3}}
        emit(phase="dram_timing", accelerator=acc, **out[acc])
    return out


def batch_timings(M: int, rng) -> np.ndarray:
    """M seeded timing vectors (tBL small, as devices have it)."""
    t = rng.integers(1, 40, size=(M, 7)).astype(np.int32)
    t[:, 4] = rng.integers(1, 5, size=M)
    return t


def check_serve_batch(dev) -> dict:
    """``dram_serve_batch`` (and its pre-pass's records) against its plain
    version on the card, bit for bit: one program shared by every case
    and M stacked programs whose phase boundaries fall on different
    steps, M in {1, 3, 5}, C in {1, 4} (AccuGraph's DDR4, HitGraph's
    DDR3), K in {1, 8} (miss-heavy and hit-heavy programs), each case
    against its own seeded timing vector; and one shared case of M = 133,
    more CTAs than the card has SMs."""
    from repro_torch.core import vectorized as vec
    from repro_torch.core.accel import pack_program
    from repro_torch.core.dram import PRESETS
    from repro_torch.kernels.dram_timing.ops import (chunk_steps,
                                                     dram_serve_batch,
                                                     serve_prepass_batch)
    from repro_torch.kernels.dram_timing.ref import (dram_serve_batch_ref,
                                                     serve_prepass_batch_ref)
    worst, runs, seed = 0, [], 0

    def hold(streams, timing, packed, label):
        nonlocal worst
        M, C = timing.shape[0], streams[0].shape[-2]
        state = vec._cold_batch_state(M, C, packed.n_banks,
                                      packed.banks_per_rank, dev)
        fin_k, st_k = dram_serve_batch(*streams, timing, state)
        fin_p, st_p = dram_serve_batch_ref(*streams, timing, state)
        S, _, K = streams[0].shape[-3:]
        R = state[3].shape[2]
        T = chunk_steps(C, K)
        bpr = packed.banks_per_rank
        rec = serve_prepass_batch(*streams, timing, bpr, R, T)
        rec_p = serve_prepass_batch_ref(*streams, timing, bpr, R,
                                        rec.shape[2])
        torch.cuda.synchronize()
        diff = max([max_abs_diff(fin_k, fin_p), max_abs_diff(rec, rec_p)]
                   + [max_abs_diff(a, b) for a, b in zip(st_k, st_p)])
        worst = max(worst, diff)
        runs.append({"case": label, "M": M, "shape": [S, C, K],
                     "max_abs_diff": diff})

    for preset in ("accugraph", "hitgraph"):
        cfg = PRESETS[preset]()
        for hit_heavy in (False, True):
            for M in (1, 3, 5):
                rng = np.random.default_rng(seed)
                seed += 1
                packs = [pack_program(random_program(rng, hit_heavy, 3, 100),
                                      cfg) for _ in range(M)]
                shapes = {p.issue.shape for p in packs}
                assert len(shapes) == 1, shapes
                timing = i32(batch_timings(M, rng), dev)
                hold([i32(getattr(packs[0], f), dev)
                      for f in ("issue", "meta", "boundary")], timing,
                     packs[0], f"{preset}/shared")
                bnds = {tuple(np.flatnonzero(p.boundary)) for p in packs}
                assert len(bnds) == M, "stacked boundaries must differ"
                hold([i32(np.stack([getattr(p, f) for p in packs]), dev)
                      for f in ("issue", "meta", "boundary")], timing,
                     packs[0], f"{preset}/stacked")
    rng = np.random.default_rng(seed)
    packed = pack_program(random_program(rng, True, 2, 20),
                          PRESETS["hitgraph"]())
    hold([i32(getattr(packed, f), dev) for f in ("issue", "meta",
                                                  "boundary")],
         i32(batch_timings(133, rng), dev), packed, "hitgraph/shared")
    assert worst == 0, "dram_serve_batch differs from its plain version"
    return {"dram_serve_batch_cases": runs,
            "dram_serve_batch_max_abs_diff": worst}


def lookup_case(rng, U, W, n, hot=0.0, big=False, invalid=0.5,
                unsorted=0.0, negative=0.0, twice=0.0):
    """A set-sorted stream through a warm state: ``hot`` of the reads on
    set 0, tags from 3W values (half of them past 2**31 with ``big``),
    ``invalid`` of the ways holding -1; then what the thread path hands
    to the warp path: ``unsorted`` of the rows with ages that are not a
    permutation, ``twice`` of the rows holding a line in two ways,
    ``negative`` of the reads with tag -1 (and with ``big`` the tags past
    2**31).  Returns ``(seg_ptr, tag, pos, tags, age)`` as NumPy arrays."""
    row = np.where(rng.random(n) < hot, 0, rng.integers(0, U, n))
    base = 2**31 - int(1.5 * W) if big else 7
    tag = base + rng.integers(0, 3 * W, n)
    tag[rng.random(n) < negative] = -1
    order = np.argsort(row, kind="stable")
    seg_ptr = np.concatenate([[0], np.cumsum(np.bincount(row,
                                                         minlength=U))])
    tags = np.stack([base + rng.permutation(3 * W)[:W] for _ in range(U)])
    tags[rng.random((U, W)) < invalid] = -1
    if W > 1:
        dup = rng.random(U) < twice
        tags[dup, 1] = tags[dup, 0] = base
    age = np.argsort(rng.random((U, W)), axis=1)
    odd = rng.random(U) < unsorted
    age[odd] = rng.integers(-2, W + 2, (int(odd.sum()), W))
    return (seg_ptr.astype(np.int64), tag[order].astype(np.int64),
            order.astype(np.int32), tags.astype(np.int64),
            age.astype(np.int64))


def check_cache_lookup(dev) -> dict:
    """``cache_lookup`` against its plain version on seeded set-sorted
    streams (:func:`lookup_case`), hits and the updated state bit for
    bit: 1, 16, 32 ways (the thread path) and 33, 64 (the warp path, one
    and two register slots a lane), even and with one hot set; tags past
    2**31 and rows and reads the thread path hands to the warp path (16,
    32 and 64 ways); a stream shaped like the default cache's (2,048 sets
    of ~2,265 reads, 16 ways).  Each stream also through the warp path
    alone."""
    from repro_torch.kernels.cache_lookup import ops
    from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref
    streams = {}
    for W in (1, 16, 32, 33, 64):
        for hot in (0.0, 0.9):
            rng = np.random.default_rng(W * 10 + int(hot * 10))
            streams[f"W{W}/hot{hot}"] = lookup_case(rng, 61, W, 4000, hot)
    for W in (16, 32, 64):
        rng = np.random.default_rng(500 + W)
        streams[f"W{W}/big"] = lookup_case(rng, 61, W, 4000, 0.5, big=True)
        rng = np.random.default_rng(700 + W)
        streams[f"W{W}/handed"] = lookup_case(
            rng, 61, W, 4000, 0.5, unsorted=0.3, negative=0.05, twice=0.3)
    rng = np.random.default_rng(2048)
    streams["default-like"] = lookup_case(rng, 2048, 16, 2048 * 2265)
    worst, cases = 0, {}
    for name, arrays in streams.items():
        seg_ptr, tag, pos, tags0, age0 = (torch.as_tensor(a, device=dev)
                                          for a in arrays)
        t_p, a_p = tags0.clone(), age0.clone()
        hit_p = cache_lookup_ref(seg_ptr, tag, pos, t_p, a_p)
        diffs = []
        for run in (ops.cache_lookup,
                    lambda *a: ops.launch(*a, warp=True)):
            t_k, a_k = tags0.clone(), age0.clone()
            hit = run(seg_ptr, tag, pos, t_k, a_k)
            torch.cuda.synchronize()
            diffs.append(max(max_abs_diff(hit.int(), hit_p.int()),
                             max_abs_diff(t_k, t_p), max_abs_diff(a_k, a_p)))
        cases[name] = {"ways": int(tags0.shape[1]), "reads": int(tag.numel()),
                       "max_abs_err": diffs[0], "warp_path_max_abs_err":
                       diffs[1]}
        worst = max(worst, *diffs)
    assert worst == 0, f"cache_lookup differs from its plain version: {cases}"
    return {"cache_lookup_cases": cases, "cache_lookup_max_abs_diff": worst}


def compare_device_pack(program, dram, host, host_s, dev) -> dict:
    """The device pack of a full program against its host pack
    (``host``, which took ``host_s`` seconds), array for array; the
    device pack's time by CUDA events, the int32 copy of the trace
    included."""
    from repro_torch.core import accel
    d = accel.pack_program_device(program, dram, device=dev)
    P = program.n_phases
    steps = np.diff(np.append(host.step_starts, host.n_steps))
    off = host.offsets[:-1]
    checks = {
        "issue": np.array_equal(d.issue.cpu().numpy(), host.issue),
        "meta": np.array_equal(d.meta.cpu().numpy(), host.meta),
        "boundary": np.array_equal(d.boundary.cpu().numpy(), host.boundary),
        "kind": np.array_equal(d.kind[:len(program)].cpu().numpy(),
                               host.kind),
        "open_row_final": np.array_equal(d.open_row_final.cpu().numpy(),
                                         host.open_row_final),
        "n_steps": d.n_steps == host.n_steps,
        "K": d.K == host.issue.shape[2],
        "L_p": np.array_equal(d.L_p[:P].cpu().numpy(), steps),
        "hits_p": np.array_equal(d.hits_p[:P].cpu().numpy(), np.add.reduceat(
            (host.kind == 0).astype(np.int64), off)),
        "confl_p": np.array_equal(d.confl_p[:P].cpu().numpy(),
                                  np.add.reduceat(
                                      (host.kind == 2).astype(np.int64),
                                      off))}
    assert all(checks.values()), f"device pack differs: {checks}"
    del d
    ms = event_ms(lambda: accel.pack_program_device(program, dram,
                                                    device=dev), reps=3)
    # its two device stages alone, on the padded int32 trace already on
    # the card (the rest is the host's padding and the copy)
    from repro_torch.core import vectorized as vec
    N, C = len(program), dram.channels
    N_pad, P_pad = accel._bucket(N), accel._bucket(P)
    line, issue = (torch.zeros(N_pad, dtype=torch.int32, device=dev)
                   for _ in range(2))
    line[:N] = i32(program.line_addr, dev)
    issue[:N] = i32(program.issue, dev)
    offsets = torch.full((P_pad + 1,), N, dtype=torch.int32, device=dev)
    offsets[:P + 1] = i32(program.offsets, dev)
    open_row = torch.full((C, dram.banks_per_channel), -1,
                          dtype=torch.int32, device=dev)

    def core():
        return vec._device_pack_core(
            line, issue, offsets, N, open_row, spec=dram.decode_spec(),
            C=C, B=dram.banks_per_channel, banks=dram.org.banks)

    out = core()
    S, K = (int(x) for x in out[-2:])
    S_pad = sum(vec.plan_chunks(S))
    core_ms = event_ms(core, reps=3)
    scatter_ms = event_ms(lambda: vec._device_pack_scatter(
        *out[:7], S_pad=S_pad, C=C, K=K), reps=3)
    return {"fields_equal": sorted(checks), "ms": ms,
            "core_ms": core_ms, "scatter_ms": scatter_ms,
            "host_pack_s": host_s, "requests": N,
            "phases": P, "shape": list(host.issue.shape)}


def lookup_bytes(n_reads, U, W) -> int:
    """Bytes the lookup must move: each read's tag (8 B), position (4 B)
    and hit flag (1 B) once, and the touched sets' tags and ages (int64
    each) read and written once."""
    return n_reads * (8 + 4 + 1) + 2 * U * W * 16


def run_cache_path(sessions, card, dev):
    """``SimSession.run("wcc", cache=...)`` at full size: both
    accelerators with ``cache="default"`` and AccuGraph with a 64 MiB
    16-way vertex cache (``BIG_BRAM_LINES``), sharing the main path's
    sessions (the models and algorithm runs are reused).  Launch and route
    counts are zeroed just before each case and read just after.  Every
    ``cache_lookup`` launch is kept (its inputs, the state before it) and
    afterwards held exactly to the plain version on the card and timed
    alone, by the path the wrapper takes and by the warp path (the
    warp-a-set design the thread path replaced for W <= 32).  Returns the
    launches by kernel over all cases and the lookup's numbers for the
    kernel table."""
    from repro_torch.core import accel
    from repro_torch.core.cache import CacheConfig
    from repro_torch.kernels import build, launch_counts, zero_launch_counts
    from repro_torch.kernels.cache_lookup import ops as lookup_ops
    from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref
    big = CacheConfig(lines=BIG_BRAM_LINES, ways=16, name="vertex-64m")
    cases = (("hitgraph", "default", "default"),
             ("accugraph", "default", "default"),
             ("accugraph", "vertex-64m", big))
    kept = []
    lookup = lookup_ops.cache_lookup
    label = None

    def keep(seg_ptr, tag, pos, tags, age):
        kept.append((label, seg_ptr, tag, pos, tags.clone(), age.clone()))
        return lookup(seg_ptr, tag, pos, tags, age)

    total = dict.fromkeys(KERNELS, 0)
    reports = {}
    # the wrapper counts its launches on the module's ``cache_lookup``,
    # which is ``keep`` while it stands in
    lookup_ops.cache_lookup = keep
    try:
        for acc, name, cache in cases:
            label = f"{acc}/{name}"
            zero_launch_counts()
            accel.zero_pack_route_counts()
            t0 = time.perf_counter()
            r = sessions[acc].run("wcc", acc, cache=cache)
            seconds = time.perf_counter() - t0
            launches, routes = launch_counts(), accel.pack_route_counts()
            reports[acc, name] = r
            got = (r.cache_lookups, r.cache_hits, r.prefetch_hits,
                   r.runtime_ns)
            emit(phase="cache", accelerator=acc, cache=name,
                 cache_lookups=got[0], cache_hits=got[1],
                 prefetch_hits=got[2], cache_hit_rate=r.cache_hit_rate,
                 runtime_ns=r.runtime_ns,
                 uncached_runtime_ns=PINNED_RUNTIME_NS["main", acc],
                 requests=r.total_requests, iterations=r.iterations,
                 stage_seconds=r.stage_seconds, seconds=seconds,
                 kernel_launches={k: launches[k] for k in KERNELS},
                 pack_routes=routes, card=card)
            assert routes == {"device_pack": 1, "host_pack": 0}, routes
            # one program, one serve; one lookup where the level has sets
            assert launches["dram_serve"] == 1, launches
            assert launches["cache_lookup"] == (acc == "accugraph"), (
                launches)
            assert got == PINNED_CACHE[acc, name], (acc, name, got)
            assert r.iterations == MAIN_EXPECT[acc][0]
            for k in KERNELS:
                total[k] += launches[k]
    finally:
        lookup_ops.cache_lookup = lookup
        lookup.launches = getattr(keep, "launches", 0)
    # the stream prefetcher never delays a request
    hg = reports["hitgraph", "default"]
    assert hg.runtime_ns <= PINNED_RUNTIME_NS["main", "hitgraph"]
    assert hg.prefetch_hits > 0
    big_r = reports["accugraph", "vertex-64m"]
    assert big_r.cache_hits > 0
    assert big_r.runtime_ns < PINNED_RUNTIME_NS["main", "accugraph"]
    assert total["cache_lookup"] == len(kept) == 2, total
    worst, calls = 0, []
    for name, seg_ptr, tag, pos, tags0, age0 in kept:
        t_k, a_k = tags0.clone(), age0.clone()
        hit = lookup(seg_ptr, tag, pos, t_k, a_k)
        t_p, a_p = tags0.clone(), age0.clone()
        plain_s = time.perf_counter()
        hit_p = cache_lookup_ref(seg_ptr, tag, pos, t_p, a_p)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - plain_s) * 1e3
        diff = max(max_abs_diff(hit.int(), hit_p.int()),
                   max_abs_diff(t_k, t_p), max_abs_diff(a_k, a_p))
        worst = max(worst, diff)

        # the warp path alone on the same stream (the warp-a-set design,
        # which the thread path replaced for W <= 32)
        t_w, a_w = tags0.clone(), age0.clone()
        hit_w = lookup_ops.launch(seg_ptr, tag, pos, t_w, a_w, warp=True)
        torch.cuda.synchronize()
        warp_diff = max(max_abs_diff(hit_w.int(), hit_p.int()),
                        max_abs_diff(t_w, t_p), max_abs_diff(a_w, a_p))
        worst = max(worst, warp_diff)

        def prep():
            t_k.copy_(tags0)
            a_k.copy_(age0)

        U, W = tags0.shape
        counts = seg_ptr[1:] - seg_ptr[:-1]
        thread_max = build.library().repro_cache_lookup_thread_max_ways()
        calls.append({
            "case": name, "reads": int(tag.numel()), "touched_sets": U,
            "ways": W, "hottest_set_reads": int(counts.max()),
            "hits": int(hit.sum()), "max_abs_err": diff,
            "path": "thread" if W <= thread_max else "warp",
            "ms": launch_ms(prep, lambda: lookup(seg_ptr, tag, pos, t_k,
                                                 a_k), reps=5),
            "warp_path_ms": launch_ms(prep, lambda: lookup_ops.launch(
                seg_ptr, tag, pos, t_k, a_k, warp=True), reps=5),
            "warp_path_max_abs_err": warp_diff,
            "plain_ms": plain_ms,
            "bound_ms": lookup_bytes(int(tag.numel()), U, W)
            / HBM_BYTES_PER_S * 1e3})
    assert worst == 0, f"cache_lookup differs from its plain version: {worst}"
    assert calls[1]["hits"] == big_r.cache_hits > 0, calls
    emit(phase="cache_lookup", accelerator="accugraph", launches=calls,
         tolerance="exact", card=card)
    return total, calls


def run_cached_dynamic(wt, session, card):
    """One cached dynamic run at full size: AccuGraph WCC under
    ``pa-growth`` for ``CACHED_DYNAMIC_EPOCHS`` epochs with
    ``cache="default"`` and ``verify=True``, sharing the main path's
    session; the invalidated lines per epoch."""
    from repro_torch.core import accel
    from repro_torch.graphs.updates import UPDATE_PRESETS
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import run_dynamic
    stream = dataclasses.replace(UPDATE_PRESETS["pa-growth"],
                                 epochs=CACHED_DYNAMIC_EPOCHS)
    zero_launch_counts()
    accel.zero_pack_route_counts()
    t0 = time.perf_counter()
    res = run_dynamic(wt, "wcc", updates=stream, accelerator="accugraph",
                      cache="default", session=session, verify=True)
    seconds = time.perf_counter() - t0
    launches, routes = launch_counts(), accel.pack_route_counts()
    assert np.array_equal(res.checkpoint, res.final_values)
    assert routes == {"device_pack": CACHED_DYNAMIC_EPOCHS + 1,
                      "host_pack": 0}, routes
    assert launches["cache_lookup"] == CACHED_DYNAMIC_EPOCHS + 1, launches
    # iterations do not depend on the cache
    iters = [ep.iterations for ep in res.epochs]
    assert iters == [it for it, _ in DYNAMIC_PINNED["accugraph"][
        :CACHED_DYNAMIC_EPOCHS + 1]], iters
    got = [(ep.iterations, ep.report.total_requests, ep.report.cache_hits,
            ep.cache_lines_invalidated) for ep in res.epochs]
    for ep in res.epochs:
        emit(phase="cached_dynamic_epoch", accelerator="accugraph",
             updates="pa-growth", epoch=ep.epoch, iterations=ep.iterations,
             requests=ep.report.total_requests,
             cache_lookups=ep.report.cache_lookups,
             cache_hits=ep.report.cache_hits,
             cache_lines_invalidated=ep.cache_lines_invalidated,
             runtime_ns=ep.report.runtime_ns,
             touched_partitions=ep.touched_partitions,
             kernel_launches={k: ep.report.kernel_launches.get(k, 0)
                              for k in KERNELS},
             stage_seconds=ep.report.stage_seconds)
    emit(phase="cached_dynamic", accelerator="accugraph",
         epochs=res.n_epochs, runtime_ns=res.report.runtime_ns,
         cache_hits=res.report.cache_hits, verified=True, seconds=seconds,
         pack_routes=routes, card=card)
    assert all(ep.cache_lines_invalidated > 0 for ep in res.epochs[1:])
    assert (got, res.report.runtime_ns) == PINNED_CACHED_DYNAMIC, (
        got, res.report.runtime_ns)
    return res


def check_trace(card):
    """The event phase's ``trace`` line: the host's element replay
    (``core.timing.simulate_trace``) against ``simulate_trace_device`` (one
    chunked ``dram_timing`` launch from a cold carry) on the seeded traces
    of ``TRACE_CASES``, bit for bit on the finishes, the three kind counts
    and each channel's makespan; both times and the replay's rate.
    Returns the launches by kernel over the device calls."""
    from repro_torch.core.dram import PRESETS
    from repro_torch.core.timing import simulate_trace
    from repro_torch.core.trace import Trace
    from repro_torch.core.vectorized import simulate_trace_device
    from repro_torch.kernels import launch_counts, zero_launch_counts
    total = dict.fromkeys(KERNELS, 0)
    requests = 0
    for i, (label, preset, n, bulk) in enumerate(TRACE_CASES):
        cfg = PRESETS[preset]()
        rng = np.random.default_rng(300 + i)
        lines = rng.integers(0, 1 << 24 if bulk else 1 << 16, n)
        issue = (np.zeros(n, dtype=np.int64) if bulk
                 else np.sort(rng.integers(0, 4 * n, n)))
        trace = Trace(lines, np.zeros(n, bool), issue)
        t0 = time.perf_counter()
        want = simulate_trace(lines, issue, cfg, keep_finish=True)
        event_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        got = simulate_trace_device(trace, cfg, keep_finish=True)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - t0
        launches = launch_counts()
        assert launches["dram_timing"] == 1, launches
        assert launches["dram_timing_serial"] == 0, launches
        for k in KERNELS:
            total[k] += launches[k]
        kinds = (got.row_hits, got.row_empty, got.row_conflicts)
        want_kinds = (want.row_hits, want.row_empty, want.row_conflicts)
        assert np.array_equal(got.finish, want.finish), label
        assert kinds == want_kinds, (label, kinds, want_kinds)
        assert got.per_channel_cycles == want.per_channel_cycles, label
        assert got.cycles == want.cycles and got.ns == want.ns, label
        faw_binds = None
        if bulk:
            no_faw = dataclasses.replace(cfg, timing=dataclasses.replace(
                cfg.timing, tFAW=0))
            faw_binds = not np.array_equal(
                simulate_trace_device(trace, no_faw, keep_finish=True)
                .finish, got.finish)
            assert faw_binds, "the bulk trace does not reach the tFAW window"
        requests += n
        emit(phase="trace", memory=label, channels=cfg.channels,
             ranks=cfg.org.ranks, requests=n, bulk=bulk, cycles=got.cycles,
             row_hits=kinds[0], row_empty=kinds[1], row_conflicts=kinds[2],
             per_channel_cycles=got.per_channel_cycles,
             equal="finish, kind counts, per_channel_cycles: bit for bit",
             faw_binds=faw_binds, event_s=event_s, device_s=device_s,
             event_requests_per_s=n / event_s,
             dram_timing_launches=launches["dram_timing"], card=card)
    assert requests >= 1 << 20, requests
    return total


def run_event_main(sessions, reports, card):
    """The event phase's ``event_main`` lines: ``SimSession.run("wcc",
    backend="event")`` at full size on both accelerators, sharing the main
    path's sessions (its algorithm runs and models).  The host's element
    replay must give the main path's vectorized report field for field
    (runtime, requests, every ``PhaseStats``), and no serve may launch.
    Returns the launches by kernel over both runs."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    total = dict.fromkeys(KERNELS, 0)
    for acc in ("hitgraph", "accugraph"):
        zero_launch_counts()
        t0 = time.perf_counter()
        r = sessions[acc].run("wcc", acc, backend="event")
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        want = reports[acc]
        differ = [f.name for f in dataclasses.fields(r) if f.compare
                  and getattr(r, f.name) != getattr(want, f.name)]
        replay = r.stage_seconds["replay"]
        emit(phase="event_main", accelerator=acc, size="full",
             vertices=r.vertices, edges=r.edges, requests=r.total_requests,
             runtime_ns=r.runtime_ns, vectorized_runtime_ns=want.runtime_ns,
             row_hits=sum(ph.row_hits for ph in r.phases),
             row_conflicts=sum(ph.row_conflicts for ph in r.phases),
             phases=len(r.phases),
             phases_equal=sum(a == b for a, b in zip(r.phases, want.phases)),
             fields_differing=differ,
             dram_serve_launches=launches["dram_serve"],
             serve_prepass_launches=launches["serve_prepass"],
             stage_seconds=r.stage_seconds, seconds=seconds,
             replay_requests_per_s=r.total_requests / replay, card=card)
        assert not differ and r == want, (acc, differ)
        assert launches["dram_serve"] == launches["serve_prepass"] == 0, (
            launches)
        assert seconds <= EVENT_MAIN_LIMIT_S, (acc, seconds)
        for k in KERNELS:
            total[k] += launches[k]
    return total


def stream_requests(g, run) -> int:
    """The requests the reference machine must issue for ``run`` (default
    widths, 4 B): every iteration reads the value, pointer and neighbor
    arrays once (a request a line after the cache-line buffers) and writes
    the unique lines of the values it changed."""
    def lines(nbytes):
        return -(-nbytes // 64)

    per_iter = lines(4 * g.n) + lines(4 * (g.n + 1)) + lines(4 * g.m)
    writes = sum(len(np.unique(np.flatnonzero(st.changed) * 4 // 64))
                 for st in run.per_iter)
    return run.iterations * per_iter + writes


def run_reference(card, dev):
    """The event phase's ``reference`` lines: WCC and BFS on the
    reference machine at ``REFERENCE_SCALE``, its algorithm on the card
    (round sweeps, no serial one), the engine on the host.  The run must
    equal AccuGraph's ``q = n`` run iteration for iteration, and the
    request count the streams imply.  BFS starts at the vertex of highest
    degree.  Returns the launches by kernel."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.graphs.datasets import instantiate
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import SimSession, get_accelerator
    g = instantiate("wt", REFERENCE_SCALE).undirected_view()
    root = int(np.argmax(g.out_degrees()))
    sess = SimSession(g)
    spec, acc = get_accelerator("reference"), get_accelerator("accugraph")
    total = dict.fromkeys(KERNELS, 0)
    t_all = time.perf_counter()
    for prob in ("wcc", "bfs"):
        p = Problem(prob)
        zero_launch_counts()
        t0 = time.perf_counter()
        r = sess.run(p, "reference", root=root)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        assert launches["sweep_min_rounds"] > 0, launches
        assert launches["sweep_min"] == 0, launches
        for k in KERNELS:
            total[k] += launches[k]
        run = sess.algorithm_run(spec, p, spec.make_config(), root, None,
                                 dev)
        acc_run = acc.run_algorithm(g, p, acc.make_config(), root=root,
                                    device=dev)
        same_run = (run.iterations == acc_run.iterations
                    and np.array_equal(run.values, acc_run.values)
                    and all(np.array_equal(a.changed, b.changed)
                            and np.array_equal(a.active_before,
                                               b.active_before)
                            for a, b in zip(run.per_iter, acc_run.per_iter)))
        want_requests = stream_requests(g, run)
        emit(phase="reference", problem=prob, scale=REFERENCE_SCALE,
             vertices=g.n, edges=g.m, root=root, iterations=r.iterations,
             requests=r.total_requests, stream_requests=want_requests,
             runtime_ns=r.runtime_ns, row_hit_rate=r.row_hit_rate,
             phases=len(r.phases), per_iter_equals_accugraph=same_run,
             sweep_min_rounds_launches=launches["sweep_min_rounds"],
             sweep_min_launches=launches["sweep_min"],
             stage_seconds=r.stage_seconds, seconds=seconds,
             requests_per_s=r.total_requests / r.stage_seconds["replay"],
             card=card)
        assert same_run, prob
        assert r.total_requests == want_requests, (prob, r.total_requests)
        assert len(r.phases) == 3 * r.iterations and r.iterations > 1
        assert np.isfinite(r.runtime_ns) and r.runtime_ns > 0
        assert 0 < r.row_hit_rate <= 1
    seconds = time.perf_counter() - t_all
    emit(phase="reference_total", scale=REFERENCE_SCALE, seconds=seconds,
         budget_s=REFERENCE_BUDGET_S,
         within_budget=seconds <= REFERENCE_BUDGET_S, card=card)
    return total


def run_analytical(wt, reports, card) -> None:
    """The event phase's ``analytical`` lines: the closed-form estimate of
    both accelerators at full size (paper defaults, WCC), at its default
    iteration count and at the simulated run's, beside the simulated
    runtime of the main path."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import analytical
    estimate = {"hitgraph": analytical.estimate_hitgraph,
                "accugraph": analytical.estimate_accugraph}
    for acc, fn in estimate.items():
        sim = reports[acc]
        t0 = time.perf_counter()
        est = fn(wt, Problem.WCC)
        at_iters = fn(wt, Problem.WCC, iterations=sim.iterations)
        seconds = time.perf_counter() - t0
        for e in (est, at_iters):
            assert np.isfinite(e.runtime_ns) and e.runtime_ns > 0
        emit(phase="analytical", accelerator=acc, problem="wcc",
             estimate_ns=est.runtime_ns, estimate_iterations=est.iterations,
             estimate_at_run_iterations_ns=at_iters.runtime_ns,
             bound=est.bound, bytes_total=est.bytes_total,
             simulated_ns=sim.runtime_ns, iterations=sim.iterations,
             estimate_over_simulated=at_iters.runtime_ns / sim.runtime_ns,
             seconds=seconds, card=card)


def run_study_line(card, dev):
    """The event phase's ``study`` line: ``run_study`` (AccuGraph WCC, the
    five variants, served on the card) at ``STUDY_SCALE`` with the Fig. 13
    partition size; every variant's algorithm values equal the
    baseline's.  Returns the launches by kernel of the study."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import optimizations
    from repro_torch.core.accugraph import AccuGraphConfig
    from repro_torch.graphs.datasets import TABLE1, instantiate
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.policy import scaled_q
    g = instantiate("wt", STUDY_SCALE).undirected_view()
    base = AccuGraphConfig(partition_elements=scaled_q(
        1_024_000, TABLE1["wt"].vertices, g.n))
    zero_launch_counts()
    t0 = time.perf_counter()
    res = optimizations.run_study(g, Problem.WCC, base)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    assert [r.variant for r in res] == ["baseline", "prefetch_skip",
                                        "partition_skip", "both", "hbm"]
    assert launches["dram_serve"] == len(res), launches
    spec = get_accelerator("accugraph")
    runs = {name: spec.run_algorithm(g, Problem.WCC, cfg, device=dev)
            for name, cfg in optimizations.accugraph_variants(base).items()}
    values_equal = all(np.array_equal(run.values, runs["baseline"].values)
                       for run in runs.values())
    emit(phase="study", problem="wcc", scale=STUDY_SCALE, vertices=g.n,
         edges=g.m, partition_elements=base.partition_elements,
         variants=[{"variant": r.variant, "runtime_ns": r.report.runtime_ns,
                    "speedup": r.speedup, "requests": r.report.total_requests,
                    "iterations": r.report.iterations} for r in res],
         values_equal_baseline=values_equal, seconds=seconds,
         budget_s=STUDY_BUDGET_S, within_budget=seconds <= STUDY_BUDGET_S,
         kernel_launches={k: launches[k] for k in KERNELS}, card=card)
    assert values_equal
    for r in res:
        assert np.isfinite(r.report.runtime_ns) and r.speedup > 0
    return launches


def random_program(rng, hit_heavy, n_phases=4, max_n=300):
    from repro_torch.core.trace import SegmentedTrace
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, max_n))
        lines = rng.integers(0, 64 if hit_heavy else 1 << 16, n)
        if hit_heavy:
            lines = np.sort(lines)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return SegmentedTrace.from_phases(phases)


def serve_both(packed, lo, hi, split, state, dev):
    """Kernel (two chained calls split at ``split``) and plain version
    (one call) on steps ``[lo, hi)`` from ``state``; returns the max
    absolute difference over finishes and carry, and the inputs on the
    card (streams, timing)."""
    from repro_torch.kernels.dram_timing.ops import (chunk_steps, dram_serve,
                                                     serve_prepass,
                                                     serve_records)
    from repro_torch.kernels.dram_timing.ref import serve_prepass_ref
    from repro_torch.kernels.dram_timing.ref import dram_serve_ref
    streams = [i32(a[lo:hi], dev) for a in (packed.issue, packed.meta,
                                             packed.boundary)]
    timing = i32(packed.timing, dev)
    k_state, fins = state, []
    for a, b in ((0, split - lo), (split - lo, hi - lo)):
        f, k_state = dram_serve(*(s[a:b].contiguous() for s in streams),
                                timing, k_state)
        fins.append(f)
    fin_k = torch.cat(fins)
    fin_p, p_state = dram_serve_ref(*streams, timing, state)
    torch.cuda.synchronize()
    diff = max([max_abs_diff(fin_k, fin_p)]
               + [max_abs_diff(a, b) for a, b in zip(k_state, p_state)])
    return diff, streams, timing


def check_sweep(dev) -> dict:
    """The round kernel (``sweep_min_block``) and the serial kernel
    (``sweep_min``) against the plain sequential sweep on rmat(12, 4)
    (destination-sorted, self-loops and duplicate edges kept), for add 0
    and 1, from the WCC start values and from a warm start holding
    INF32; the round kernel's rounds beside the synchronous rounds'
    (never more)."""
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels.sweep_min.ops import (pack_sweep_block,
                                                   sweep_min,
                                                   sweep_min_block,
                                                   sweep_min_ref,
                                                   sweep_min_rounds_ref)
    g = rmat(12, 4, seed=9)
    order = np.argsort(g.dst, kind="stable")
    block = pack_sweep_block(g.src[order], g.dst[order], g.n, device=dev)
    worst, cases = 0, []
    for add in (0, 1):
        for start in ("arange", "warm"):
            rng = np.random.default_rng(add)
            x0 = (np.arange(g.n) if start == "arange" else np.where(
                rng.random(g.n) < 0.3, 2**31 - 2**24,
                rng.integers(0, 1000, g.n)))
            vk = i32(x0, dev)
            vs, vp, vr = vk.clone(), vk.clone(), vk.clone()
            res = sweep_min_block(vk, block, add)
            sweep_min(vs, block.src, block.dst, add)
            sweep_min_ref(vp, block.src, block.dst, add)
            rounds = sweep_min_rounds_ref(vr, block, add)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_diff(vk, vp), max_abs_diff(vs, vp),
                        max_abs_diff(vr, vp))
            assert res.route == "rounds" and res.rounds <= rounds, res
            cases.append({"add": add, "start": start, "rounds": res.rounds,
                          "synchronous_rounds": rounds})
    assert worst == 0, f"sweep_min differs from its plain version: {worst}"
    return {"sweep_min_cases": cases, "sweep_min_max_abs_diff": worst}


def sweep_paths(dev, card) -> dict:
    """The sweep's worst case, an ascending path of ``PATH_N`` vertices
    from the WCC start values (every value improves along the whole
    chain: ~n rounds), and a descending path (1 round): the route taken,
    the rounds, and the time of the whole call beside the serial route's
    alone and the round kernel's alone (its budget of rounds on the
    ascending path); the ascending call must cost at most
    ``PATH_SLOWDOWN`` times the serial route.  Both exact against the
    plain sweep."""
    from repro_torch.kernels.sweep_min.ops import (pack_sweep_block,
                                                   round_budget, sweep_min,
                                                   sweep_min_block,
                                                   sweep_min_ref,
                                                   sweep_min_rounds)
    out = {}
    v = np.arange(1, PATH_N)
    for name, (src, dst) in (("ascending", (v - 1, v)),
                             ("descending", (v, v - 1))):
        order = np.argsort(dst, kind="stable")
        block = pack_sweep_block(src[order], dst[order], PATH_N, device=dev)
        x0 = torch.arange(PATH_N, dtype=torch.int32, device=dev)
        got, want = x0.clone(), x0.clone()
        res = sweep_min_block(got, block, 0)
        sweep_min_ref(want, block.src, block.dst, 0)
        assert torch.equal(got, want), f"the {name} path's sweep differs"
        ms = cuda_ms(lambda: sweep_min_block(x0.clone(), block, 0), reps=2)
        serial_ms = cuda_ms(
            lambda: sweep_min(x0.clone(), block.src, block.dst, 0), reps=2)
        vals, status = x0.clone(), torch.zeros(3, dtype=torch.int32,
                                               device=dev)

        def prep():
            vals.copy_(x0)
            status.zero_()

        kernel_ms = launch_ms(prep, lambda: sweep_min_rounds(
            vals, x0, block, 0, round_budget(block), status), reps=2)
        out[name] = {"route": res.route, "rounds": res.rounds,
                     "budget": round_budget(block), "ms": ms,
                     "serial_route_ms": serial_ms,
                     "round_kernel_ms": kernel_ms,
                     "rounds_route_ms": ms - serial_ms
                     if res.route == "serial" else ms,
                     "slowdown_vs_serial": ms / serial_ms}
    emit(phase="sweep_paths", vertices=PATH_N, card=card, **out)
    assert out["descending"]["route"] == "rounds"
    assert out["descending"]["rounds"] == 1
    assert out["ascending"]["slowdown_vs_serial"] <= PATH_SLOWDOWN, out
    return out


def sweep_main_block(wt, sessions, dev, card) -> dict:
    """The AccuGraph main-path block (q = n): the 5 WCC sweeps of the run
    in order, each by ``sweep_min_block`` (its rounds; the round kernel's
    time alone, ``ms``, from a start copy made beforehand, and the whole
    call's, ``call_ms``: the copy of x0, the launch, the status and peak
    read) and held to the serial kernel's result; the first sweep also on
    the serial route and by the plain loop (host clock).  Bound: one
    pass's bytes (the sliced ELL's sources, the row ids, the values read
    and written once), what the function needs; beside it the rounds
    times that (``rounds_bound_ms``), what this design needs."""
    from repro_torch.algorithms.vertex_centric import _block_edges
    from repro_torch.kernels.sweep_min.ops import (pack_sweep_block,
                                                   round_budget, sweep_min,
                                                   sweep_min_block,
                                                   sweep_min_ref,
                                                   sweep_min_rounds)
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.session import resolve_run_config
    accu = get_accelerator("accugraph")
    parts = sessions["accugraph"].model_for(
        accu, resolve_run_config(accu)).parts
    s_np, d_np = _block_edges(parts, 0)
    pack_ms = host_ms(lambda: pack_sweep_block(
        s_np.astype(np.int32), d_np.astype(np.int32), wt.n, device=dev))
    block = pack_sweep_block(s_np.astype(np.int32), d_np.astype(np.int32),
                             wt.n, device=dev)
    a = block.ell
    rows = int((a.slice_rows >= 0).sum()) + a.n_chunks
    pass_bytes = 4 * block.slots + 4 * rows + 8 * wt.n
    values = torch.arange(wt.n, dtype=torch.int32, device=dev)
    budget = round_budget(block)
    sweeps = []
    while True:
        before = values.clone()
        res = sweep_min_block(values, block, 0)
        call_ms = cuda_ms(lambda: sweep_min_block(before.clone(), block, 0),
                          2)
        vals = before.clone()
        status = torch.zeros(3, dtype=torch.int32, device=dev)

        def prep():
            vals.copy_(before)
            status.zero_()

        ms = launch_ms(prep, lambda: sweep_min_rounds(
            vals, before, block, 0, budget, status), reps=2)
        assert torch.equal(vals, values) and int(status[2]) == 1
        serial = before.clone()
        sweep_min(serial, block.src, block.dst, 0)
        diff = max_abs_diff(values, serial)
        assert diff == 0, f"sweep {len(sweeps)} differs from the serial one"
        assert res.route == "rounds", res
        sweeps.append({"rounds": res.rounds, "ms": ms, "call_ms": call_ms,
                       "changed": int((values != before).sum())})
        if torch.equal(values, before):
            break
    assert len(sweeps) == MAIN_EXPECT["accugraph"][0], sweeps
    v0 = torch.arange(wt.n, dtype=torch.int32, device=dev)
    serial_ms = cuda_ms(lambda: sweep_min(v0.clone(), block.src, block.dst,
                                          0), reps=1)
    vp = v0.clone()
    plain_ms = host_ms(lambda: sweep_min_ref(vp, block.src, block.dst, 0))
    vk = v0.clone()
    sweep_min_block(vk, block, 0)
    err = max_abs_diff(vk, vp)
    assert err == 0, "sweep_min differs from its plain version"
    first = sweeps[0]
    emit(phase="main_block", sweeps=sweeps, pack_ms=pack_ms,
         serial_route_ms=serial_ms, plain_ms=plain_ms, card=card)
    return {"max_abs_err": err, "ms": first["ms"],
            "call_ms": first["call_ms"], "rounds": first["rounds"],
            "plain_ms": plain_ms, "serial_route_ms": serial_ms,
            "bound_ms": pass_bytes / HBM_BYTES_PER_S * 1e3,
            "rounds_bound_ms": first["rounds"] * pass_bytes
            / HBM_BYTES_PER_S * 1e3,
            "serial_bound_ms": (8 * block.m + 8 * wt.n)
            / HBM_BYTES_PER_S * 1e3,
            "sweeps": sweeps, "pack_ms": pack_ms,
            "shape": {"edges": block.m, "slots": block.slots,
                      "vertices": wt.n, "slices": a.n_slices,
                      "heavy_chunks": a.n_chunks}}


def any_meta_serve(dev) -> int:
    """``dram_serve`` on blocks the packer never makes (several misses,
    invalid miss lanes, banks past the channel's; 4 channels of 2 ranks,
    K = 8), against its plain version; the pre-pass's records against
    theirs."""
    from repro_torch.core import vectorized as vec
    from repro_torch.core.dram import PRESETS
    from repro_torch.kernels.dram_timing.ops import (chunk_steps, dram_serve,
                                                     serve_prepass)
    from repro_torch.kernels.dram_timing.ref import (dram_serve_ref,
                                                     serve_prepass_ref)
    worst = 0
    for seed in range(3):
        rng = np.random.default_rng(seed)
        S, C, K, B, R = 400, 4, 8, 8, 2
        meta = (rng.integers(0, B + 2, (S, C, K))
                | rng.choice([0, vec.META_MISS], (S, C, K))
                | rng.choice([0, vec.META_CONFL], (S, C, K))
                | rng.choice([0, vec.META_VALID, vec.META_VALID], (S, C, K))
                | (rng.integers(0, K, (S, C, K)) << vec.META_RB_SHIFT))
        args = [i32(a, dev) for a in (
            rng.integers(0, 500, (S, C, K)), meta, rng.random(S) < 0.1,
            vec.timing_params(PRESETS["accugraph"]().timing))]
        state = tuple(vec.init_lean_carry(C, B, B // R, dev)) + (
            torch.zeros(C, dtype=torch.int32, device=dev),)
        fin_k, st_k = dram_serve(*args, state)
        fin_p, st_p = dram_serve_ref(*args, state)
        T = chunk_steps(C, K)
        rec = serve_prepass(*args, B // R, R, T)
        rec_p = serve_prepass_ref(*args, B // R, R, rec.shape[1])
        torch.cuda.synchronize()
        worst = max([worst, max_abs_diff(fin_k, fin_p),
                     max_abs_diff(rec, rec_p)]
                    + [max_abs_diff(a, b) for a, b in zip(st_k, st_p)])
    return worst


def run_sweep_phase(wt, card, dev) -> dict:
    """Phase 10, the sweep engine.  The full-size timing grid (WCC on the
    wiki-talk stand-in, each accelerator's default memory and
    ``SWEEP_KINDS`` timing variants of it: 4 cases an accelerator sharing
    one pack) through ``Sweeper(batch_memories=True)``, counts zeroed
    just before and read just after: one ``dram_serve_batch`` (and its
    pre-pass) an accelerator, no per-case serve; every row held field for
    field to ``run_case`` on the same sweeper (one ``dram_serve`` a case),
    the default rows to the pinned main-path runtimes; the batched serve
    timed (pre-pass apart) beside the four per-case serves and the bound,
    and each case's finishes and carry held to the per-case kernel's
    (case 0 also to the pinned digest).  Then the stacked route at full
    size (:func:`run_stacked_pair`), the stacked path on a small graph
    (AccuGraph on rmat(8, 5) under two DRAM densities) equal to the CPU
    sweep,
    ``Sweeper(workers=2)`` over HitGraph's four full-size cases equal to
    the batched rows, and one ``updates="pa-growth"`` case equal to
    ``run_dynamic`` epoch for epoch.  Returns the launches by sub-path and
    the kernel-table entries."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import accel
    from repro_torch.core import vectorized as vec
    from repro_torch.graphs.datasets import instantiate
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.dram_timing.ops import (chunk_steps, dram_serve,
                                                     dram_serve_batch,
                                                     serve_prepass_batch,
                                                     serve_records_batch)
    from repro_torch.kernels.dram_timing.ref import (dram_serve_batch_ref,
                                                     serve_prepass_batch_ref)
    from repro_torch.sim import (SweepCase, Sweeper, get_accelerator,
                                 run_dynamic, sweep, timing_variants)
    from repro_torch.sim.session import resolve_run_config
    t_phase = time.perf_counter()
    accs = ("hitgraph", "accugraph")
    mems, cases = {}, []
    for acc in accs:
        default = resolve_run_config(get_accelerator(acc)).dram_config()
        mems[acc] = [None] + timing_variants(default, kinds=SWEEP_KINDS)
        cases += [SweepCase(wt, "wcc", accelerator=acc, memory=m)
                  for m in mems[acc]]
    sweeper = Sweeper(batch_memories=True)
    zero_launch_counts()
    accel.zero_pack_route_counts()
    t0 = time.perf_counter()
    rows = sweeper.run(cases)
    seconds = time.perf_counter() - t0
    launches = {"sweep": launch_counts()}
    routes = accel.pack_route_counts()
    stats = dataclasses.asdict(sweeper.stats)
    emit(phase="sweep", grid="timing", cases=len(cases),
         memories={acc: [r.memory for r in rows if r.report.system == acc]
                   for acc in accs},
         stats=stats, pack_routes=routes,
         launches={k: launches["sweep"][k] for k in KERNELS},
         seconds=seconds, card=card)
    assert {k: stats[k] for k in SWEEP_STATS} == SWEEP_STATS, stats
    assert routes == {"device_pack": 2, "host_pack": 0}, routes
    want = {"dram_serve_batch": 2, "serve_prepass_batch": 2,
            "dram_serve": 0, "serve_prepass": 0}
    assert {k: launches["sweep"][k] for k in want} == want, launches
    # every row against the per-case path on the same sessions
    zero_launch_counts()
    t0 = time.perf_counter()
    solo = [sweeper.run_case(c) for c in cases]
    solo_s = time.perf_counter() - t0
    launches["sweep_run_case"] = launch_counts()
    differ = [i for i, (a, b) in enumerate(zip(rows, solo))
              if a.report != b.report or row_fields(a) != row_fields(b)]
    assert not differ, differ
    assert launches["sweep_run_case"]["dram_serve"] == len(cases)
    for r in rows:
        if r.case.memory is None:
            assert r.report.runtime_ns == PINNED_RUNTIME_NS[
                "main", r.report.system], (r.report.system,
                                           r.report.runtime_ns)
    for r in rows:
        emit(phase="sweep_row", **{k: v for k, v in r.as_dict().items()
                                   if k != "wall_s"},
             runtime_ns=r.report.runtime_ns, equal_run_case=True)
    # the batched serve timed on the cached packs, against the per-case
    # serves and the bound; each case's output against the per-case kernel
    sess = sweeper._session(wt)
    serve, window = {}, None
    for acc in accs:
        spec = get_accelerator(acc)
        cfg = resolve_run_config(spec)
        packed, _ = sess.packed_program_for(
            spec, Problem.WCC, cfg, sess.model_for(spec, cfg),
            sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev),
            cfg.dram_config(), device=dev)
        S, C, K = packed.issue.shape
        B, bpr = packed.n_banks, packed.banks_per_rank
        R = B // bpr
        timing = i32(np.stack([vec.timing_params(
            (m or cfg.dram_config()).timing) for m in mems[acc]]), dev)
        M = timing.shape[0]
        streams = [packed.issue, packed.meta,
                   packed.boundary.to(torch.int32)]
        state = vec._cold_batch_state(M, C, B, bpr, dev)
        (fin, st), batch_ms = timed_call(
            lambda: dram_serve_batch(*streams, timing, state))
        T = chunk_steps(C, K)
        rec = serve_prepass_batch(*streams, timing, bpr, R, T)
        prepass_ms = cuda_ms(
            lambda: serve_prepass_batch(*streams, timing, bpr, R, T), reps=3)
        _, records_ms = timed_call(
            lambda: serve_records_batch(rec, timing, state, S))
        del rec
        cold = cold_state(packed, C, dev)
        per_case_ms, same = [], []
        for m in range(M):
            (f1, s1), ms = timed_call(
                lambda: dram_serve(*streams, timing[m], cold))
            per_case_ms.append(ms)
            same.append(serve_digest(fin[m], [x[m] for x in st])
                        == serve_digest(f1, s1))
            del f1
        digest0 = serve_digest(fin[0], [x[0] for x in st])
        assert all(same), (acc, same)
        assert digest0 == PINNED_SERVE_DIGEST[acc], (acc, digest0)
        serve[acc] = {
            "M": M, "programs": "shared", "shape": [S, C, K],
            "ms": batch_ms, "prepass_ms": prepass_ms,
            "records_ms": records_ms, "per_case_ms": per_case_ms,
            "per_case_sum_ms": sum(per_case_ms),
            "bound_ms": serve_bytes(S, C, K, B, R, M)
            / HBM_BYTES_PER_S * 1e3,
            "per_case_bound_sum_ms": M * serve_bytes(S, C, K, B, R)
            / HBM_BYTES_PER_S * 1e3,
            "prepass_bound_ms": prepass_bytes(S, C, K, T, M)
            / HBM_BYTES_PER_S * 1e3,
            "cases_equal_per_case_kernel": all(same),
            "case0_digest_pinned": True}
        emit(phase="sweep_serve", accelerator=acc, **serve[acc], card=card)
        if acc == "hitgraph":
            # a window crossing the first phase boundary, all M cases from
            # cold carries, kernel against the plain version on the card
            lo = max(0, int(np.flatnonzero(
                packed.boundary.cpu().numpy())[0]) - SWEEP_WINDOW // 2)
            win = [x[lo:lo + SWEEP_WINDOW].contiguous() for x in streams]
            fin_k, st_k = dram_serve_batch(*win, timing, state)
            t0 = time.perf_counter()
            fin_p, st_p = dram_serve_batch_ref(*win, timing, state)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            diff = max([max_abs_diff(fin_k, fin_p)]
                       + [max_abs_diff(a, b) for a, b in zip(st_k, st_p)])
            assert diff == 0, "dram_serve_batch differs on the window"
            wrec = serve_prepass_batch(*win, timing, bpr, R, T)
            wrec_p = serve_prepass_batch_ref(*win, timing, bpr, R,
                                             wrec.shape[2])
            diff = max(diff, max_abs_diff(wrec, wrec_p))
            assert diff == 0, "serve_prepass_batch differs on the window"
            window = {
                "steps": SWEEP_WINDOW, "M": M, "shape": [SWEEP_WINDOW, C, K],
                "max_abs_err": diff,
                "ms": cuda_ms(lambda: dram_serve_batch(*win, timing, state),
                              reps=5),
                "plain_ms": plain_ms,
                "bound_ms": serve_bytes(SWEEP_WINDOW, C, K, B, R, M)
                / HBM_BYTES_PER_S * 1e3,
                "prepass_ms": cuda_ms(lambda: serve_prepass_batch(
                    *win, timing, bpr, R, T), reps=5),
                "prepass_plain_ms": cuda_ms(lambda: serve_prepass_batch_ref(
                    *win, timing, bpr, R, wrec.shape[2]), reps=3),
                "prepass_bound_ms": prepass_bytes(SWEEP_WINDOW, C, K, T, M)
                / HBM_BYTES_PER_S * 1e3}
            del wrec, wrec_p, win
        del fin, st, streams
    serve["hitgraph_stacked"] = run_stacked_pair(sweeper, wt, launches, dev,
                                                 card)
    # the stacked path on a small graph: two densities pack apart (same
    # shape), rows equal to the CPU sweep
    small = rmat(8, 5, seed=7).undirected_view()
    kw = dict(graphs=[small], problems=["wcc"], accelerators=["accugraph"],
              memories=[None, "ddr4-8gb"], batch_memories=True)
    zero_launch_counts()
    stacked = sweep(**kw)
    launches["sweep_stacked"] = launch_counts()
    on_cpu = sweep(device="cpu", **kw)
    assert [r.report for r in stacked] == [r.report for r in on_cpu]
    assert launches["sweep_stacked"]["dram_serve_batch"] == 1
    # workers=2 over HitGraph's four full-size cases (the per-case path)
    zero_launch_counts()
    t0 = time.perf_counter()
    w2 = Sweeper(workers=2).run(cases[:len(mems["hitgraph"])])
    w2_s = time.perf_counter() - t0
    launches["sweep_workers2"] = launch_counts()
    assert [r.report for r in w2] == [r.report for r in rows[:len(w2)]]
    assert launches["sweep_workers2"]["dram_serve"] == len(w2)
    # one dynamic case against run_dynamic
    g01 = instantiate("wt", SWEEP_DYNAMIC_SCALE).undirected_view()
    zero_launch_counts()
    t0 = time.perf_counter()
    dyn_row = sweep(cases=[SweepCase(g01, "wcc", accelerator="accugraph",
                                     updates="pa-growth")])[0]
    dyn_s = time.perf_counter() - t0
    launches["sweep_dynamic"] = launch_counts()
    ref = run_dynamic(g01, "wcc", updates="pa-growth",
                      accelerator="accugraph")
    assert dyn_row.epochs == ref.epochs and dyn_row.report == ref.report
    phase_s = time.perf_counter() - t_phase
    emit(phase="sweep_paths", stacked_rows=len(stacked),
         stacked_equal_cpu=True,
         stacked_launches=launches["sweep_stacked"]["dram_serve_batch"],
         workers2_rows=len(w2), workers2_equal_batched=True,
         workers2_seconds=w2_s,
         workers2_launches=launches["sweep_workers2"]["dram_serve"],
         dynamic_scale=SWEEP_DYNAMIC_SCALE, dynamic_vertices=g01.n,
         dynamic_edges=g01.m, dynamic_epochs=len(dyn_row.epochs),
         dynamic_equal_run_dynamic=True, dynamic_seconds=dyn_s,
         run_case_seconds=solo_s, phase_seconds=phase_s, card=card)
    return {"launches": launches, "serve": serve, "window": window,
            "seconds": phase_s, "sweeper": sweeper, "cases": cases,
            "rows": rows, "memories": mems}


def hitgraph_default_memory():
    """HitGraph's default memory, the base of phase 10's timing variants."""
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.session import resolve_run_config
    return resolve_run_config(get_accelerator("hitgraph")).dram_config()


def stacked_pair_memories():
    """HitGraph's default memory (DDR3-1600K) and DDR3-1333H, the same
    structure at 2/3 GHz with ``TIMING_PRESETS["ddr3-1333"]``: two packs of
    one shape (the pack key holds the clock)."""
    from repro_torch.sim.memory import TIMING_PRESETS
    default = hitgraph_default_memory()
    slower = dataclasses.replace(default, clock_ghz=2 / 3,
                                 timing=TIMING_PRESETS["ddr3-1333"],
                                 name=f"{default.name}@ddr3-1333")
    return default, slower


def run_stacked_pair(sweeper, wt, launches, dev, card) -> dict:
    """The stacked route of the batched serve at full size: HitGraph WCC
    on the wiki-talk stand-in under its default memory (DDR3-1600K) and
    DDR3-1333H (the same structure at 2/3 GHz with ``TIMING_PRESETS
    ["ddr3-1333"]``), which pack apart (the pack key holds the clock) into
    programs of one shape with different issue cycles.  One
    ``sweeper.run`` serves both in one ``dram_serve_batch`` launch on the
    stacked programs; each row is held field for field to ``run_case``,
    each case's finishes and carry to the per-case kernel's (case 0's to
    the pinned digest); the batched serve is timed beside the two
    per-case serves and the bound of its own bytes (each program read
    once)."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import vectorized as vec
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.kernels.dram_timing.ops import (chunk_steps, dram_serve,
                                                     dram_serve_batch,
                                                     serve_prepass_batch)
    from repro_torch.sim import SweepCase, get_accelerator
    from repro_torch.sim.session import resolve_run_config
    spec = get_accelerator("hitgraph")
    default, slower = stacked_pair_memories()
    pair = [SweepCase(wt, "wcc", accelerator="hitgraph", memory=m)
            for m in (None, slower)]
    zero_launch_counts()
    t0 = time.perf_counter()
    rows = sweeper.run(pair)
    seconds = time.perf_counter() - t0
    launches["sweep_stacked_full"] = launch_counts()
    want = {"dram_serve_batch": 1, "serve_prepass_batch": 1,
            "dram_serve": 0, "serve_prepass": 0}
    assert {k: launches["sweep_stacked_full"][k] for k in want} == want, (
        launches["sweep_stacked_full"])
    solo = [sweeper.run_case(c) for c in pair]
    differ = [i for i, (a, b) in enumerate(zip(rows, solo))
              if a.report != b.report or row_fields(a) != row_fields(b)]
    assert not differ, differ
    assert rows[0].report.runtime_ns == PINNED_RUNTIME_NS["main", "hitgraph"]
    sess = sweeper._session(wt)
    packs = []
    for m in (default, slower):
        cfg = resolve_run_config(spec, memory=m)
        packed, _ = sess.packed_program_for(
            spec, Problem.WCC, cfg, sess.model_for(spec, cfg),
            sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev),
            cfg.dram_config(), device=dev)
        packs.append(packed)
    assert packs[0] is not packs[1]
    assert packs[0].signature == packs[1].signature, (
        packs[0].signature, packs[1].signature)
    assert not torch.equal(packs[0].issue, packs[1].issue)
    S, C, K = packs[0].issue.shape
    B, bpr = packs[0].n_banks, packs[0].banks_per_rank
    R = B // bpr
    M = len(packs)
    streams = [torch.stack([vec.as_int32(getattr(p, f), dev) for p in packs])
               for f in ("issue", "meta", "boundary")]
    timing = i32(np.stack([vec.timing_params(m.timing)
                           for m in (default, slower)]), dev)
    state = vec._cold_batch_state(M, C, B, bpr, dev)
    (fin, st), batch_ms = timed_call(
        lambda: dram_serve_batch(*streams, timing, state))
    T = chunk_steps(C, K)
    prepass_ms = cuda_ms(
        lambda: serve_prepass_batch(*streams, timing, bpr, R, T), reps=3)
    cold = cold_state(packs[0], C, dev)
    per_case_ms, same = [], []
    for m in range(M):
        one = [x[m] for x in streams]
        (f1, s1), ms = timed_call(lambda: dram_serve(*one, timing[m], cold))
        per_case_ms.append(ms)
        same.append(serve_digest(fin[m], [x[m] for x in st])
                    == serve_digest(f1, s1))
        del f1, one
    assert all(same), same
    digest0 = serve_digest(fin[0], [x[0] for x in st])
    assert digest0 == PINNED_SERVE_DIGEST["hitgraph"], digest0
    out = {
        "M": M, "programs": "stacked", "shape": [S, C, K],
        "memories": [r.memory for r in rows],
        "runtime_ns": [r.report.runtime_ns for r in rows],
        "sweep_seconds": seconds, "ms": batch_ms, "prepass_ms": prepass_ms,
        "per_case_ms": per_case_ms, "per_case_sum_ms": sum(per_case_ms),
        "bound_ms": serve_bytes(S, C, K, B, R, M, shared=False)
        / HBM_BYTES_PER_S * 1e3,
        "prepass_bound_ms": prepass_bytes(S, C, K, T, M, shared=False)
        / HBM_BYTES_PER_S * 1e3,
        "rows_equal_run_case": True, "cases_equal_per_case_kernel": True,
        "case0_digest_pinned": True}
    emit(phase="sweep_serve", accelerator="hitgraph", **out, card=card)
    del fin, st, streams
    return out


def fields_digest(obj) -> str:
    """SHA-256 (16 hex digits) of every compared field of a report
    dataclass (``SimReport``, ``EpochReport``; nested ones and lists of
    them included): equal digests mean equal reports, in either package."""
    def canon(v):
        if dataclasses.is_dataclass(v):
            return {f.name: canon(getattr(v, f.name))
                    for f in dataclasses.fields(v) if f.compare}
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        if isinstance(v, np.generic):
            v = v.item()
        if v is None or isinstance(v, (bool, str, int, float)):
            return v
        raise TypeError(f"no canonical form for {type(v).__name__}")
    text = json.dumps(canon(obj), sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def report_pin(r) -> tuple:
    """(runtime_ns, total_requests, iterations, row hits, cache lookups,
    cache hits, digest of every field) of a ``SimReport``."""
    return (float(r.runtime_ns), int(r.total_requests), int(r.iterations),
            int(sum(p.row_hits for p in r.phases)), int(r.cache_lookups),
            int(r.cache_hits), fields_digest(r))


def epoch_pin(e) -> tuple:
    """(epoch, iterations, inserted, deleted, lines invalidated,
    runtime_ns, total_requests, digest of every field) of an
    ``EpochReport``."""
    return (int(e.epoch), int(e.iterations), int(e.inserted),
            int(e.deleted), int(e.cache_lines_invalidated),
            float(e.report.runtime_ns), int(e.report.total_requests),
            fields_digest(e))


def graph_pin(g) -> tuple:
    return (g.name, int(g.n), int(g.m), g.fingerprint)


def corpus_runs(sim, on_part=None, scale=1.0, **kw) -> dict:
    """Phase 11's runs through the simulation API ``sim``: the port's
    ``repro_torch.sim`` here (``kw`` is ``device=``), the JAX package's
    ``repro.sim`` in ``tools/corpus_pins.py``, which makes this phase's
    pins from the same calls.  ``on_part(name)`` is called after each
    part; ``scale`` is the graphs' ``graph_scale`` (the phase runs 1.0,
    each preset's own size; the CPU tests a cut one).  The grid and the BRAM cases share ``Sweeper(workers=2)``, as
    ``benchmarks/corpus_sweep.py`` does; the ordering arms are graphs of
    their own and go through a batched sweeper (one ``dram_serve_batch``
    a signature group)."""
    clock = time.perf_counter
    out = {"seconds": {}, "stats": {}}

    def part(name, t0, sweeper=None):
        out["seconds"][name] = clock() - t0
        if sweeper is not None:
            out["stats"][name] = {k: getattr(sweeper.stats, k)
                                  for k in CORPUS_STAT_KEYS}
        if on_part is not None:
            on_part(name)

    sweeper = sim.Sweeper(workers=2, **kw)
    t0 = clock()
    out["grid"] = sim.sweep(graphs=CORPUS, problems=CORPUS_PROBLEMS,
                            accelerators=CORPUS_ACCELERATORS,
                            memories=CORPUS_MEMORIES, fixed_iters=None,
                            graph_scale=scale, sweeper=sweeper)
    part("grid", t0, sweeper)
    batched = sim.Sweeper(workers=2, batch_memories=True, **kw)
    t0 = clock()
    out["ordering"] = sim.sweep(graphs=CORPUS_ORDERINGS, problems=("wcc",),
                                accelerators=CORPUS_ACCELERATORS,
                                graph_scale=scale, sweeper=batched)
    part("ordering", t0, batched)
    t0 = clock()
    out["bram"] = sim.sweep(graphs=CORPUS, problems=("wcc",),
                            accelerators=("accugraph",),
                            caches=(None, "default"), graph_scale=scale,
                            sweeper=sweeper)
    part("bram", t0, sweeper)
    t0 = clock()
    spec = sim.ScenarioSpec(**CORPUS_SPEC, graph_scale=scale)
    out["spec"] = sim.simulate(spec, **kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["spec_keywords"] = sim.simulate(
            sim.resolve_graph(spec.resolved_graph(), scale=scale),
            spec.problem, accelerator=spec.accelerator, memory=spec.memory,
            cache=spec.cache, **kw)
    out["spec_warnings"] = [str(w.message) for w in caught
                            if issubclass(w.category, DeprecationWarning)]
    out["dynamic_spec"] = sim.simulate(
        sim.ScenarioSpec(**CORPUS_DYNAMIC, graph_scale=scale), **kw)
    axes = dict(CORPUS_DYNAMIC)
    out["dynamic"] = sim.run_dynamic(axes.pop("graph"), axes.pop("problem"),
                                     **axes, graph_scale=scale, **kw)
    part("scenario", t0)
    out["graphs"] = {sel: sim.resolve_graph(sel, scale=scale)
                     for sel in CORPUS + CORPUS_ORDERINGS}
    return out


def corpus_keyed(out) -> dict:
    """Every pinned row of :func:`corpus_runs` by (selector, problem,
    accelerator, memory, cache); the BRAM part's uncached rows are the
    grid's and are held to them instead."""
    by_fp = {g.fingerprint: sel for sel, g in out["graphs"].items()}
    rows = {}
    for r in out["grid"] + out["ordering"] + [
            r for r in out["bram"] if r.cache != "none"]:
        key = (by_fp[r.case.graph.fingerprint], r.case.problem.value,
               r.report.system, r.memory, r.cache)
        assert key not in rows, key
        rows[key] = r
    return rows


def corpus_contracts(rows) -> dict:
    """The directions ``benchmarks/corpus_sweep.py`` asserts, each True or
    False, on the keyed rows of :func:`corpus_keyed`."""
    out = {}
    for acc in CORPUS_ACCELERATORS:
        shuf = rows["powerlaw-social:shuffle", "wcc", acc, "default",
                    "none"].report
        for arm in ("powerlaw-social:degree", "powerlaw-social:bfs"):
            loc = rows[arm, "wcc", acc, "default", "none"].report
            out[f"{arm} runtime <= shuffle, {acc}"] = bool(
                loc.runtime_ms <= shuf.runtime_ms * 1.0001)
            out[f"{arm} requests <= shuffle, {acc}"] = bool(
                loc.total_requests <= shuf.total_requests)
        rb = rows["road-grid:bfs", "wcc", acc, "default", "none"].report
        rs = rows["road-grid:shuffle", "wcc", acc, "default", "none"].report
        out[f"road-grid bfs runtime != shuffle, {acc}"] = bool(
            abs(rb.runtime_ms - rs.runtime_ms) > 1e-9)
    for sel in CORPUS:
        bram = rows[sel, "wcc", "accugraph", "default", "default"].report
        plain = rows[sel, "wcc", "accugraph", "default", "none"].report
        out[f"{sel} bram lookups > 0"] = bram.cache_lookups > 0
        out[f"{sel} bram hit rate > 0"] = bram.cache_hit_rate > 0
        out[f"{sel} bram runtime <= uncached"] = bool(
            bram.runtime_ms <= plain.runtime_ms * 1.0001)
    return out


def run_corpus_phase(card, dev) -> dict:
    """Phase 11, the corpus.  A fresh, empty store directory; every preset
    built here by the port's generators and parsers; the four parts of
    :func:`corpus_runs` on the card, with the kernel launch counts zeroed
    just before and read after each part.  Every graph's fingerprint,
    every row and report, every epoch, the sweepers' counters and the
    deprecation warning are held to the JAX package's pins, the
    contracts to the directions its pins give (each asserted where they
    hold), the uncached BRAM rows to the grid's, the ScenarioSpec form to
    the keyword form and the dynamic spec to ``run_dynamic``.  Returns the
    launches by part."""
    import os
    import tempfile
    from repro_torch import sim
    from repro_torch.graphs import corpus
    from repro_torch.kernels import launch_counts, zero_launch_counts
    t_phase = time.perf_counter()
    launches = {}

    def on_part(name):
        launches[name] = launch_counts()
        zero_launch_counts()

    with tempfile.TemporaryDirectory(prefix="corpus-store-") as tmp:
        os.environ["REPRO_GRAPH_CACHE_DIR"] = tmp
        os.environ["REPRO_GRAPH_CACHE"] = "1"
        store = corpus.default_store()
        assert store.root == Path(tmp) and not any(store.root.iterdir()), (
            "the corpus store was opened before phase 11")
        zero_launch_counts()
        out = corpus_runs(sim, on_part=on_part, device=dev)
        stored = sorted(f.name for f in store.root.iterdir())
    seconds = time.perf_counter() - t_phase
    graphs = {sel: graph_pin(g) for sel, g in out["graphs"].items()}
    assert graphs == CORPUS_GRAPHS, graphs
    assert len({g.fingerprint for sel, g in out["graphs"].items()
                if sel in CORPUS}) == len(CORPUS)
    rows = corpus_keyed(out)
    got = {k: report_pin(r.report) for k, r in rows.items()}
    assert len(out["grid"]) == 48 and len(out["ordering"]) == 10
    assert len(got) == len(CORPUS_PINS) == 64, len(got)
    differ = sorted(k for k in CORPUS_PINS if got.get(k) != CORPUS_PINS[k])
    assert not differ, [(k, got.get(k), CORPUS_PINS[k]) for k in differ]
    for r in out["bram"]:
        if r.cache == "none":
            twin = rows[r.graph_name, "wcc", "accugraph", "default", "none"]
            assert r.report == twin.report, r.graph_name
    assert out["stats"] == CORPUS_STATS, out["stats"]
    contracts = corpus_contracts(rows)
    assert contracts == CORPUS_CONTRACTS, contracts
    held = sorted(k for k, v in contracts.items() if v)
    # the scenario form
    assert out["spec"] == out["spec_keywords"]
    assert report_pin(out["spec"]) == CORPUS_SPEC_PIN, report_pin(
        out["spec"])
    assert out["spec_warnings"] == CORPUS_SPEC_WARNINGS, out[
        "spec_warnings"]
    dyn = out["dynamic"]
    assert out["dynamic_spec"] == dyn.report
    assert report_pin(dyn.report) == CORPUS_DYNAMIC_PIN, report_pin(
        dyn.report)
    epochs = [epoch_pin(e) for e in dyn.epochs]
    assert epochs == CORPUS_EPOCH_PINS, epochs
    # the store: one build and one file a preset; each ordering arm is
    # resolved once (the memo is keyed by transform) and reads its base
    # preset's file
    builds_hits = {"builds": store.builds, "hits": store.hits,
                   "files": len(stored)}
    assert builds_hits == {"builds": len(CORPUS), "files": len(CORPUS),
                           "hits": len(CORPUS_ORDERINGS)}, builds_hits
    total = {k: sum(c[k] for c in launches.values()) for k in KERNELS}
    missing = [k for k in CORPUS_KERNELS if total[k] == 0]
    assert not missing, f"never launched in phase 11: {missing}"
    split = {}
    for name in ("grid", "ordering", "bram"):
        st = [r.report.stage_seconds for r in out[name]]
        split[name] = {"prepare_s": sum(x["prepare"] for x in st),
                       "serve_s": sum(x["serve"] for x in st),
                       "wall_s": out["seconds"][name]}
    emit(phase="corpus", seconds=seconds, part_seconds=out["seconds"],
         stats=out["stats"], store=builds_hits,
         launches={name: {k: c[k] for k in KERNELS if c[k]}
                   for name, c in launches.items()},
         host_serve_split=split, rows_pinned=len(got),
         graphs={sel: list(v[:3]) for sel, v in graphs.items()},
         contracts_held=len(held), contracts_left_out=sorted(
             k for k, v in contracts.items() if not v), card=card)
    emit(phase="corpus_scenario",
         spec=dict(zip(("runtime_ns", "total_requests", "iterations",
                        "row_hits", "cache_lookups", "cache_hits"),
                       report_pin(out["spec"])[:6])),
         keyword_form_equal=True, deprecation_warnings=len(
             out["spec_warnings"]),
         dynamic_runtime_ns=dyn.report.runtime_ns, epochs=len(epochs),
         dynamic_spec_equals_run_dynamic=True)
    return {"launches": launches, "seconds": seconds}


def service_workload(pkg: str, scale: float) -> list:
    """``benchmarks/service_load.py``'s ``_workload`` through package
    ``pkg`` (``"repro_torch"`` or ``"repro"``): one one-case batch a job,
    job ``i`` on ``SERVICE_ABBRS[i % 2]``'s stand-in (undirected) with its
    comparability config (HitGraph, 1 PE, 16 pipelines, ``q`` scaled from
    1,024,000, one 8 Gb DDR4-2400R channel in the contiguous order),
    problem PR/BFS/WCC by ``i % 3``, root ``i % 4``, ``fixed_iters`` 2 +
    ``i % 3``."""
    import importlib
    datasets = importlib.import_module(f"{pkg}.graphs.datasets")
    dram = importlib.import_module(f"{pkg}.core.dram")
    hitgraph = importlib.import_module(f"{pkg}.core.hitgraph")
    policy = importlib.import_module(f"{pkg}.sim.policy")
    sweep_mod = importlib.import_module(f"{pkg}.sim.sweep")
    graphs, cfgs = [], []
    for abbr in SERVICE_ABBRS:
        g = datasets.instantiate(abbr, scale=scale)
        q = policy.scaled_q(1_024_000, datasets.TABLE1[abbr].vertices, g.n,
                            floor=256)
        mem = dataclasses.replace(dram.ddr4_2400r(channels=1, density="8Gb"),
                                  order=dram.CONTIGUOUS_ORDER)
        graphs.append(g.undirected_view())
        cfgs.append(hitgraph.HitGraphConfig(n_pes=1, pipelines=16,
                                            partition_elements=q, dram=mem))
    return [[sweep_mod.SweepCase(
        graph=graphs[i % 2], problem=("pr", "bfs", "wcc")[i % 3],
        accelerator="hitgraph", config=cfgs[i % 2], root=i % 4,
        fixed_iters=2 + i % 3)]
        for i in range(SERVICE_CLIENTS * SERVICE_JOBS_PER_CLIENT)]


def service_drive(svc, batches, engine, key_of) -> dict:
    """``benchmarks/service_load.py``'s ``_drive``: SERVICE_CLIENTS
    concurrent clients, each submitting its share of ``batches`` one job
    at a time (tenant per client, a 60 s deadline on every third job) and
    blocking on the result.  Returns the outcomes, latencies and every
    row returned, by ``key_of(case)``."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    lock = threading.Lock()
    latencies, rows = [], {}
    outcomes = {"done": 0, "failed": 0, "cancelled": 0, "expired": 0,
                "shed": 0}

    def client(idx):
        for n, cases in enumerate(batches[idx::SERVICE_CLIENTS]):
            deadline = None if (idx + n) % 3 else 60.0
            t0 = time.perf_counter()
            try:
                job = svc.submit(cases, tenant=f"tenant-{idx}",
                                 deadline=deadline)
            except engine.AdmissionError:
                with lock:
                    outcomes["shed"] += 1
                continue
            try:
                got, outcome = svc.result(job, timeout=240), "done"
            except engine.ServiceError as e:
                got, outcome = e.rows, svc.poll(job)
            dt = time.perf_counter() - t0
            with lock:
                outcomes[outcome] += 1
                latencies.append(dt)
                rows.update((key_of(r.case), r) for r in got)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVICE_CLIENTS) as pool:
        list(pool.map(client, range(SERVICE_CLIENTS)))
    wall = time.perf_counter() - t0
    latencies.sort()

    def pct(p):
        return latencies[min(len(latencies) - 1, int(p * len(latencies)))]

    return {"wall_s": wall, "jobs": len(latencies), "rows": rows,
            "cases_per_sec": len(rows) / wall,
            "latency_p50_ms": pct(0.50) * 1e3,
            "latency_p99_ms": pct(0.99) * 1e3, **outcomes}


def service_runs(pkg: str, scale: float = SERVICE_SCALE,
                 preset_scale: float = 1.0, parts=SERVICE_PARTS,
                 on_part=None, **kw) -> dict:
    """Phase 12's runs through package ``pkg``: ``"repro_torch"`` here
    (``kw`` is ``device=``), ``"repro"`` in ``tools/service_pins.py``,
    which makes this phase's pins from the same calls.  ``parts`` picks
    among SERVICE_PARTS, run in that order on one resident service (the
    clean one; the faulted part opens its own, as the benchmark does);
    ``on_part(name)`` is called after each, and after the resident
    part's ``run_dynamic`` of the same spec ("resident_reference"), which
    runs outside the resident graph's window.  ``scale`` is the stand-ins'
    scale, ``preset_scale`` the resident and tuner presets'
    ``graph_scale`` (the phase runs 1.0; the CPU tests cut both)."""
    import importlib
    engine = importlib.import_module(f"{pkg}.serve.engine")
    chaos = importlib.import_module(f"{pkg}.serve.chaos")
    sim = importlib.import_module(f"{pkg}.sim")
    tune = importlib.import_module(f"{pkg}.tune")
    key_of = importlib.import_module(f"{pkg}.sim.sweep").case_chaos_key
    clock = time.perf_counter
    out = {"seconds": {}}

    def part(name, t0):
        out["seconds"][name] = clock() - t0
        if on_part is not None:
            on_part(name)

    batches = service_workload(pkg, scale)
    out["graphs"] = {abbr: batches[i][0].graph
                     for i, abbr in enumerate(SERVICE_ABBRS)}
    out["keys"] = [key_of(b[0]) for b in batches]
    fault_cfg = chaos.ChaosConfig(seed=SERVICE_FAULT_SEED, sites={
        site: chaos.SiteConfig(rate=rate, max_attempts=attempts,
                               crash=crash)
        for site, (rate, attempts, crash) in SERVICE_FAULT_MIX.items()})
    out["plans"] = {k: tuple(chaos.plan(site, k, fault_cfg)
                             for site in SERVICE_FAULT_MIX)
                    for k in out["keys"]}
    retry = engine.RetryPolicy(retries=8, backoff_base_s=0.002,
                               backoff_cap_s=0.05)
    admission = engine.AdmissionConfig(
        max_tenant_jobs=SERVICE_JOBS_PER_CLIENT + 1)
    # an explicitly empty model: the service arms REPRO_CHAOS_SITES at
    # start when no model is active, and the clean service stays clean
    with chaos.scope(chaos.ChaosConfig(seed=0, sites={})):
        svc = engine.SimService(workers=SERVICE_WORKERS, retry=retry,
                                admission=admission, **kw)
    try:
        if "clean" in parts:
            t0 = clock()
            with chaos.scope(chaos.ChaosConfig(seed=0, sites={})):
                out["warm"] = svc.result(svc.submit(batches[0]),
                                         timeout=600)[0]
                out["clean"] = service_drive(svc, batches, engine, key_of)
            out["clean"]["stats"] = dict(vars(svc.service_stats))
            part("clean", t0)
        if "faulted" in parts:
            t0 = clock()
            with chaos.scope(fault_cfg):
                with engine.SimService(
                        workers=SERVICE_WORKERS, retry=retry,
                        admission=admission,
                        breaker=engine.BreakerConfig(threshold=50),
                        **kw) as fsvc:
                    out["faulted"] = service_drive(fsvc, batches, engine,
                                                   key_of)
                    out["faulted"]["stats"] = dict(vars(fsvc.service_stats))
                    out["faulted"]["injected"] = chaos.injected_log()
            part("faulted", t0)
        if "resident" in parts:
            t0 = clock()
            spec = sim.ScenarioSpec(**SERVICE_RESIDENT,
                                    graph_scale=preset_scale)
            rid = svc.open_graph(spec, tenant="resident")
            eps = [svc.result(svc.graph_job(rid), timeout=1200)]
            # each epoch pinned as it comes back: epoch 0's report shares
            # the timeline's phase list, which later epochs extend (a
            # quirk of the JAX package, copied)
            pins = [epoch_pin(eps[0])]
            for _ in range(SERVICE_UPDATES):
                eps.append(svc.result(svc.submit_update(rid), timeout=1200))
                pins.append(epoch_pin(eps[-1]))
            out["resident"] = {"epochs": eps, "pins": pins,
                               "info": svc.graph_info(rid)}
            svc.close_graph(rid)
            part("resident", t0)
            # what the epochs are held to, in a window of its own: its
            # launches are not the resident graph's
            t0 = clock()
            axes = dict(SERVICE_RESIDENT)
            out["resident"]["run_dynamic"] = sim.run_dynamic(
                axes.pop("graph"), axes.pop("problem"), **axes,
                graph_scale=preset_scale, **kw)
            part("resident_reference", t0)
        if "tuner" in parts:
            t0 = clock()
            space = sim.get_accelerator("hitgraph").design_space().restrict(
                **TUNE_SPACE)
            budget = tune.HalvingBudget(**TUNE_BUDGET)
            g = sim.resolve_graph(TUNE_GRAPH, scale=preset_scale)
            tuned = {"searches": {}, "stats": {}}
            for workers in (SERVICE_WORKERS, 1):
                sweeper = sim.Sweeper(workers=workers, batch_memories=True,
                                      **kw)
                name = f"workers={workers}"
                tuned["searches"][name] = tune.SearchDriver(
                    space, seed=TUNE_SEED, budget=budget,
                    sweeper=sweeper).search(g, TUNE_PROBLEM)
                tuned["stats"][name] = {k: getattr(sweeper.stats, k)
                                        for k in CORPUS_STAT_KEYS}
            sweeper = sim.Sweeper(workers=SERVICE_WORKERS,
                                  batch_memories=True, **kw)
            points = space.enumerate()
            rows = sweeper.run([p.to_case(g, TUNE_PROBLEM,
                                          fixed_iters=budget.rungs[-1])
                                for p in points])
            tuned["exhaustive"] = {p.key: r for p, r in zip(points, rows)}
            tuned["vectors"] = {p.key: tuple(tune.objectives_of(r))
                                for p, r in zip(points, rows)}
            tuned["stats"]["exhaustive"] = {
                k: getattr(sweeper.stats, k) for k in CORPUS_STAT_KEYS}
            sid = svc.submit_search(space, budget, graph=g,
                                    problem=TUNE_PROBLEM, seed=TUNE_SEED)
            tuned["searches"]["service"] = svc.search_result(sid,
                                                             timeout=1800)
            out["tuner"] = tuned
            part("tuner", t0)
    finally:
        svc.close()
    return out


def search_pin(res) -> dict:
    """The front (keys, objective vectors), the rung reports and the
    search's counters but its wall time, of a ``SearchResult``."""
    stats = dataclasses.asdict(res.stats)
    stats.pop("wall_s")
    return {"front": [(e.key, tuple(e.objectives)) for e in res.front],
            "rungs": [dataclasses.asdict(r) for r in res.rungs],
            "stats": stats}


def service_pin_values(out) -> dict:
    """The pin constants phase 12 holds the card to, by name, from one
    :func:`service_runs` (what ``tools/service_pins.py`` writes)."""
    pins = {"SERVICE_GRAPHS": {a: graph_pin(g)
                               for a, g in out["graphs"].items()},
            "SERVICE_PLANS": out["plans"]}
    if "clean" in out:
        rows = out["clean"]["rows"]
        pins["SERVICE_PINS"] = {k: report_pin(rows[k].report)
                                for k in sorted(rows)}
    if "resident" in out:
        pins["SERVICE_EPOCH_PINS"] = out["resident"]["pins"]
    if "tuner" in out:
        t = out["tuner"]
        pins["TUNE_SEARCH"] = search_pin(t["searches"][
            f"workers={SERVICE_WORKERS}"])
        pins["TUNE_EXHAUSTIVE"] = t["vectors"]
        pins["TUNE_SWEEP_STATS"] = t["stats"]
    return pins


def service_injections(plans) -> list:
    """The faults that the chaos ``plans`` (by case key, one a site of
    SERVICE_FAULT_MIX) inject into the service workload, sorted: every
    faulted attempt ``(site, key, attempt, kind)`` of each site a job
    reaches.  A one-case job reaches each site until it passes, whatever
    the scheduling; ``graphstore.read`` never, the cases hold their
    graphs."""
    want = []
    for key, per_site in plans.items():
        for site, p in zip(SERVICE_FAULT_MIX, per_site):
            if p is None or site == "graphstore.read":
                continue
            kind, k = p
            want += [(site, key, a, kind)
                     for a in range(1 if kind == "permanent" else k)]
    return sorted(want)


def service_resident_launches(epochs) -> dict:
    """The kernel launches the resident graph's epochs report, summed."""
    total = {}
    for ep in epochs:
        for k, n in ep.report.kernel_launches.items():
            total[k] = total.get(k, 0) + n
    return {k: n for k, n in total.items() if n}


def run_service_phase(card, dev) -> dict:
    """Phase 12, the service and the tuner.  The four parts of
    :func:`service_runs` on the card, with the kernel launch counts zeroed
    just before and read after each part.  The clean part: every job
    done, no retry, no quarantine, every row equal to the JAX package's
    pin.  The faulted part: the chaos plans of every case and site equal
    the pins, each planned fault injected once, every job done, no
    quarantine, every row equal to the clean part's.  The resident
    graph: every epoch equal to its pin and to ``run_dynamic`` of the
    same spec, whose launches are counted apart; the graph's own, one
    serve an epoch and one ``dram_timing`` an update, what its epochs
    report.  The tuner: the
    front of each search (two worker counts and the service) equal to the
    pin, non-dominated in the exhaustive space, whose vectors equal the
    pins too; the batched serves launched once a dispatch.  Returns the
    launches by part."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.tune import dominates
    t_phase = time.perf_counter()
    launches = {}

    def on_part(name):
        launches[name] = launch_counts()
        zero_launch_counts()

    zero_launch_counts()
    out = service_runs("repro_torch", on_part=on_part, device=dev)
    seconds = time.perf_counter() - t_phase
    reference = launches.pop("resident_reference")
    got = service_pin_values(out)
    n_jobs = SERVICE_CLIENTS * SERVICE_JOBS_PER_CLIENT
    for name in ("SERVICE_GRAPHS", "SERVICE_PLANS"):
        assert got[name] == globals()[name], (name, got[name])
    # the clean service
    clean = out["clean"]
    assert (clean["done"], clean["jobs"]) == (n_jobs, n_jobs), clean
    assert clean["stats"]["retries"] == 0, clean["stats"]
    assert clean["stats"]["quarantined"] == 0, clean["stats"]
    differ = sorted(k for k in SERVICE_PINS
                    if got["SERVICE_PINS"].get(k) != SERVICE_PINS[k])
    assert len(got["SERVICE_PINS"]) == n_jobs and not differ, [
        (k, got["SERVICE_PINS"].get(k), SERVICE_PINS[k]) for k in differ]
    assert out["warm"].report == clean["rows"][out["keys"][0]].report
    # the faulted service
    faulted = out["faulted"]
    assert faulted["injected"], "chaos injected no fault"
    assert faulted["jobs"] + faulted["shed"] == n_jobs, faulted
    # every fault of the pinned plans is transient and within the retry
    # budget: every job done, and each planned fault injected once
    assert (faulted["done"], faulted["shed"], len(faulted["rows"])) == (
        n_jobs, 0, n_jobs), faulted
    assert faulted["stats"]["quarantined"] == 0, faulted["stats"]
    assert sorted(faulted["injected"]) == service_injections(
        SERVICE_PLANS), faulted["injected"]
    for k, row in faulted["rows"].items():
        assert row.report == clean["rows"][k].report, k
        assert report_pin(row.report) == SERVICE_PINS[k], k
    # the resident graph
    res = out["resident"]
    assert res["pins"] == SERVICE_EPOCH_PINS, res["pins"]
    local = res["run_dynamic"].epochs
    for ep, want in zip(res["epochs"][1:], local[1:]):
        assert ep == want, ep.epoch
    ep0, want0 = res["epochs"][0], local[0]
    n0 = len(ep0.report.phases)
    assert (ep0.iterations, ep0.report.runtime_ns,
            ep0.report.total_requests, ep0.report.phases[:n0]) == (
        want0.iterations, want0.report.runtime_ns,
        want0.report.total_requests, want0.report.phases[:n0])
    assert res["info"]["epoch"] == SERVICE_UPDATES
    # the resident graph's own launches: one serve an epoch, one delta
    # rewrite an update, what its epochs report
    own = launches["resident"]
    assert own["dram_serve"] == own["serve_prepass"] == SERVICE_UPDATES + 1, \
        own
    assert own["dram_timing"] == SERVICE_UPDATES, own
    assert {k: n for k, n in own.items() if n} == \
        service_resident_launches(res["epochs"]), own
    # the tuner
    tuned = out["tuner"]
    for name, search in tuned["searches"].items():
        assert search_pin(search)["front"] == TUNE_SEARCH["front"], name
    assert search_pin(tuned["searches"][f"workers={SERVICE_WORKERS}"]) == \
        TUNE_SEARCH
    assert got["TUNE_EXHAUSTIVE"] == TUNE_EXHAUSTIVE
    assert got["TUNE_SWEEP_STATS"] == TUNE_SWEEP_STATS, got[
        "TUNE_SWEEP_STATS"]
    for key, objectives in TUNE_SEARCH["front"]:
        dominating = [k for k, v in TUNE_EXHAUSTIVE.items()
                      if dominates(v, objectives)]
        assert not dominating, (key, dominating)
    # launches: each part's kernels; the tuner's batched serves one a
    # dispatch (the pinned SweepStats), its service search one serve a
    # case
    missing = {p: [k for k in ks if launches[p][k] == 0]
               for p, ks in SERVICE_KERNELS.items()}
    assert not any(missing.values()), f"never launched: {missing}"
    assert launches["clean"]["dram_serve"] == n_jobs + 1, launches["clean"]
    assert launches["tuner"]["dram_serve_batch"] == sum(
        s["batch_dispatches"] for s in TUNE_SWEEP_STATS.values())
    assert launches["tuner"]["dram_serve"] == TUNE_SEARCH["stats"][
        "case_evals"]
    split = {}
    for name in ("clean", "faulted"):
        st = [r.report.stage_seconds for r in out[name]["rows"].values()]
        split[name] = {"prepare_s": sum(x.get("prepare", 0.0) for x in st),
                       "serve_s": sum(x.get("serve", 0.0) for x in st),
                       "wall_s": out[name]["wall_s"]}
    st = [r.report.stage_seconds for r in tuned["exhaustive"].values()]
    split["tuner_exhaustive"] = {
        "prepare_s": sum(x["prepare"] for x in st),
        "serve_s": sum(x["serve"] for x in st)}
    drop = ("rows", "injected")
    emit(phase="service", seconds=seconds, part_seconds=out["seconds"],
         graphs={a: list(v[:3]) for a, v in got["SERVICE_GRAPHS"].items()},
         clean={k: v for k, v in clean.items() if k not in drop},
         faulted={**{k: v for k, v in faulted.items() if k not in drop},
                  "injected": len(faulted["injected"]),
                  "surviving_rows": len(faulted["rows"])},
         rows_pinned=len(SERVICE_PINS),
         launches={name: {k: c[k] for k in KERNELS if c[k]}
                   for name, c in launches.items()},
         host_serve_split=split, card=card)
    emit(phase="service_resident", epochs=res["pins"],
         equal_run_dynamic=True,
         run_dynamic_launches={k: n for k, n in reference.items() if n},
         card=card)
    emit(phase="service_tuner",
         front=TUNE_SEARCH["front"], searches=sorted(tuned["searches"]),
         exhaustive_points=len(TUNE_EXHAUSTIVE),
         sweep_stats=got["TUNE_SWEEP_STATS"],
         search_seconds={k: v.stats.wall_s
                         for k, v in tuned["searches"].items()}, card=card)
    return {"launches": launches, "seconds": seconds}


def row_fields(row) -> dict:
    """A sweep row's ``as_dict`` without its wall time."""
    d = row.as_dict()
    d.pop("wall_s")
    return d


def report_diff(got, want) -> list:
    """The compared fields (every dataclass field but the
    ``compare=False`` ones, the stage times and launch counts) in which
    two ``SimReport`` differ."""
    return [f.name for f in dataclasses.fields(want)
            if f.compare and getattr(got, f.name) != getattr(want, f.name)]


def threaded_session_runs(graph, want, device, runs=LOCK_RUNS,
                          threads=LOCK_THREADS, seed=LOCK_SEED) -> dict:
    """Phase 13's part (a): a cold ``SimSession`` on ``graph`` and
    ``threads`` threads issuing ``runs`` WCC runs of the accelerators of
    ``want`` (accelerator -> the report of a serial run) in a seeded mixed
    order.  Every report equal to ``want``'s field for field; one
    algorithm run an engine (the rest are the session's hits)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.sim import SimSession
    accs = sorted(want) * (runs // len(want))
    order = [accs[i] for i in np.random.default_rng(seed).permutation(
        len(accs))]
    sess = SimSession(graph)
    with ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(lambda acc: sess.run("wcc", acc, device=device),
                            order))
    bad = [(i, acc, report_diff(r, want[acc]))
           for i, (acc, r) in enumerate(zip(order, got))
           if report_diff(r, want[acc])]
    assert not bad, f"threaded session runs differ from the serial: {bad}"
    assert (sess.algo_runs, sess.algo_cache_hits) == (
        len(want), runs - len(want)), (sess.algo_runs, sess.algo_cache_hits)
    return {"runs": len(order), "threads": threads, "order": order,
            "algo_runs": sess.algo_runs,
            "algo_cache_hits": sess.algo_cache_hits}


def witness_sweep_cases(graph) -> list:
    """Phase 13's part (b) grid: WCC on ``graph`` on both accelerators,
    each under its default memory and ``LOCK_KINDS`` timing variants of
    it."""
    from repro_torch.sim import (SweepCase, get_accelerator,
                                 timing_variants)
    from repro_torch.sim.session import resolve_run_config
    cases = []
    for acc in ("hitgraph", "accugraph"):
        default = resolve_run_config(get_accelerator(acc)).dram_config()
        cases += [SweepCase(graph, "wcc", accelerator=acc, memory=m)
                  for m in [None] + timing_variants(default,
                                                    kinds=LOCK_KINDS)]
    return cases


def witness_service_jobs(graph) -> list:
    """Phase 13's part (c) jobs, each submitted twice: PR on HitGraph (one
    case, the per-case serve) and BFS on HitGraph under its default memory
    and ``LOCK_KINDS`` timing variants (one batched serve)."""
    from repro_torch.sim import (SweepCase, get_accelerator,
                                 timing_variants)
    from repro_torch.sim.session import resolve_run_config
    default = resolve_run_config(get_accelerator("hitgraph")).dram_config()
    return [[SweepCase(graph, "pr", accelerator="hitgraph")],
            [SweepCase(graph, "bfs", accelerator="hitgraph", memory=m)
             for m in [None] + timing_variants(default, kinds=LOCK_KINDS)]]


def lock_witness_parts(wt, want, device, graph=LOCK_GRAPH,
                       runs=LOCK_RUNS) -> dict:
    """The four parts of phase 13 under the witness (the caller sets
    ``REPRO_ANALYSIS_LOCKS``), each with the launch counts and the
    witness's record zeroed just before it and read just after: (a)
    :func:`threaded_session_runs` on ``wt``; (b) a
    ``Sweeper(workers=LOCK_THREADS)`` grid (:func:`witness_sweep_cases` on
    the preset ``graph``) against ``workers=1``, rows equal, the threaded
    grid run again with the witness off (a fresh sweeper each run); (c) a
    ``SimService`` taking :func:`witness_service_jobs` twice from
    ``LOCK_SUBMITTERS`` threads, the rows of each repeated submission
    equal; (d) ``LOCK_THREADS`` threads saving ``graph`` to one key of a
    fresh ``GraphStore``, ``LOCK_SAVES`` times each: one file, no tmp
    litter, the file reading back the graph.  Returns by part: seconds,
    threads, launches, locks made by role, the findings; and the threaded
    grid's seconds with the witness on and off."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.analysis import locks
    from repro_torch.graphs.corpus import (GRAPH_PRESETS, GraphStore,
                                           resolve_graph)
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.serve.engine import DONE, SimService
    from repro_torch.sim import Sweeper
    parts, counts_by_part, found = {}, {}, []

    def start():
        zero_launch_counts()
        locks.reset()
        return time.perf_counter()

    def finish(name, t0, threads, **extra):
        seconds = time.perf_counter() - t0
        hazards = [h.format() for h in locks.findings()]
        found.extend(f"{name}: {h}" for h in hazards)
        counts = counts_by_part[name] = launch_counts()
        parts[name] = {"seconds": seconds, "threads": threads,
                       "launches": {k: n for k, n in counts.items() if n},
                       "locks_made": locks.made(),
                       "findings": len(hazards), **extra}
        return counts

    t0 = start()
    out = threaded_session_runs(wt, want, device, runs=runs)
    counts = finish("session", t0, out["threads"], runs=out["runs"],
                    algo_runs=out["algo_runs"],
                    algo_cache_hits=out["algo_cache_hits"])
    # the session caches runs, models and packs, never serves: one serve
    # (a pre-pass and the records) a run
    assert (counts["dram_serve"], counts["serve_prepass"]) == (
        out["runs"], out["runs"]), counts

    g = resolve_graph(graph)
    cases = witness_sweep_cases(g)

    def grid(workers):
        return [row_fields(r) for r in Sweeper(
            workers=workers, batch_memories=True, device=device).run(cases)]

    want_rows = grid(1)
    flag = os.environ.get(locks.ENV_FLAG)
    os.environ[locks.ENV_FLAG] = "0"
    try:
        t_off = time.perf_counter()
        off_rows = grid(LOCK_THREADS)
        off_s = time.perf_counter() - t_off
    finally:
        os.environ[locks.ENV_FLAG] = flag
    t0 = start()
    on_rows = grid(LOCK_THREADS)
    on_s = time.perf_counter() - t0
    finish("sweeper", t0, LOCK_THREADS, cases=len(cases))
    assert on_rows == want_rows and off_rows == want_rows, (
        "the threaded sweeper's rows differ from workers=1")

    jobs = witness_service_jobs(g)
    t0 = start()
    with SimService(batch_memories=True, device=device) as svc:
        with ThreadPoolExecutor(LOCK_SUBMITTERS) as pool:
            ids = list(pool.map(svc.submit, jobs * 2))
        rows = [[row_fields(r) for r in svc.result(i, timeout=600)]
                for i in ids]
        assert all(svc.poll(i) == DONE for i in ids)
    finish("service", t0, LOCK_SUBMITTERS + 1, jobs=len(ids))
    assert rows[0] == rows[2] and rows[1] == rows[3], (
        "a repeated service submission's rows differ")

    key = GRAPH_PRESETS[graph].key(1.0, 0)
    with tempfile.TemporaryDirectory(prefix="witness-store-") as tmp:
        store = GraphStore(tmp)
        t0 = start()
        barrier = threading.Barrier(LOCK_THREADS)

        def save():
            barrier.wait(timeout=60)
            for _ in range(LOCK_SAVES):
                assert store.store(key, g) is not None

        with ThreadPoolExecutor(LOCK_THREADS) as pool:
            for f in [pool.submit(save) for _ in range(LOCK_THREADS)]:
                f.result()
        files = sorted(p.name for p in Path(tmp).iterdir())
        back = store.load(key)
        finish("store", t0, LOCK_THREADS, saves=LOCK_THREADS * LOCK_SAVES)
    assert files == [store.path_for(key).name], files
    assert back is not None and back.fingerprint == g.fingerprint
    return {"parts": parts, "launches": counts_by_part, "findings": found,
            "sweeper_witness_s": {"off": off_s, "on": on_s}}


def run_lock_witness_phase(card, dev, wt, reports) -> dict:
    """Phase 13, the port's threads on the card under the lock witness
    (``REPRO_ANALYSIS_LOCKS=1`` for this phase only):
    :func:`lock_witness_parts`, part (a) on the full-size wiki-talk
    stand-in held to the main path's ``reports``; then no hazard recorded
    in any part.  Returns the launches by part and the seconds."""
    import os
    from repro_torch.analysis import locks
    t_phase = time.perf_counter()
    flag = os.environ.get(locks.ENV_FLAG)
    os.environ[locks.ENV_FLAG] = "1"
    try:
        out = lock_witness_parts(wt, reports, dev)
    finally:
        if flag is None:
            os.environ.pop(locks.ENV_FLAG, None)
        else:
            os.environ[locks.ENV_FLAG] = flag
    seconds = time.perf_counter() - t_phase
    emit(phase="lock_witness", seconds=seconds, parts=out["parts"],
         sweeper_witness_s=out["sweeper_witness_s"],
         findings=len(out["findings"]), card=card)
    assert out["findings"] == [], (
        "the lock witness recorded hazards:\n  "
        + "\n  ".join(out["findings"]))
    return {"launches": out["launches"], "seconds": seconds}


def session_pack(sess, acc, memory, dev):
    """The WCC pack of ``acc`` under ``memory`` (a ``DRAMConfig``, None for
    its default) from ``sess``'s caches."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.session import resolve_run_config
    spec = get_accelerator(acc)
    cfg = resolve_run_config(spec, memory=memory)
    packed, _ = sess.packed_program_for(
        spec, Problem.WCC, cfg, sess.model_for(spec, cfg),
        sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev),
        cfg.dram_config(), device=dev)
    return packed


def nccl_engine_runs(wt, hitgraph_wcc, card, dev) -> dict:
    """Phase 14 (a): ``run_wcc`` and ``run_sssp`` on ``wt`` over a one-rank
    NCCL group set up through a ``FileStore`` (no network) and torn down
    in a ``finally``.  The labels must equal ``hitgraph_wcc`` (the main
    path's HitGraph WCC values); the distances from vertex 0 (isolated in
    the stand-in) and from the vertex of highest degree must equal the
    single-process edge-centric engine's on ``wt.with_unit_weights()``.
    Returns the launches."""
    import os
    import tempfile
    import torch.distributed as dist
    from repro_torch.algorithms import distributed as DG
    from repro_torch.algorithms import edge_centric
    from repro_torch.algorithms.common import INF32, Problem
    from repro_torch.kernels import launch_counts, zero_launch_counts
    unit = wt.with_unit_weights()
    hub = int(np.argmax(np.bincount(wt.src, minlength=wt.n)))
    roots = {"sssp": 0, "sssp_hub": hub}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            backend = str(dist.get_backend())
            world = dist.get_world_size()
            zero_launch_counts()
            torch.cuda.synchronize()
            for name in ("wcc",) + tuple(roots):
                stats = {}
                t0 = time.perf_counter()
                if name == "wcc":
                    values = DG.run_wcc(wt, stats=stats)
                else:
                    values = DG.run_sssp(unit, root=roots[name], stats=stats)
                runs[name] = (values, stats, time.perf_counter() - t0)
            launches = launch_counts()
        finally:
            dist.destroy_process_group()
    lines = {}
    for name, (values, stats, seconds) in runs.items():
        line = {"iterations": stats["iterations"], "seconds": seconds,
                "setup_s": stats["setup_seconds"],
                "first_step_s": stats["step_seconds"][0],
                "later_steps_s": sum(stats["step_seconds"][1:]),
                "gather_s": stats["gather_seconds"]}
        if name == "wcc":
            line.update(components=int(np.unique(values).size),
                        equal_main_path=bool(np.array_equal(
                            values, hitgraph_wcc)))
        else:
            t0 = time.perf_counter()
            single = edge_centric.run(unit, Problem.SSSP, root=roots[name],
                                      device=dev)
            line.update(root=roots[name],
                        reached=int((values < INF32).sum()),
                        single_process_iterations=single.iterations,
                        single_process_s=time.perf_counter() - t0,
                        equal_single_process=bool(np.array_equal(
                            values, single.values)))
        lines[name] = line
    emit(phase="distributed", part="engine", backend=backend, world=world,
         nccl=".".join(map(str, torch.cuda.nccl.version())),
         vertices=wt.n, edges=wt.m, **lines,
         launches={k: n for k, n in launches.items() if n}, card=card)
    assert (backend, world) == ("nccl", 1), (backend, world)
    assert lines["wcc"]["equal_main_path"], (
        "distributed WCC differs from the main path's values")
    for name in roots:
        assert lines[name]["equal_single_process"], (
            f"distributed {name} differs from the edge-centric run")
    assert lines["sssp_hub"]["reached"] > 1
    return launches


def sharded_serve_runs(sweeper, wt, hitgraph_mems, launches, card, dev):
    """Phase 14 (b): phase 10's full-size HitGraph program and its timing
    variants through ``sharded_fused_scan_batch_shared`` over
    ``[cuda:0] * 4`` and ``[cuda:0] * 3``, and the full-size stacked pair
    through ``sharded_fused_scan_batch`` over ``[cuda:0] * 2``: finishes
    and carries bit-equal to the unsharded ``fused_scan_batch``, one
    ``dram_serve_batch`` launch a shard (counts zeroed around each call,
    into ``launches``), CUDA-event ms beside the unsharded call's."""
    from repro_torch.core import vectorized as vec
    from repro_torch.distributed.sharding import (
        sharded_fused_scan_batch, sharded_fused_scan_batch_shared)
    from repro_torch.kernels import launch_counts, zero_launch_counts
    sess = sweeper._session(wt)
    shared = session_pack(sess, "hitgraph", None, dev)
    timing_shared = np.stack([vec.timing_params(
        (m or hitgraph_default_memory()).timing) for m in hitgraph_mems])
    pair_mems = stacked_pair_memories()
    pair = [session_pack(sess, "hitgraph", m, dev) for m in pair_mems]
    assert pair[0].signature == pair[1].signature
    stacked = [torch.stack([vec.as_int32(getattr(p, f), dev) for p in pair])
               for f in ("issue", "meta", "boundary")]
    timing_pair = np.stack([vec.timing_params(m.timing) for m in pair_mems])
    geometry = (shared.n_banks, shared.banks_per_rank)
    runs = [("shared", 4, sharded_fused_scan_batch_shared,
             (shared.issue, shared.meta, shared.boundary), timing_shared),
            ("shared", 3, sharded_fused_scan_batch_shared,
             (shared.issue, shared.meta, shared.boundary), timing_shared),
            ("stacked", 2, sharded_fused_scan_batch, tuple(stacked),
             timing_pair)]
    out, base = [], {}
    for programs, entries, fn, streams, timing in runs:
        if programs not in base:
            zero_launch_counts()
            base[programs] = timed_call(lambda: vec.fused_scan_batch(
                *streams, timing, *geometry, dev))
            base_launches = launch_counts()["dram_serve_batch"]
            assert base_launches == 1, base_launches
        (fin_u, carry_u), unsharded_ms = base[programs]
        mesh = [torch.device(dev.type, 0)] * entries
        zero_launch_counts()
        (fin, carry), ms = timed_call(lambda: fn(*streams, timing, *geometry,
                                                 mesh, dev))
        counts = launch_counts()
        launches[f"sharded_{programs}_{entries}"] = counts
        M = len(timing)
        per = -(-M // entries)
        # one shard's cases alone, unsharded, for the time a launch takes
        _, one_shard_ms = timed_call(lambda: vec.fused_scan_batch(
            *(x[:per] if programs == "stacked" else x for x in streams),
            timing[:per], *geometry, dev))
        equal = (torch.equal(fin, fin_u)
                 and all(torch.equal(a, b) for a, b in zip(carry, carry_u)))
        line = {"programs": programs, "entries": entries, "M": M,
                "pad": (-M) % entries, "shape": list(fin.shape),
                "ms": ms, "unsharded_ms": unsharded_ms,
                "one_shard_cases": per, "one_shard_ms": one_shard_ms,
                "dram_serve_batch_launches": counts["dram_serve_batch"],
                "serve_prepass_batch_launches": counts["serve_prepass_batch"],
                "bit_equal_unsharded": equal}
        emit(phase="distributed", part="sharded_serve", **line, card=card)
        assert equal, f"the sharded {programs} serve over {entries} differs"
        assert counts["dram_serve_batch"] == entries, counts
        assert counts["serve_prepass_batch"] == entries, counts
        out.append(line)
        del fin, carry
    del base, stacked
    return out


def sweep_surface_runs(swept, launches, card, dev) -> dict:
    """Phase 14 (c): a fresh ``Sweeper(devices=1, batch_memories=True)``
    over phase 10's HitGraph cases, rows equal to phase 10's field for
    field, no sharded serve; ``Sweeper(devices=cards + 1)`` constructs and
    raises at its first batched group (a timing pair on rmat(8, 5)),
    naming the visible card count."""
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.sim import SweepCase, Sweeper, timing_variants
    n_hit = len(swept["memories"]["hitgraph"])
    cases = [c for c in swept["cases"] if c.accelerator == "hitgraph"]
    want = [r for r in swept["rows"] if r.report.system == "hitgraph"]
    assert len(cases) == len(want) == n_hit
    sw = Sweeper(devices=1, batch_memories=True)
    zero_launch_counts()
    t0 = time.perf_counter()
    rows = sw.run(cases)
    seconds = time.perf_counter() - t0
    counts = launches["surface_devices1"] = launch_counts()
    equal = all(a.report == b.report and row_fields(a) == row_fields(b)
                for a, b in zip(rows, want))
    cards = torch.cuda.device_count()
    over = Sweeper(devices=cards + 1, batch_memories=True)
    small = rmat(8, 5, seed=7).undirected_view()
    pair = [SweepCase(small, "wcc", accelerator="hitgraph", memory=m)
            for m in timing_variants(hitgraph_default_memory(),
                                     kinds=SWEEP_KINDS[:2])]
    message = None
    try:
        over.run(pair)
    except ValueError as exc:
        message = str(exc)
    line = {"rows": len(rows), "equal_phase10": equal,
            "stats": dataclasses.asdict(sw.stats), "seconds": seconds,
            "dram_serve_batch_launches": counts["dram_serve_batch"],
            "cards": cards, "oversubscribed_devices": cards + 1,
            "oversubscribed_error": message}
    emit(phase="distributed", part="surface", **line, card=card)
    assert equal, "Sweeper(devices=1) rows differ from phase 10's"
    assert sw.stats.sharded_dispatches == 0 and sw.stats.devices == 1
    assert counts["dram_serve_batch"] == 1, counts
    assert message is not None and (
        f"devices={cards + 1} exceeds the {cards} visible cuda" in message), (
        message)
    assert over.stats.sharded_dispatches == 0
    return line


def run_distributed_phase(wt, sessions, swept, card, dev) -> dict:
    """Phase 14, the distributed engine and ``devices=N`` on one card:
    :func:`nccl_engine_runs`, :func:`sharded_serve_runs` and
    :func:`sweep_surface_runs`.  Returns the launches by part and the
    seconds."""
    from repro_torch.algorithms.common import Problem
    from repro_torch.sim import get_accelerator
    from repro_torch.sim.session import resolve_run_config
    t_phase = time.perf_counter()
    spec = get_accelerator("hitgraph")
    main_wcc = sessions["hitgraph"].algorithm_run(
        spec, Problem.WCC, resolve_run_config(spec), 0, None, dev).values
    launches = {"engine": nccl_engine_runs(wt, main_wcc, card, dev)}
    serves = sharded_serve_runs(swept["sweeper"], wt,
                                swept["memories"]["hitgraph"], launches,
                                card, dev)
    surface = sweep_surface_runs(swept, launches, card, dev)
    seconds = time.perf_counter() - t_phase
    emit(phase="distributed", part="total", seconds=seconds,
         sharded_serves=len(serves), surface_rows=surface["rows"],
         card=card)
    return {"launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 15: the LM serve path (repro_torch.models)
# ---------------------------------------------------------------------------

#: the full-width model: qwen3-0.6b's published configuration, computed
#: in float32 for the pinned part, as published (bf16) for the serve
LM_ARCH = "qwen3_0_6b"
#: the pinned part's depth: full width, the 28 layers cut to 4, since
#: ``tools/lm_pins.py`` makes its pins through ``repro`` on a CPU, which
#: runs no full-size configuration; ``lm_serve`` runs all 28 layers
LM_PINNED_LAYERS = 4
LM_PINNED_PROMPTS = (17, 32)
LM_PINNED_NEW = 8
LM_PINNED_TOP = 8
LM_PINNED_TOL = 1e-3           # rtol and atol against repro's pins
#: tokens are held equal up to and including the first step whose pinned
#: top-2 margin is below this (a closer step may flip on rounding)
LM_MARGIN_FLOOR = 1e-2
#: the ten smoke configurations at float32: forward on (2, 16), prefill
#: of 8 tokens and 3 decode steps, generate (2 requests, 4 tokens), and a
#: long prompt where it takes another route: qwen3-smoke's 256 tokens
#: run the chunked attention (4 chunks of 64), xlstm-smoke's 512 tokens
#: two scan chunks
LM_FAMILY_SHAPE = (2, 16)
LM_FAMILY_PREFILL = 8
LM_FAMILY_DECODE = 3
LM_FAMILY_PROMPTS = (5, 9)
LM_FAMILY_NEW = 4
LM_FAMILY_TOP = 4
LM_FAMILY_TOL = 1e-4
LM_FAMILY_MARGIN_FLOOR = 1e-4
LM_LONG = {"qwen3_0_6b": 256, "xlstm_1_3b": 512}
#: the served load: 8 requests of 64, 128, ..., 512 tokens, 64 new each
LM_SERVE_PROMPTS = tuple(range(64, 513, 64))
LM_SERVE_NEW = 64
LM_SERVE_TOL = 2e-2            # bf16, as tests/test_arch_smoke.py uses
LM_LONG_PREFILL = 4096
LM_SEED = 0
LM_PINS = ROOT / "tools" / "lm_pins.json"


def lm_numpy_params(cfg, rng) -> dict:
    """``repro``'s parameter tree for ``cfg`` made with NumPy from
    ``rng``: ``repro.models.model.init_params``'s names, stacked shapes
    and scales (``normal / sqrt(fan_in)``, the embedding ``normal *
    0.02``, norms one), float32.  Both packages take it: ``repro`` as
    arrays, the port through ``interop.lm_params``."""
    d = cfg.d_model

    def dense(shape, fan_in):
        scale = np.float32(1.0 / np.sqrt(max(fan_in, 1)))
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def ones(*shape):
        return np.ones(shape, np.float32)

    def attention(lead):
        hd, H, K = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        p = {"wq": dense(lead + (d, H * hd), d),
             "wk": dense(lead + (d, K * hd), d),
             "wv": dense(lead + (d, K * hd), d),
             "wo": dense(lead + (H * hd, d), H * hd)}
        if cfg.qk_norm:
            p["q_norm"] = ones(*lead, hd)
            p["k_norm"] = ones(*lead, hd)
        return p

    def mlp(lead, f):
        p = {"w1": dense(lead + (d, f), d), "w2": dense(lead + (f, d), f)}
        if cfg.act in ("silu", "geglu"):
            p["w3"] = dense(lead + (d, f), d)
        return p

    def block(kind, lead):
        p = {"ln1": ones(*lead, d)}
        if kind in ("dense", "moe", "hybrid", "enc", "dec"):
            p["attn"] = attention(lead)
        if kind == "hybrid":
            di, n = cfg.d_inner, cfg.ssm_state
            a_log = np.log(np.linspace(1.0, float(n), n, dtype=np.float32))
            p["mamba"] = {
                "in_proj": dense(lead + (d, 2 * di), d),
                "conv": dense(lead + (cfg.ssm_conv, di), cfg.ssm_conv),
                "x_bc": dense(lead + (di, 2 * n), di),
                "x_dt": dense(lead + (di, 1), di),
                "a_log": np.broadcast_to(a_log, lead + (di, n)).copy(),
                "d_skip": ones(*lead, di),
                "out_proj": dense(lead + (di, d), di)}
        if kind == "dec":
            p["ln_cross"] = ones(*lead, d)
            p["cross"] = attention(lead)
        if kind == "moe":
            e, f = cfg.n_experts, cfg.d_ff
            p["ln2"] = ones(*lead, d)
            p["moe"] = {"router": dense(lead + (d, e), d),
                        "w1": dense(lead + (e, d, f), d),
                        "w3": dense(lead + (e, d, f), d),
                        "w2": dense(lead + (e, f, d), f)}
            if cfg.moe_dense_residual:
                p["moe"]["dense"] = mlp(lead, cfg.moe_dense_ff or cfg.d_ff)
        elif kind in ("dense", "hybrid", "enc", "dec"):
            p["ln2"] = ones(*lead, d)
            p["mlp"] = mlp(lead, cfg.d_ff)
        if kind == "mlstm":
            di = d * max(cfg.ssm_expand, 1)
            p["mlstm"] = {"in_proj": dense(lead + (d, 2 * di), d),
                          "wq": dense(lead + (di, di), di),
                          "wk": dense(lead + (di, di), di),
                          "wv": dense(lead + (di, di), di),
                          "w_if": dense(lead + (di, 2 * cfg.n_heads), di),
                          "out_proj": dense(lead + (di, d), di)}
        if kind == "slstm":
            p["slstm"] = {"w_in": dense(lead + (d, 4 * d), d),
                          "r_rec": dense(lead + (d, 4 * d), d),
                          "out_proj": dense(lead + (d, d), d)}
        return p

    p = {"embed": rng.standard_normal((cfg.vocab, d), dtype=np.float32)
         * np.float32(0.02),
         "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense((d, cfg.vocab), d)
    L = (max(cfg.n_layers, 1),)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe", "hybrid"):
        p["blocks"] = block({"vlm": "dense"}.get(fam, fam), L)
    elif fam == "audio":
        p["blocks"] = block("dec", L)
        p["enc_blocks"] = block("enc", (max(cfg.enc_layers, 1),))
        p["enc_norm"] = ones(d)
    elif fam == "ssm":
        n_groups = cfg.n_layers // cfg.xlstm_group
        p["m_blocks"] = block("mlstm", (n_groups,
                                        max(cfg.xlstm_group - 1, 1)))
        p["s_blocks"] = block("slstm", (n_groups,))
    if fam == "vlm":
        p["img_adapter"] = dense((d, d), d)
    return p


def lm_extra(cfg, batch: int, rng) -> dict:
    """The modality stubs: patch embeddings (vlm), frame embeddings
    (audio)."""
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_model), dtype=np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model), dtype=np.float32)}
    return {}


def lm_np(x) -> np.ndarray:
    """A result of either package as float32 NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def lm_top(logits: np.ndarray, k: int) -> dict:
    """The ``k`` largest logits of each position: ids (the lower first
    among equals) and values."""
    ids = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    return {"ids": ids.tolist(),
            "values": np.take_along_axis(logits, ids, -1).tolist()}


def lm_greedy(M, E, params, cfg, prompts, new: int, extra=None, **kw):
    """``generate``'s loop by hand: the tokens, each step's top-2 margin
    and the prefill's last-position logits."""
    padded = E._pad_prompts(prompts)
    logits, cache = M.prefill(params, padded, cfg, extra=extra, **kw)
    first = lm_np(logits[:, -1])
    toks, margins = [], []
    for step in range(new):
        last = lm_np(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(np.argmax(last, axis=-1).astype(np.int32))
        if step + 1 < new:
            logits, cache = M.decode_step(params, cache, toks[-1][:, None],
                                          cfg, **kw)
    return (np.stack(toks, axis=1), np.stack(margins, axis=1), first)


def lm_pinned_config(get_config):
    """qwen3-0.6b as published, in float32, cut to LM_PINNED_LAYERS."""
    return dataclasses.replace(get_config(LM_ARCH), dtype="float32",
                               n_layers=LM_PINNED_LAYERS)


def lm_pinned_runs(M, E, cfg, to_params, **kw) -> dict:
    """The pinned part's calls through one package (``M`` its ``model``,
    ``E`` its ``lm_engine``, ``to_params`` its way to take the NumPy
    tree, ``kw`` the port's ``device=``): ``generate`` on the pinned
    prompts, and its loop by hand for the margins and the prefill."""
    rng = np.random.default_rng(LM_SEED)
    params = to_params(lm_numpy_params(cfg, rng), cfg)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in LM_PINNED_PROMPTS]
    reqs = [E.Request(p, max_new_tokens=LM_PINNED_NEW) for p in prompts]
    tokens = np.asarray(E.generate(params, cfg, reqs, **kw))
    loop, margins, first = lm_greedy(M, E, params, cfg, prompts,
                                     LM_PINNED_NEW, **kw)
    assert np.array_equal(tokens, loop), (tokens, loop)
    return {"tokens": tokens, "margins": margins, "prefill_last": first}


def lm_family_runs(M, E, get_config, to_params, arch, **kw) -> dict:
    """One smoke architecture at float32 through one package: forward,
    prefill + LM_FAMILY_DECODE decode steps (fed seeded ids), generate
    and its loop by hand, and the long prompt where LM_LONG names one
    (its prefill and one decode step)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rng = np.random.default_rng(LM_SEED)
    params = to_params(lm_numpy_params(cfg, rng), cfg)
    B, S = LM_FAMILY_SHAPE
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    extra = lm_extra(cfg, B, rng)
    out = {"forward": lm_np(M.forward(params, tokens, cfg, extra=extra,
                                      **kw)[0])}
    logits, cache = M.prefill(params, tokens[:, :LM_FAMILY_PREFILL], cfg,
                              extra=extra, **kw)
    steps = [lm_np(logits)]
    feed = rng.integers(0, cfg.vocab, (LM_FAMILY_DECODE, B, 1),
                        dtype=np.int32)
    for t in feed:
        logits, cache = M.decode_step(params, cache, t, cfg, **kw)
        steps.append(lm_np(logits))
    out["decode"] = np.stack(steps)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in LM_FAMILY_PROMPTS]
    reqs = [E.Request(p, max_new_tokens=LM_FAMILY_NEW) for p in prompts]
    out["tokens"] = np.asarray(E.generate(params, cfg, reqs, extra=extra,
                                          **kw))
    loop, out["margins"], _ = lm_greedy(M, E, params, cfg, prompts,
                                        LM_FAMILY_NEW, extra=extra, **kw)
    assert np.array_equal(out["tokens"], loop), (arch, out["tokens"], loop)
    if arch in LM_LONG:
        long = rng.integers(0, cfg.vocab, (1, LM_LONG[arch]), dtype=np.int32)
        logits, cache = M.prefill(params, long, cfg, **kw)
        nxt, _ = M.decode_step(params, cache, long[:, :1], cfg, **kw)
        out["long"] = np.stack([lm_np(logits), lm_np(nxt)])
    return out


def lm_pinned_pin(runs: dict) -> dict:
    """The pinned part's pins from one package's :func:`lm_pinned_runs`."""
    return {"prefill_top": lm_top(runs["prefill_last"], LM_PINNED_TOP),
            "tokens": runs["tokens"].tolist(),
            "margins": runs["margins"].tolist()}


def lm_family_pin(runs: dict) -> dict:
    """One architecture's pins from one package's
    :func:`lm_family_runs`."""
    return {**{k: lm_top(runs[k], LM_FAMILY_TOP)
               for k in ("forward", "decode", "long") if k in runs},
            "tokens": runs["tokens"].tolist(),
            "margins": runs["margins"].tolist()}


def lm_value_err(logits: np.ndarray, pin: dict, tol: float) -> float:
    """Hold ``logits`` at the pinned ids to the pinned values (rtol and
    atol ``tol``); the largest absolute difference."""
    got = np.take_along_axis(logits, np.asarray(pin["ids"]), -1)
    want = np.asarray(pin["values"], dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return float(np.abs(got - want).max())


def lm_tokens_held(tokens: np.ndarray, pinned: list, margins: list,
                   floor: float) -> int:
    """Hold ``tokens`` to the pinned ones, each row up to and including
    its first step whose pinned margin is below ``floor``; the count of
    tokens held."""
    want, marg = np.asarray(pinned), np.asarray(margins)
    assert tokens.shape == want.shape, (tokens.shape, want.shape)
    held = 0
    for row, (got, exp, m) in enumerate(zip(tokens, want, marg)):
        close = np.flatnonzero(m < floor)
        n = int(close[0]) + 1 if close.size else len(exp)
        assert np.array_equal(got[:n], exp[:n]), (row, got, exp, m)
        held += n
    return held


def lm_check_family(arch: str, runs: dict, pin: dict) -> dict:
    """One smoke architecture's runs against its pins."""
    errs = {k: lm_value_err(runs[k], pin[k], LM_FAMILY_TOL)
            for k in ("forward", "decode", "long") if k in pin}
    held = lm_tokens_held(runs["tokens"], pin["tokens"], pin["margins"],
                          LM_FAMILY_MARGIN_FLOOR)
    return {"max_abs_err": max(errs.values()), "tokens_held": held}


def lm_load_pins() -> dict:
    return json.loads(LM_PINS.read_text())


def lm_tensors(obj):
    """Every tensor of a parameter tree, cache or result."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from lm_tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from lm_tensors(v)


def lm_on_card(*objs) -> int:
    """Assert every tensor of ``objs`` lies on the card; their count."""
    n = 0
    for obj in objs:
        for t in lm_tensors(obj):
            assert t.device.type == "cuda", (t.device, tuple(t.shape))
            n += 1
    return n


def device_busy(fn):
    """``fn()`` under ``torch.profiler``: (its result, the device's busy
    ms summed over its kernels, the kernel count); busy ``None`` where
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy, kernels = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += ev.device_time_total / 1e3
            kernels += 1
    return out, (busy or None), kernels


def device_top(fn, top: int = 8):
    """``fn()`` under ``torch.profiler``: the ``top`` device operators by
    their summed device time (name, ms, calls)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append((ms, ev.key, ev.count))
    rows.sort(reverse=True)
    return [{"op": k[:120], "ms": ms, "calls": n}
            for ms, k, n in rows[:top]]


def lm_serve(card, dev) -> dict:
    """qwen3-0.6b as published (bf16 compute, 28 layers), weights from a
    seeded ``torch.Generator`` on the card: ``generate`` on the served
    load, its prefill and decode steps timed apart, decode held to
    ``forward`` at the same positions, and one LM_LONG_PREFILL-token
    prefill through the chunked attention, its layer 0 held to
    ``_sdpa``."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import lm_engine as E
    from repro_torch.models import model as M
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    lm = M.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    rng = np.random.default_rng(LM_SEED)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in LM_SERVE_PROMPTS]
    reqs = [E.Request(p, max_new_tokens=LM_SERVE_NEW) for p in prompts]
    E.generate(lm, cfg, [E.Request(p, max_new_tokens=2) for p in prompts],
               device=dev)                       # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = E.generate(lm, cfg, reqs, device=dev)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    generate_peak = torch.cuda.max_memory_allocated()
    assert out.shape == (len(reqs), LM_SERVE_NEW), out.shape
    assert out.min() >= 0 and out.max() < cfg.vocab, (out.min(), out.max())
    # the same loop by hand: the prefill and each decode step timed apart
    params = M.compute_params(lm, cfg)
    padded = E._pad_prompts(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, padded, cfg, device=dev)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    held = lm_on_card(params, cache, logits)
    assert bool(torch.isfinite(logits.float()).all())
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks, step_ms = [tok], []
    for _ in range(LM_SERVE_NEW - 1):
        t0 = time.perf_counter()
        logits, cache = M.decode_step(params, cache, tok[:, None], cfg,
                                      device=dev)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        assert bool(torch.isfinite(logits.float()).all())
        toks.append(tok)
    held += lm_on_card(cache, logits)
    loop = torch.stack(toks, dim=1).cpu().numpy()
    assert np.array_equal(loop, out), "generate differs from its loop"
    # the device's busy time in one more decode step, by the profiler
    (_, _), step_busy, step_kernels = device_busy(
        lambda: M.decode_step(params, cache, tok[:, None], cfg, device=dev))
    # decode logits equal forward's at the same positions (full width)
    S = LM_SERVE_PROMPTS[0]
    seq = torch.from_numpy(prompts[0][None]).to(dev)
    full, _ = M.forward(params, seq, cfg, device=dev)
    pre, cache1 = M.prefill(params, seq[:, :S - 1], cfg, device=dev)
    step, _ = M.decode_step(params, cache1, seq[:, S - 1:], cfg, device=dev)
    held += lm_on_card(full, pre, cache1, step)
    tol = LM_SERVE_TOL
    np.testing.assert_allclose(lm_np(pre[:, -1]), lm_np(full[:, S - 2]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lm_np(step[:, 0]), lm_np(full[:, S - 1]),
                               rtol=tol, atol=tol)
    decode_vs_forward = float(np.abs(lm_np(step[:, 0])
                                     - lm_np(full[:, S - 1])).max())
    del full, pre, cache1, step
    # one long prompt through the chunked attention
    n = LM_LONG_PREFILL
    assert L.takes_chunked_route(cfg, n), (n, cfg.attn_chunk)
    long = torch.from_numpy(
        rng.integers(0, cfg.vocab, (1, n), dtype=np.int32)).to(dev)
    chunked = L._sdpa_chunked
    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape[1])
        return chunked(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L._sdpa_chunked = counted
    try:
        t0 = time.perf_counter()
        long_logits, long_cache = M.prefill(params, long, cfg, device=dev)
        torch.cuda.synchronize()
        long_ms = (time.perf_counter() - t0) * 1e3
    finally:
        L._sdpa_chunked = chunked
    long_peak = torch.cuda.max_memory_allocated()
    assert calls == [n] * cfg.n_layers, calls
    held += lm_on_card(long_logits, long_cache)
    assert bool(torch.isfinite(long_logits.float()).all())
    del long_cache
    _, long_busy, long_kernels = device_busy(
        lambda: M.prefill(params, long, cfg, device=dev))
    with torch.inference_mode():
        bp = M._cast_tree(params["blocks"][0], M._cdt(cfg))
        x = M._embed(params, long, cfg)
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        q, k, v = L._qkv(h, bp["attn"], cfg, pos)
        a = L._sdpa_chunked(q, k, v, cfg, window=cfg.sliding_window)
        b = L._sdpa(q, k, v, cfg, causal=True, window=cfg.sliding_window)
    np.testing.assert_allclose(lm_np(a), lm_np(b), rtol=tol, atol=tol)
    chunked_err = float(np.abs(lm_np(a) - lm_np(b)).max())
    decode_ms = float(np.median(step_ms[3:]))
    line = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "params": n_params, "init_s": init_s,
            "requests": len(reqs), "prompt_tokens": list(LM_SERVE_PROMPTS),
            "padded_to": int(padded.shape[1]), "new_tokens": LM_SERVE_NEW,
            "generate_s": generate_s,
            "tokens_per_s": len(reqs) * LM_SERVE_NEW / generate_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_ms_min": min(step_ms), "decode_ms_max": max(step_ms),
            "decode_step_device_busy_ms": step_busy,
            "decode_step_kernels": step_kernels,
            "decode_idle_share": (None if step_busy is None
                                  else 1.0 - step_busy / decode_ms),
            "peak_bytes_generate": generate_peak,
            "long_prefill_tokens": n, "long_prefill_ms": long_ms,
            "peak_bytes_long_prefill": long_peak,
            "long_prefill_device_busy_ms": long_busy,
            "long_prefill_kernels": long_kernels,
            "chunked_route_calls": len(calls),
            "chunked_vs_sdpa_max_abs": chunked_err,
            "decode_vs_forward_max_abs": decode_vs_forward,
            "tolerance": tol, "tensors_on_card": held, "card": card}
    emit(phase="lm_serve", **line)
    return line


def run_lm_phase(card, dev) -> dict:
    """Phase 15, the LM serve path: ``lm_pinned`` (qwen3-0.6b at full
    width, float32, held to ``repro``'s pins), ``lm_families`` (the ten
    smoke configurations held to theirs), ``lm_serve``; with the port's
    kernel launch counts zeroed before and all zero after (the path
    reaches no hand-written kernel).  Returns the seconds."""
    from repro_torch import interop
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels import launch_counts, zero_launch_counts
    from repro_torch.models import lm_engine as E
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    matmul = torch.backends.cuda.matmul
    flags = {"allow_tf32": matmul.allow_tf32,
             "allow_bf16_reduced_precision_reduction":
                 matmul.allow_bf16_reduced_precision_reduction}
    # the float32 pins need full float32 products (TF32 stays off)
    assert not flags["allow_tf32"], flags
    emit(phase="lm_device", torch=torch.__version__, cuda=torch.version.cuda,
         **flags, card=card)
    pins = lm_load_pins()
    zero_launch_counts()

    def to_params(tree, cfg):
        params = interop.lm_params(tree, cfg, dev)
        lm_on_card(params)
        return params

    t0 = time.perf_counter()
    cfg = lm_pinned_config(get_config)
    pinned = lm_pinned_runs(M, E, cfg, to_params, device=dev)
    pin = pins["pinned"]
    err = lm_value_err(pinned["prefill_last"], pin["prefill_top"],
                       LM_PINNED_TOL)
    held = lm_tokens_held(pinned["tokens"], pin["tokens"], pin["margins"],
                          LM_MARGIN_FLOOR)
    emit(phase="lm_pinned", model=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         prompts=list(LM_PINNED_PROMPTS), new_tokens=LM_PINNED_NEW,
         top=LM_PINNED_TOP, max_abs_err=err, tolerance=LM_PINNED_TOL,
         tokens_held=held, tokens=int(pinned["tokens"].size),
         tokens_got=pinned["tokens"].tolist(),
         seconds=time.perf_counter() - t0, card=card)
    t0 = time.perf_counter()
    families = {}
    for arch in ARCHS:
        runs = lm_family_runs(M, E, get_config, to_params, arch, device=dev)
        families[arch] = lm_check_family(arch, runs, pins["families"][arch])
    emit(phase="lm_families", archs=families, tolerance=LM_FAMILY_TOL,
         seconds=time.perf_counter() - t0, card=card)
    serve = lm_serve(card, dev)
    counts = launch_counts()
    assert not any(counts.values()), counts
    seconds = time.perf_counter() - t_phase
    emit(phase="lm_total", seconds=seconds, launches=counts, card=card)
    return {"seconds": seconds, "serve": serve}


# ---------------------------------------------------------------------------
# phase 16: LM training (repro_torch.train, checkpoint, fault_tolerance,
# launch.train)
# ---------------------------------------------------------------------------

#: AdamW and data of the pinned and family parts: qwen3-0.6b at full
#: width (LM_PINNED_LAYERS layers, float32) on 2 x 64 tokens, the smoke
#: configurations on 2 x 16
LM_TRAIN_HP = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 10}
LM_TRAIN_PINNED_DATA = {"seq_len": 64, "global_batch": 2, "seed": 0}
LM_TRAIN_FAMILY_DATA = {"seq_len": 16, "global_batch": 2, "seed": 0}
LM_TRAIN_PINNED_STEPS = 3
LM_TRAIN_FAMILY_STEPS = 1
#: the smoke configurations that also take a ``grad_accum=2`` step
LM_TRAIN_ACCUM = ("gemma_2b", "arctic_480b", "llama4_scout_17b_a16e")
#: elements of each leaf pinned after the last step: the first and
#: evenly spaced ones (all layers of a stacked leaf)
LM_TRAIN_SAMPLE = 32
LM_TRAIN_LOSS_TOL = (1e-5, 1e-4)        # rtol: step 1, later steps
LM_TRAIN_NORM_TOL = 1e-4                # rtol; atol 1e-6 of the global
LM_TRAIN_PARAM_TOL = 1e-5
#: the share of sampled elements that may lie past LM_TRAIN_PARAM_TOL: a
#: parameter whose gradient is near 0 moves by +-lr at step 1 and may
#: take the other sign in either package (all stay within 3 * lr * steps)
LM_TRAIN_PARAM_SHARE = 1e-3
#: a leaf whose pinned step-1 gradient norm is below this share of the
#: global norm has a gradient of 0 in exact arithmetic (a top-1 MoE
#: router: its gate is p / p): Adam moves each of its elements by lr times
#: the sign of rounding noise, so it is held to 3 * lr * steps only
LM_TRAIN_NOISE_LEAF = 1e-6
#: train_full: qwen3-0.6b as published through ``launch.train.main``
LM_TRAIN_FULL_DATA = {"seq_len": 512, "global_batch": 8}
LM_TRAIN_FULL_STEPS = 20
LM_TRAIN_ACCUM_STEPS = 4
LM_TRAIN_MIN_DROP = 1.0                 # nats, step 1 to step 20
#: train_resume: 2 layers at full width, 4 steps of 4 x 128 tokens
LM_TRAIN_RESUME_LAYERS = 2
LM_TRAIN_RESUME_DATA = {"seq_len": 128, "global_batch": 4, "seed": 0}
LM_TRAIN_RESUME_TOL = 1e-6
LM_TRAIN_PINS = ROOT / "tools" / "lm_train_pins.json"


def lm_flat(tree) -> dict:
    """A tree of either package as ``repro``'s checkpoint keys (the
    port's per-layer lists stacked as ``repro`` stacks them) -> float32
    NumPy."""
    from repro_torch.distributed.checkpoint import _flatten
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in _flatten(tree).items()}


def lm_train_sample(flat: dict) -> dict:
    """LM_TRAIN_SAMPLE leading and LM_TRAIN_SAMPLE evenly spaced elements
    of every leaf."""
    out = {}
    for k, a in flat.items():
        a = a.ravel()
        n = LM_TRAIN_SAMPLE
        idx = np.unique(np.concatenate([
            np.arange(min(n, a.size)),
            np.linspace(0, a.size - 1, n).astype(np.int64)]))
        out[k] = a[idx].tolist()
    return out


def lm_train_runs(api, cfg, data: dict, steps: int, accums,
                  pinned=None) -> dict:
    """One configuration's training through one package (``api``, see
    :func:`lm_train_port_api`; ``tools/lm_train_pins.py`` has
    ``repro``'s): step 1's loss and gradients (every leaf's norm, the
    global norm, all finite), the lr of each step, and for each
    ``grad_accum`` in ``accums`` ``steps`` AdamW steps from the NumPy
    weights: the losses and a sample of every parameter after them.

    ``pinned`` (the pins' ``batches``) replaces the tokens and labels
    that ``make_batch`` drew: NumPy's ``Generator.zipf`` draws other tail
    values in other NumPy versions (2.0 and 2.3 differ), so the card's
    host may draw other tokens than the pins' from the same seed; the
    count of tokens replaced is returned."""
    tree = lm_numpy_params(cfg, np.random.default_rng(LM_SEED))
    batches = [api.make_batch(cfg, data, i) for i in range(steps)]
    replaced = 0
    for b, want in zip(batches, pinned or ()):
        for k in ("tokens", "labels"):
            w = np.asarray(want[k], dtype=np.int32)
            replaced += int((b[k] != w).sum())
            b[k] = w
    loss, grads = api.loss_and_grads(api.to_params(tree, cfg), batches[0],
                                     cfg)
    g = lm_flat(grads)
    out = {"loss": float(loss), "grad_norm": float(api.global_norm(grads)),
           "leaf_norms": {k: float(np.linalg.norm(v.astype(np.float64)))
                          for k, v in g.items()},
           "grads_finite": all(bool(np.isfinite(v).all())
                               for v in g.values()),
           "lr": [api.schedule(i + 1) for i in range(steps)],
           "batches": [{k: b[k].tolist() for k in ("tokens", "labels")}
                       for b in batches],
           "tokens_replaced": replaced}
    del grads, g
    for ga in accums:
        params = api.to_params(tree, cfg)
        state = api.init_opt(params)
        step = api.make_step(cfg, ga)
        losses = []
        for b in batches:
            loss, params, state = step(params, state, b)
            losses.append(float(loss))
        out[f"accum_{ga}"] = {"losses": losses,
                              "sample": lm_train_sample(lm_flat(params))}
        del params, state
    return out


def lm_train_pin(runs: dict) -> dict:
    """The pins of one :func:`lm_train_runs`: all of it but the
    finiteness flag and the count of tokens replaced."""
    return {k: v for k, v in runs.items()
            if k not in ("grads_finite", "tokens_replaced")}


def lm_train_check(runs: dict, pin: dict) -> dict:
    """Hold one configuration's runs to its pins; the largest errors."""
    assert runs["grads_finite"], "a gradient leaf is not finite"
    assert runs["batches"] == pin.get("batches", runs["batches"]), (
        "trained on other batches than the pins'")
    first, later = LM_TRAIN_LOSS_TOL
    np.testing.assert_allclose(runs["loss"], pin["loss"], rtol=first)
    atol = 1e-6 * pin["grad_norm"]
    np.testing.assert_allclose(runs["grad_norm"], pin["grad_norm"],
                               rtol=LM_TRAIN_NORM_TOL)
    assert runs["leaf_norms"].keys() == pin["leaf_norms"].keys()
    norm_err = 0.0
    for k, v in pin["leaf_norms"].items():
        np.testing.assert_allclose(runs["leaf_norms"][k], v,
                                   rtol=LM_TRAIN_NORM_TOL, atol=atol,
                                   err_msg=k)
        norm_err = max(norm_err, abs(runs["leaf_norms"][k] - v)
                       / max(abs(v), atol))
    np.testing.assert_allclose(runs["lr"], pin["lr"], rtol=1e-6)
    loss_err, worst, over, n = 0.0, 0.0, 0, 0
    noise = {k for k, v in pin["leaf_norms"].items()
             if v < LM_TRAIN_NOISE_LEAF * pin["grad_norm"]}
    accums = [k for k in pin if k.startswith("accum_")]
    for key in accums:
        got, want = runs[key], pin[key]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                                   rtol=first)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=later)
        loss_err = max(loss_err, max(abs(a - b) / abs(b) for a, b in zip(
            got["losses"], want["losses"])))
        assert got["sample"].keys() == want["sample"].keys()
        errs = {k: np.abs(np.asarray(got["sample"][k])
                          - np.asarray(want["sample"][k]))
                for k in want["sample"]}
        steps = len(want["losses"])
        top = max(float(e.max()) for e in errs.values())
        assert top <= 3 * LM_TRAIN_HP["lr"] * steps, (key, top)
        worst = max(worst, top)
        held = [e for k, e in errs.items() if k not in noise]
        over += sum(int((e > LM_TRAIN_PARAM_TOL).sum()) for e in held)
        n += sum(e.size for e in held)
    assert over <= LM_TRAIN_PARAM_SHARE * n, (over, n)
    return {"loss_max_rel": loss_err,
            "grad_norm_rel": abs(runs["grad_norm"] - pin["grad_norm"])
            / pin["grad_norm"],
            "leaf_norm_max_rel": norm_err, "sample_max_abs": worst,
            "sample_over_tol": over, "sample_elements": n,
            "noise_leaves": sorted(noise),
            "accums": [int(k.split("_")[1]) for k in accums]}


def lm_train_family_config(get_config, arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def lm_train_family_accums(arch) -> tuple:
    return (1, 2) if arch in LM_TRAIN_ACCUM else (1,)


def lm_train_port_api(dev):
    """The port's side of :func:`lm_train_runs` on ``dev`` (every
    parameter tree asserted on the card when ``dev`` is one)."""
    import types

    from repro_torch import interop
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    from repro_torch.train import step as S
    hp = O.AdamWConfig(**LM_TRAIN_HP)

    def to_params(tree, cfg):
        params = interop.lm_params(tree, cfg, dev)
        if dev.type == "cuda":
            lm_on_card(params)
        return params

    return types.SimpleNamespace(
        to_params=to_params, init_opt=O.init,
        make_batch=lambda cfg, data, i: D.make_batch(
            cfg, D.DataConfig(**data), i),
        loss_and_grads=lambda p, b, cfg: S.loss_and_grads(p, b, cfg,
                                                          device=dev),
        global_norm=O.global_norm,
        schedule=lambda i: float(O._schedule(
            torch.tensor(i, dtype=torch.int32, device=dev), hp)),
        make_step=lambda cfg, ga: S.make_train_step(cfg, hp, ga,
                                                    device=dev))


def lm_train_load_pins() -> dict:
    return json.loads(LM_TRAIN_PINS.read_text())


def lm_train_full(card, dev) -> dict:
    """qwen3-0.6b as published through ``launch.train.main`` on the card:
    LM_TRAIN_FULL_STEPS steps, then LM_TRAIN_ACCUM_STEPS with
    ``--grad-accum 2`` (each from the seeded init, no checkpoint written:
    a full-width one is 7.2 GB), each step timed with the card
    synchronised, one more step under the profiler; then one step with
    ``remat`` off, its peak memory beside remat's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    cfg = get_config(LM_ARCH)
    tokens = LM_TRAIN_FULL_DATA["seq_len"] * LM_TRAIN_FULL_DATA["global_batch"]
    made = LT.make_train_step
    step_ms, last = [], {}

    def timed(*a, **k):
        step = made(*a, **k)

        def run(params, state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, state, batch)
            float(out[0])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            last.update(step=step, params=out[1], state=out[2], batch=batch)
            return out
        return run

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = LM_TRAIN_FULL_DATA
        argv = ["--arch", cfg.name, "--seq-len", str(data["seq_len"]),
                "--global-batch", str(data["global_batch"]), "--device",
                dev.type, "--ckpt-dir", tmp, "--save-every", "1000000"]
        LT.make_train_step = timed
        try:
            for name, extra_args in (
                    ("full", ["--steps", str(LM_TRAIN_FULL_STEPS)]),
                    ("accum", ["--steps", str(LM_TRAIN_ACCUM_STEPS),
                               "--grad-accum", "2"])):
                step_ms.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                losses = LT.main(argv + extra_args)
                seconds = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                assert len(losses) == len(step_ms), (losses, step_ms)
                assert all(np.isfinite(losses)), losses
                times = step_ms[:]
                ms = float(np.median(times[2:]))      # warm: past step 2
                again = lambda: last["step"](last["params"], last["state"],
                                             last["batch"])
                _, busy, kernels = device_busy(again)
                ops = device_top(again) if name == "full" else None
                out[name] = {"losses": losses, "seconds": seconds,
                             "step_ms": ms, "step_ms_all": times,
                             "tokens_per_s": tokens / ms * 1e3,
                             "step_device_busy_ms": busy,
                             "step_kernels": kernels,
                             "step_top_device_ops": ops,
                             "step_idle_share": (None if busy is None
                                                 else 1.0 - busy / ms),
                             "peak_bytes": peak}
                last.clear()
        finally:
            LT.make_train_step = made
        assert not os.listdir(tmp), os.listdir(tmp)
    full = out["full"]["losses"]
    drop = full[0] - full[-1]
    assert drop >= LM_TRAIN_MIN_DROP, full
    # one step with remat off, from a fresh init, its peak memory
    off = dataclasses.replace(cfg, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(off, torch.Generator(device=dev).manual_seed(0),
                           device=dev).tree()
    state = O.init(params)
    hp = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    b = D.make_batch(off, D.DataConfig(**LM_TRAIN_FULL_DATA), 0)
    step = made(off, hp, device=dev)
    loss, params, state = step(params, state, b)
    no_remat_loss = float(loss)
    no_remat_peak = torch.cuda.max_memory_allocated()
    held = lm_on_card(params, state)
    del params, state, step
    assert abs(no_remat_loss - full[0]) <= 1e-2 * abs(full[0]), (
        no_remat_loss, full[0])
    n_params = cfg.param_count()
    line = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "param_dtype": cfg.param_dtype, "param_count": n_params,
            "tokens_per_step": tokens, "loss_first": full[0],
            "loss_last": full[-1], "loss_drop": drop,
            "min_drop": LM_TRAIN_MIN_DROP, **{
                f"{name}_{k}": v for name, r in out.items()
                for k, v in r.items()},
            "no_remat_loss": no_remat_loss,
            "peak_bytes_remat": out["full"]["peak_bytes"],
            "peak_bytes_no_remat": no_remat_peak,
            "tensors_on_card": held, "card": card}
    emit(phase="lm_train", part="train_full", **line)
    return line


def lm_train_resume(card, dev) -> dict:
    """qwen3-0.6b's widths, LM_TRAIN_RESUME_LAYERS layers, as published
    (bf16 compute): an ``ElasticTrainer`` saves at step 2 of 4
    (``save_every=2``, ``keep=1``), a fresh one resumes from it and runs
    steps 2-3; losses and parameters equal the uninterrupted 4-step
    run's within LM_TRAIN_RESUME_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import ElasticTrainer
    from repro_torch.models import model as M
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    from repro_torch.train.step import make_train_step
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=LM_TRAIN_RESUME_LAYERS)
    hp = O.AdamWConfig(**LM_TRAIN_HP)
    dc = D.DataConfig(**LM_TRAIN_RESUME_DATA)

    def build_state(_mesh):
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        params = M.init_params(cfg, gen, device=dev).tree()
        return params, O.init(params)

    def trainer(directory, save_every, keep=1):
        return ElasticTrainer(directory, build_state,
                              lambda: make_train_step(cfg, hp, device=dev),
                              mesh_builder=lambda: None,
                              save_every=save_every, keep=keep)

    quiet = lambda _msg: None
    timing = {}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timing[name] = time.perf_counter() - t0
            return out
        return run

    with tempfile.TemporaryDirectory() as tmp:
        whole = trainer(os.path.join(tmp, "whole"), 1 << 30)
        _, pa, oa, start = whole.resume_or_init()
        assert start == 0
        pa, oa, la = whole.run(pa, oa, D.batches(cfg, dc), 4, log=quiet)
        first = trainer(os.path.join(tmp, "cut"), 2)
        first.manager.save = timed("save_s", first.manager.save)
        _, pb, ob, _ = first.resume_or_init()
        first.run(pb, ob, D.batches(cfg, dc), 2, log=quiet)
        del pb, ob
        assert first.manager.all_steps() == [2], first.manager.all_steps()
        size = os.path.getsize(first.manager._path(2))
        fresh = trainer(os.path.join(tmp, "cut"), 2)
        fresh.manager.restore_latest = timed("restore_s",
                                             fresh.manager.restore_latest)
        _, pc, oc, start = fresh.resume_or_init()
        assert start == 2 and int(oc["step"]) == 2, start
        held = lm_on_card(pc, oc)
        pc, oc, lc = fresh.run(pc, oc, D.batches(cfg, dc, start_step=2), 2,
                               start_step=2, log=quiet)
        assert fresh.manager.all_steps() == [4], fresh.manager.all_steps()
    loss_diff = max(abs(a - b) for a, b in zip(la[2:], lc))
    with torch.no_grad():
        param_diff = max(float((a - c).abs().max()) for a, c in zip(
            lm_tensors((pa, oa["m"], oa["v"])),
            lm_tensors((pc, oc["m"], oc["v"]))))
    line = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "data": LM_TRAIN_RESUME_DATA, "losses_whole": la,
            "losses_resumed": lc, "loss_max_abs": loss_diff,
            "state_max_abs": param_diff, "tolerance": LM_TRAIN_RESUME_TOL,
            "checkpoint_bytes": size, "save_s": timing["save_s"],
            "restore_s": timing["restore_s"], "tensors_on_card": held,
            "card": card}
    emit(phase="lm_train", part="train_resume", **line)
    assert loss_diff <= LM_TRAIN_RESUME_TOL, (la, lc)
    assert param_diff <= LM_TRAIN_RESUME_TOL, param_diff
    return line


def run_lm_train_phase(card, dev) -> dict:
    """Phase 16, LM training: ``train_pinned`` (qwen3-0.6b at full width,
    4 layers, float32, held to ``repro``'s pins), ``train_families`` (the
    ten smoke configurations held to theirs), ``train_full``,
    ``train_resume``; the port's kernel launch counts zeroed before and
    all zero after (training reaches no hand-written kernel).  Returns
    the seconds."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels import launch_counts, zero_launch_counts
    t_phase = time.perf_counter()
    matmul = torch.backends.cuda.matmul
    flags = {"allow_tf32": matmul.allow_tf32,
             "allow_bf16_reduced_precision_reduction":
                 matmul.allow_bf16_reduced_precision_reduction}
    assert not flags["allow_tf32"], flags
    emit(phase="lm_train", part="device", torch=torch.__version__,
         cuda=torch.version.cuda, **flags, card=card)
    pins = lm_train_load_pins()
    zero_launch_counts()
    api = lm_train_port_api(dev)
    t0 = time.perf_counter()
    cfg = lm_pinned_config(get_config)
    runs = lm_train_runs(api, cfg, LM_TRAIN_PINNED_DATA,
                         LM_TRAIN_PINNED_STEPS, (1, 2),
                         pins["pinned"]["batches"])
    got = lm_train_check(runs, pins["pinned"])
    emit(phase="lm_train", part="train_pinned", model=cfg.name,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         dtype=cfg.dtype, data=LM_TRAIN_PINNED_DATA, hp=LM_TRAIN_HP,
         losses={k: runs[k]["losses"] for k in runs if k.startswith("accum")},
         grad_norm=runs["grad_norm"], lr=runs["lr"],
         tokens_replaced=runs["tokens_replaced"], **got,
         tolerance={"loss": LM_TRAIN_LOSS_TOL, "norm": LM_TRAIN_NORM_TOL,
                    "param": LM_TRAIN_PARAM_TOL,
                    "param_share": LM_TRAIN_PARAM_SHARE},
         seconds=time.perf_counter() - t0, card=card)
    t0 = time.perf_counter()
    families = {}
    for arch in ARCHS:
        pin = pins["families"][arch]
        runs = lm_train_runs(api, lm_train_family_config(get_config, arch),
                             LM_TRAIN_FAMILY_DATA, LM_TRAIN_FAMILY_STEPS,
                             lm_train_family_accums(arch), pin["batches"])
        families[arch] = {**lm_train_check(runs, pin),
                          "tokens_replaced": runs["tokens_replaced"]}
    emit(phase="lm_train", part="train_families", archs=families,
         seconds=time.perf_counter() - t0, card=card)
    full = lm_train_full(card, dev)
    resume = lm_train_resume(card, dev)
    counts = launch_counts()
    assert not any(counts.values()), counts
    seconds = time.perf_counter() - t_phase
    emit(phase="lm_train", part="train_total", seconds=seconds,
         launches=counts, card=card)
    return {"seconds": seconds, "full": full, "resume": resume}


# ---------------------------------------------------------------------------
# phase 17: the LM cost tooling (core.hbm_adapter, launch.specs,
# costmodel, roofline) and the LM on a mesh (distributed.sharding's LM
# half, distributed.context, the expert-parallel MoE paths, launch.mesh)
# ---------------------------------------------------------------------------

#: the roofline's mesh and collective bytes a chip (a fixed count: the
#: port has no compiled program to count them in)
LM_COST_MESH = ("16x16", 256)
LM_COST_COLLECTIVE_BYTES = 5e9
LM_COST_FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm")
#: the length of the four patterns' traces held to the host route
LM_COST_LINES = 1 << 18
LM_COST_PINS = ROOT / "tools" / "lm_cost_pins.json"
#: the sharded step on the published qwen3-0.6b (bf16) and its serve
LM_SHARDED_DATA = {"seq_len": 256, "global_batch": 2, "seed": 0}
LM_SHARDED_PROMPT = 64
LM_SHARDED_NEW = 8
#: sharded against unsharded on the card: the loss (relative), each
#: gradient leaf (its error's norm over its norm) at bf16; float32 for
#: the pinned part and the EP paths
LM_SHARDED_LOSS_TOL = 1e-3
LM_SHARDED_GRAD_TOL = 2e-2
LM_SHARDED_F32 = {"rtol": 1e-5, "atol": 1e-6}
LM_SHARDED_EP_ARCH = "llama4_scout_17b_a16e"


def lm_cost_runs(api) -> dict:
    """The cost tooling through one package (``api``: its
    ``pattern_fractions``, ``effective_bandwidth_fraction``,
    ``analyze_cell``, ``render_table``, ``shape_supported``, ``SHAPES``,
    ``ARCHS`` and ``get_config``; ``tools/lm_cost_pins.py`` passes
    ``repro``'s): the four patterns' fractions, each family's and
    decode's, and the roofline row of every architecture at every shape
    it supports."""
    fractions = api.pattern_fractions()
    families = {f: api.effective_bandwidth_fraction(f)
                for f in LM_COST_FAMILIES}
    families["decode"] = api.effective_bandwidth_fraction("dense",
                                                          decode=True)
    rows = []
    for arch in api.ARCHS:
        cfg = api.get_config(arch)
        for shape in api.SHAPES:
            if api.shape_supported(cfg, shape)[0]:
                rows.append(api.analyze_cell(cfg, shape, *LM_COST_MESH,
                                             LM_COST_COLLECTIVE_BYTES))
    return {"fractions": dict(fractions), "families": families,
            "rows": [r.to_json() for r in rows],
            "table": api.render_table(rows)}


def lm_cost_port_api(dev):
    import types

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core import hbm_adapter as H
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs
    return types.SimpleNamespace(
        pattern_fractions=lambda: H.pattern_fractions(device=dev),
        effective_bandwidth_fraction=lambda f, decode=False:
            H.effective_bandwidth_fraction(f, decode=decode, device=dev),
        analyze_cell=lambda *a: R.analyze_cell(*a, device=dev),
        render_table=R.render_table, shape_supported=specs.shape_supported,
        SHAPES=specs.SHAPES, ARCHS=ARCHS, get_config=get_config)


def lm_cost_load_pins() -> dict:
    return json.loads(LM_COST_PINS.read_text())


def lm_cost_traces(dev, n_lines: int = LM_COST_LINES) -> dict:
    """The four patterns' traces at ``n_lines`` served on ``dev`` against
    the host's element oracle: every ``TraceResult`` field equal, the
    host's ms, the device call's ms (pack and copies included), and on
    the card the ``dram_timing`` launch alone (CUDA events) beside its
    bound.  Returns them by pattern."""
    from repro_torch.core import hbm_adapter as H
    from repro_torch.core import vectorized as V
    from repro_torch.core.trace import Trace, bulk_issue
    cfg = H.tpu_hbm_config()
    cpu = torch.device("cpu")
    out = {}
    for name, lines in H.pattern_traces(n_lines).items():
        t0 = time.perf_counter()
        want = H.serve_trace(lines, cfg, cpu)
        host_ms_ = (time.perf_counter() - t0) * 1e3
        if dev.type == "cuda":
            got, device_ms = timed_call(lambda: H.serve_trace(lines, cfg,
                                                              dev))
        else:
            t0 = time.perf_counter()
            got = H.serve_trace(lines, cfg, dev)
            device_ms = (time.perf_counter() - t0) * 1e3
        a, b = dataclasses.asdict(got), dataclasses.asdict(want)
        diff = sorted(k for k in b if a[k] != b[k])
        assert not diff, (name, {k: (a[k], b[k]) for k in diff})
        out[name] = {"requests": len(lines), "cycles": got.cycles,
                     "row_hits": got.row_hits,
                     "bandwidth_fraction": got.bandwidth_fraction,
                     "equal": "every TraceResult field",
                     "host_ms": host_ms_, "device_call_ms": device_ms}
        packed = V.pack_channels(Trace(lines, np.zeros(len(lines), bool),
                                       bulk_issue(len(lines), 0)), cfg)
        C, L = packed.issue.shape
        out[name]["shape"] = [C, L]
        out[name]["bound_ms"] = timing_bytes(
            C, L, cfg.banks_per_channel, cfg.org.ranks) / HBM_BYTES_PER_S * 1e3
    return out


def lm_cost_kernel_ms(dev, n_lines: int = LM_COST_LINES) -> dict:
    """The ``dram_timing`` launch alone on each pattern's packed trace
    (CUDA events, 5 runs after a warm-up), by pattern; launches made to
    time, not counted on a path."""
    from repro_torch.core import hbm_adapter as H
    from repro_torch.core import vectorized as V
    from repro_torch.core.trace import Trace, bulk_issue
    cfg = H.tpu_hbm_config()
    out = {}
    for name, lines in H.pattern_traces(n_lines).items():
        packed = V.pack_channels(Trace(lines, np.zeros(len(lines), bool),
                                       bulk_issue(len(lines), 0)), cfg)
        args = [torch.as_tensor(x, device=dev) for x in
                (packed.issue, packed.bank, packed.row, packed.valid)]
        timing = V.timing_params(cfg.timing)
        carry = V.init_channel_carry(cfg.channels, cfg.banks_per_channel,
                                     cfg.org.banks, dev)
        out[name] = cuda_ms(lambda: V.simulate_packed(*args, timing, carry),
                            reps=5)
    return out


def lm_cost_check(runs: dict, pins: dict) -> dict:
    """Hold :func:`lm_cost_runs` to the pins exactly."""
    assert runs["fractions"] == pins["fractions"], (runs["fractions"],
                                                    pins["fractions"])
    assert runs["families"] == pins["families"], (runs["families"],
                                                  pins["families"])
    assert len(runs["rows"]) == len(pins["rows"])
    for got, want in zip(runs["rows"], pins["rows"]):
        assert got == want, (got, want)
    assert runs["table"] == pins["table"]
    return {"rows": len(runs["rows"]), "equal": "exact"}


def lm_full_norm_err(got, want) -> float:
    """The largest leaf's ``|got - want| / |want|`` (norms, float64)."""
    worst = 0.0
    for a, b in zip(got, want):
        a = lm_dense(a).double()
        b = b.double()
        worst = max(worst, float((a - b).norm() / b.norm().clamp(min=1e-30)))
    return worst


def lm_dense(x):
    """A ``DTensor``'s whole value (a plain tensor as it is)."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def lm_timed(fn, dev):
    """``fn()`` with the card synchronised around it: (result, ms)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_sharded_step(cfg, tree, batch, mesh, dev) -> dict:
    """``loss_and_grads`` unsharded and on ``mesh`` (parameters placed by
    ``tree_shardings``, the batch by ``batch_shardings``, the forward
    under ``make_ctx``), each twice (the second timed): both losses, the
    largest leaf error, the ms of each, the collectives counted."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as SH
    from repro_torch.train import step as S
    from repro_torch.tree import leaves, map_tree

    def copy(t):
        return map_tree(lambda x: x.detach().clone(), t)

    batch = {k: torch.as_tensor(np.asarray(v), device=dev)
             for k, v in batch.items()}
    plain = copy(tree)
    S.loss_and_grads(plain, batch, cfg, device=dev)
    (loss, grads), plain_ms = lm_timed(
        lambda: S.loss_and_grads(plain, batch, cfg, device=dev), dev)
    del plain
    shard = SH.tree_shardings(tree, mesh, False)
    params = SH.distribute_tree(copy(tree), shard)
    dbatch = SH.distribute_tree(batch, SH.batch_shardings(batch, mesh,
                                                          False))
    ctx = SH.make_ctx(cfg, mesh, False)

    def sharded():
        with dctx.use(ctx):
            return S.loss_and_grads(params, dbatch, cfg, device=dev)

    sharded()
    with CommDebugMode() as comm:
        (dloss, dgrads), sharded_ms = lm_timed(sharded, dev)
    placed = all(isinstance(p, DTensor) and tuple(p.placements)
                 == s.placements(p.ndim)
                 for p, s in zip(leaves(params), leaves(shard)))
    assert placed, "a parameter is not placed by tree_shardings"
    g, dg = leaves(grads), leaves(dgrads)
    finite = all(bool(torch.isfinite(lm_dense(x)).all()) for x in dg)
    assert finite, "a sharded gradient is not finite"
    return {"loss": float(loss), "sharded_loss": float(lm_dense(dloss)),
            "loss_rel": abs(float(lm_dense(dloss)) - float(loss))
            / abs(float(loss)),
            "grad_leaf_rel": lm_full_norm_err(dg, g),
            "grad_max_abs": max(float((lm_dense(a).float() - b.float())
                                      .abs().max()) for a, b in zip(dg, g)),
            "ms": plain_ms, "sharded_ms": sharded_ms,
            "collectives": int(comm.get_total_counts()),
            "leaves": len(g), "grads": g, "sharded_grads": dg}


def lm_sharded_serve(cfg, tree, prompts, new: int, mesh, dev) -> dict:
    """A prefill and ``new`` greedy decode steps unsharded and with the
    weights under ``serve_param_spec``, the cache resharded by
    ``cache_shardings`` before each step: both token streams, the largest
    logit difference, each run's ms."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    def run(params, place=None):
        toks = torch.as_tensor(prompts, device=dev)
        if place:
            toks = place({"tokens": toks}, SH.batch_shardings(
                {"tokens": toks}, mesh, False))["tokens"]
        logits, cache = M.prefill(params, toks, cfg,
                                  max_len=prompts.shape[1] + new, device=dev)
        out, seen = [], [lm_dense(logits).float()]
        for _ in range(new):
            if place:
                cache = place(cache, SH.cache_shardings(cache, mesh, False,
                                                        cfg))
            nxt = lm_dense(logits).argmax(-1).to(torch.int32)
            out.append(nxt)
            if place:
                nxt = place({"t": nxt}, SH.batch_shardings(
                    {"t": nxt}, mesh, False))["t"]
            logits, cache = M.decode_step(params, cache, nxt, cfg,
                                          device=dev)
            seen.append(lm_dense(logits).float())
        return torch.cat(out, dim=1).cpu().numpy(), seen

    (want, want_logits), plain_ms = lm_timed(lambda: run(tree), dev)
    dparams = SH.distribute_tree(tree, SH.tree_shardings(tree, mesh, False,
                                                         serve=True))
    with dctx.use(SH.make_ctx(cfg, mesh, False)):
        (got, got_logits), sharded_ms = lm_timed(
            lambda: run(dparams, SH.distribute_tree), dev)
    return {"tokens_equal": bool(np.array_equal(got, want)),
            "tokens": got.tolist(),
            "logits_max_abs": max(float((a - b).abs().max()) for a, b in
                                  zip(got_logits, want_logits)),
            "ms": plain_ms, "sharded_ms": sharded_ms}


def lm_sharded_ep(get_config, mesh, dev) -> dict:
    """``moe_ffn`` of LM_SHARDED_EP_ARCH's smoke config (float32) under the
    mesh through the ``a2a`` path, and ``_moe_ep_psum`` called directly
    (a one-rank mesh always takes ``a2a``), against ``_moe_reference`` on
    the same weights and tokens: the largest differences."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(LM_SHARDED_EP_ARCH, smoke=True),
                              dtype="float32")
    p = M.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED),
                      device=dev).tree()["blocks"][0]["moe"]
    x = torch.randn((2, 8, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    x2 = x.reshape(-1, cfg.d_model)
    # moe_ffn without a context: the reference dispatch (+ the dense
    # branch where the config has one)
    want = {"a2a": L.moe_ffn(x, p, cfg).reshape(x2.shape),
            "psum": L._moe_reference(x2, p, cfg)}
    shard = SH.tree_shardings({"blocks": [{"moe": p}]}, mesh, False)
    dp = SH.distribute_tree(p, shard["blocks"][0]["moe"])
    ctx = SH.make_ctx(cfg, mesh, False)
    out = {}
    with dctx.use(ctx):
        dx = dctx.constrain(x, "act_btd")
        mode = L.moe_mode(x2.shape[0], cfg, ctx)
        assert mode == "a2a", mode
        got = {"a2a": lm_dense(L.moe_ffn(dx, dp, cfg)).reshape(x2.shape),
               "psum": lm_dense(L._moe_ep_psum(
                   dctx.constrain(x2, "tokens"), dp, cfg, ctx))}
    for name, y in got.items():
        torch.testing.assert_close(y, want[name], **LM_SHARDED_F32)
        out[name] = float((y - want[name]).abs().max())
    return {"arch": cfg.name, "tokens": x2.shape[0], "max_abs": out}


def lm_sharded_parts(dev, full_cfg, pinned_cfg, pinned_batch, get_config,
                     emit_part) -> dict:
    """Phase 17's ``lm_sharded`` parts on a one-rank group of ``dev``'s
    backend (NCCL on the card, gloo on the CPU; a ``FileStore``, no
    network) and its ``(1, 1)`` host mesh, torn down in a ``finally``:
    ``step`` (``full_cfg`` at bf16), ``pinned`` (``pinned_cfg`` in float32
    on ``pinned_batch``, the pins' batch), ``serve`` (``full_cfg``) and
    ``ep``.  ``emit_part(part, **fields)`` reports each; returns them."""
    import torch.distributed as dist
    from repro_torch import interop
    from repro_torch.launch.mesh import DEVICE_BACKEND, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.train import data as D
    from repro_torch.train import optimizer as O
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            DEVICE_BACKEND[dev.type], rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            mesh = make_host_mesh(2, device=dev)
            shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
            gen = torch.Generator(device=dev).manual_seed(LM_SEED)
            tree = M.init_params(full_cfg, gen, device=dev).tree()
            batch = D.make_batch(full_cfg, D.DataConfig(**LM_SHARDED_DATA),
                                 0)
            r = lm_sharded_step(full_cfg, tree, batch, mesh, dev)
            assert r["loss_rel"] <= LM_SHARDED_LOSS_TOL, r["loss_rel"]
            assert r["grad_leaf_rel"] <= LM_SHARDED_GRAD_TOL, r
            out["step"] = {k: v for k, v in r.items()
                           if k not in ("grads", "sharded_grads")}
            emit_part("step", model=full_cfg.name,
                      layers=full_cfg.n_layers, dtype=full_cfg.dtype,
                      data=LM_SHARDED_DATA, mesh=shape, **out["step"],
                      tolerance={"loss": LM_SHARDED_LOSS_TOL,
                                 "grad_leaf": LM_SHARDED_GRAD_TOL})
            del r
            ptree = interop.lm_params(lm_numpy_params(
                pinned_cfg, np.random.default_rng(LM_SEED)), pinned_cfg, dev)
            r = lm_sharded_step(pinned_cfg, ptree, pinned_batch["batch"],
                                mesh, dev)
            norm = float(O.global_norm(r["sharded_grads"]))
            np.testing.assert_allclose(r["sharded_loss"],
                                       pinned_batch["loss"],
                                       rtol=LM_TRAIN_LOSS_TOL[0])
            np.testing.assert_allclose(norm, pinned_batch["grad_norm"],
                                       rtol=LM_TRAIN_NORM_TOL)
            for a, b in zip(r["sharded_grads"], r["grads"]):
                torch.testing.assert_close(lm_dense(a), b, **LM_SHARDED_F32)
            out["pinned"] = {
                "loss": r["sharded_loss"], "pin_loss": pinned_batch["loss"],
                "loss_rel_to_pin": abs(r["sharded_loss"]
                                       - pinned_batch["loss"])
                / pinned_batch["loss"],
                "grad_norm": norm, "pin_grad_norm": pinned_batch["grad_norm"],
                "grad_max_abs_to_unsharded": r["grad_max_abs"],
                "ms": r["ms"], "sharded_ms": r["sharded_ms"]}
            emit_part("pinned", model=pinned_cfg.name,
                      layers=pinned_cfg.n_layers, dtype=pinned_cfg.dtype,
                      **out["pinned"],
                      tolerance={"loss": LM_TRAIN_LOSS_TOL[0],
                                 "grad_norm": LM_TRAIN_NORM_TOL,
                                 "grads": LM_SHARDED_F32})
            del r, ptree
            prompts = np.random.default_rng(LM_SEED).integers(
                0, full_cfg.vocab, (2, LM_SHARDED_PROMPT), dtype=np.int32)
            out["serve"] = lm_sharded_serve(full_cfg, tree, prompts,
                                            LM_SHARDED_NEW, mesh, dev)
            assert out["serve"]["tokens_equal"], out["serve"]
            emit_part("serve", model=full_cfg.name, prompts=[2,
                      LM_SHARDED_PROMPT], new_tokens=LM_SHARDED_NEW,
                      **out["serve"])
            del tree
            out["ep"] = lm_sharded_ep(get_config, mesh, dev)
            emit_part("ep", **out["ep"], tolerance=LM_SHARDED_F32)
        finally:
            dist.destroy_process_group()
    return out


def run_lm_mesh_phase(card, dev) -> dict:
    """Phase 17: ``lm_cost`` (``pattern_fractions`` on the card, 4
    ``dram_timing`` launches, held to the host route and ``repro``'s pins
    exactly; the traces at LM_COST_LINES against ``simulate_trace``;
    every family's fraction and the roofline rows against the pins) and
    ``lm_sharded`` (:func:`lm_sharded_parts` on a one-rank NCCL group;
    one card, so no number here comes from more than one).  Returns the
    launches by part and the seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core import hbm_adapter as H
    from repro_torch.kernels import launch_counts, zero_launch_counts
    t_phase = time.perf_counter()
    pins = lm_cost_load_pins()
    launches = {}
    torch.cuda.synchronize()
    zero_launch_counts()
    t0 = time.perf_counter()
    fr = H.pattern_fractions(device=dev)
    launches["lm_cost"] = launch_counts()
    fractions_s = time.perf_counter() - t0
    assert launches["lm_cost"]["dram_timing"] == 4, launches["lm_cost"]
    host = H.pattern_fractions(device="cpu")
    assert fr == host == pins["fractions"], (fr, host, pins["fractions"])
    runs = lm_cost_runs(lm_cost_port_api(dev))
    got = lm_cost_check(runs, pins)
    emit(phase="lm_cost", part="fractions", fractions=fr,
         families=runs["families"], equal="pins and host route, exact",
         dram_timing_launches=launches["lm_cost"]["dram_timing"],
         seconds=fractions_s, card=card)
    emit(phase="lm_cost", part="roofline", mesh=LM_COST_MESH[0],
         chips=LM_COST_MESH[1],
         collective_bytes_per_chip=LM_COST_COLLECTIVE_BYTES, **got,
         dominant={r["arch"] + "/" + r["shape"]: r["dominant"]
                   for r in runs["rows"]}, card=card)
    zero_launch_counts()
    traces = lm_cost_traces(dev)
    launches["lm_cost_traces"] = launch_counts()
    assert launches["lm_cost_traces"]["dram_timing"] == 4, launches
    for name, ms in lm_cost_kernel_ms(dev).items():
        traces[name]["kernel_ms"] = ms
    emit(phase="lm_cost", part="traces", lines=LM_COST_LINES,
         patterns=traces, card=card)
    pins16 = lm_train_load_pins()["pinned"]
    pinned = {"batch": {k: np.asarray(pins16["batches"][0][k], np.int32)
                        for k in ("tokens", "labels")},
              "loss": pins16["loss"], "grad_norm": pins16["grad_norm"]}
    zero_launch_counts()
    sharded = lm_sharded_parts(
        dev, get_config(LM_ARCH), lm_pinned_config(get_config), pinned,
        get_config, lambda part, **kw: emit(phase="lm_sharded", part=part,
                                            cards=1, card=card, **kw))
    launches["lm_sharded"] = launch_counts()
    assert not any(launches["lm_sharded"].values()), launches["lm_sharded"]
    seconds = time.perf_counter() - t_phase
    emit(phase="lm_mesh", part="total", seconds=seconds, launches=launches,
         card=card)
    return {"launches": launches, "seconds": seconds, "traces": traces,
            "sharded": sharded}


LM_DRYRUN_ARCH = "qwen3_0_6b"
#: cells beyond LM_DRYRUN_ARCH's: the recurrences' 32k prefills (counted
#: by a few iterations, ``models.ssm.scan``) and xlstm-1.3b's multi-pod
#: train step, cut in depth to one group of its published 7:1 mLSTM /
#: sLSTM blocks (8 of 48 layers; the widths as published):
#: ``(arch, shape, multi_pod, layers)``
LM_DRYRUN_MORE = [("hymba_1_5b", "prefill_32k", False, None),
                  ("xlstm_1_3b", "prefill_32k", False, None),
                  ("xlstm_1_3b", "train_4k", True, 8)]
LM_DRYRUN_PINS = ROOT / "tools" / "lm_dryrun_pins.json"
LM_DRYRUN_TIMEOUT_S = 600
LM_TRAIN_MESH_ARGV = ["--arch", LM_ARCH, "--steps", "4", "--seq-len", "256",
                      "--global-batch", "2", "--save-every", "2"]
LM_TRAIN_MESH_TOL = 1e-6


def lm_dryrun_start(out_dir: str, more: bool = False) -> list:
    """Start ``launch.dryrun`` on the card: on every cell of LM_DRYRUN_ARCH
    over both production meshes, one process a cell (``long_500k``'s two,
    which the shape rules skip, in one), or with ``more`` on each cell of
    LM_DRYRUN_MORE.  Returns ``(name, process, report path, log, end,
    layers)`` for each; a thread fills ``end`` with the process's exit
    code and seconds when it exits."""
    from repro_torch.launch.specs import SHAPES
    runs = []
    for shape in () if more else SHAPES:
        meshes = ([["--both-meshes"]] if shape == "long_500k"
                  else [[], ["--multi-pod"]])
        for extra in meshes:
            runs.append((LM_DRYRUN_ARCH, shape, extra, None))
    for arch, shape, multi_pod, layers in LM_DRYRUN_MORE if more else ():
        extra = ["--multi-pod"] * multi_pod
        if layers is not None:
            extra += ["--layers", str(layers)]
        runs.append((arch, shape, extra, layers))
    jobs = []
    for arch, shape, extra, layers in runs:
        name = f"{arch}.{shape}" + "".join(extra).replace("--", "@")
        out = os.path.join(out_dir, name + ".json")
        log = open(os.path.join(out_dir, name + ".log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, *extra,
             "--out", out], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        t0 = time.perf_counter()
        ended = {}
        waiter = threading.Thread(
            target=lambda p=proc, e=ended, t=t0: e.update(
                rc=p.wait(), seconds=time.perf_counter() - t),
            daemon=True)
        waiter.start()
        jobs.append((name, proc, out, log, ended, layers))
    return jobs


def lm_dryrun_finish(jobs, card) -> dict:
    """Wait for :func:`lm_dryrun_start`'s processes and hold every cell to
    the pins: admitted cells ``ok``, argument and output bytes exact, and
    temp bytes exact where the cell's collectives are the pins'."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import shape_supported
    pins = json.loads(LM_DRYRUN_PINS.read_text())
    more = {(a, s, "2x16x16" if mp else "16x16"): n
            for a, s, mp, n in LM_DRYRUN_MORE}
    pinned = {}
    for c in pins["port"] + pins["cuts"]:
        key = (c["arch"], c["shape"], c["mesh"], c.get("layers"))
        if c["arch"] == LM_DRYRUN_ARCH or more.get(key[:3], 0) == key[3]:
            pinned[key] = c
    cells = {}
    try:
        for name, proc, out, log, ended, layers in jobs:
            proc.wait(timeout=LM_DRYRUN_TIMEOUT_S)
            log.close()
            time.sleep(0.1)                 # the waiter records the end
            with open(out) as f:
                for c in json.load(f):
                    c["process_seconds"] = ended.get("seconds")
                    cells[(c["arch"], c["shape"], c["mesh"], layers)] = c
    finally:
        for _, proc, _, log, _, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    assert set(cells) == set(pinned), (sorted(cells), sorted(pinned))
    logs = {}
    for name, _, _, log, _, _ in jobs:
        with open(log.name) as f:
            logs[name] = f.read()
    bad = []
    for key, c in sorted(cells.items(), key=str):
        arch, shape, mesh, layers = key
        pin = pinned[key]
        admitted, _ = shape_supported(get_config(arch), shape)
        if (c["status"] != ("ok" if admitted else "skipped")
                or pin["status"] != c["status"]):
            bad.append((key, c["status"], c["reason"], [
                text[-3000:] for name, text in logs.items()
                if name.startswith(f"{arch}.{shape}") and "FAIL" in text]))
        # the temp bytes follow the collectives DTensor plans, which a
        # ``cuda`` mesh may plan otherwise (an all-to-all where a ``cpu``
        # mesh all-gathers): held exactly where the plan is the pins'
        same_plan = all(c[f] == pin[f] for f in ("collective_bytes",
                                                 "collective_counts"))
        fields = ["arg_bytes_per_device", "output_bytes_per_device"]
        fields += ["temp_bytes_per_device"] * same_plan
        for field in fields:
            if c[field] != pin[field]:
                bad.append((key, field, c[field], pin[field]))
        emit(phase="lm_dryrun", arch=arch, shape=shape, mesh=mesh,
             cut=(f"{layers} of {get_config(arch).n_layers} layers, "
                  "widths as published" if layers else None),
             status=c["status"],
             arg_bytes=c["arg_bytes_per_device"],
             output_bytes=c["output_bytes_per_device"],
             equal_to_pins=("argument, output and temp bytes, exact (the "
                            "pins' collectives)" if same_plan else
                            "argument and output bytes, exact (other "
                            "collectives than the pins')"),
             temp_bytes=c["temp_bytes_per_device"],
             cpu_pin_temp_bytes=pin["temp_bytes_per_device"],
             collective_bytes=c["collective_bytes"],
             cpu_pin_collective_bytes=pin["collective_bytes"],
             collective_counts=c["collective_counts"],
             cpu_pin_collective_counts=pin["collective_counts"],
             flops=c["flops"], hlo_bytes=c["hlo_bytes"],
             seconds=c["compile_seconds"],
             cpu_pin_seconds=pin["compile_seconds"],
             process_seconds=c["process_seconds"], card=card)
    return cells, bad


def lm_train_mesh_runs(dev, tmp: str) -> dict:
    """qwen3-0.6b as published through ``launch.train.main``: 4 steps
    saving every 2 on a one-rank NCCL group (the mesh path) and with no
    group; then each resumed from its step-2 checkpoint (4 more steps,
    none saved).  Each step timed with the card synchronised."""
    import torch.distributed as dist
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import DEVICE_BACKEND
    made = LT.make_train_step
    step_ms = []

    def timed_steps(*a, **kw):
        step = made(*a, **kw)

        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def train(where, resume=False):
        d = os.path.join(tmp, where)
        if resume:
            for f in os.listdir(d):
                if f != "ckpt_00000002.npz":
                    os.unlink(os.path.join(d, f))
        argv = LM_TRAIN_MESH_ARGV + ["--ckpt-dir", d]
        if resume:
            argv[argv.index("--save-every") + 1] = "1000"
        del step_ms[:]
        t0 = time.perf_counter()
        losses = LT.main(argv)
        got = {"losses": losses, "step_ms": list(step_ms),
               "seconds": time.perf_counter() - t0,
               "files": sorted(os.listdir(d))}
        if resume:              # a full-width checkpoint is 7.2 GB
            shutil.rmtree(d)
        return got

    LT.make_train_step = timed_steps
    try:
        out = {}
        dist.init_process_group(
            DEVICE_BACKEND[dev.type], rank=0, world_size=1,
            store=dist.FileStore(os.path.join(tmp, "store"), 1))
        try:
            out["mesh"] = train("mesh")
            out["mesh_resumed"] = train("mesh", resume=True)
        finally:
            dist.destroy_process_group()
        out["single"] = train("single")
        out["single_resumed"] = train("single", resume=True)
        return out
    finally:
        LT.make_train_step = made


def run_lm_dryrun_phase(card, dev, early=()) -> dict:
    """Phase 18: ``lm_dryrun`` (:func:`lm_dryrun_start`'s processes, on
    the card's host while the training runs, read with ``early``'s, the
    LM_DRYRUN_MORE processes started at phase 15) and ``lm_train_mesh``
    (:func:`lm_train_mesh_runs`); the port launches no kernel here.
    Returns the launches, the cells and the seconds."""
    from repro_torch.kernels import launch_counts, zero_launch_counts
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = lm_dryrun_start(tmp)
        try:
            runs = lm_train_mesh_runs(dev, tmp)
        finally:
            cells, bad = lm_dryrun_finish(list(early) + jobs, card)
    launches = {"lm_dryrun": launch_counts()}
    mesh, single = runs["mesh"], runs["single"]
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh["losses"],
                                               single["losses"])]
    emit(phase="lm_train_mesh", model=LM_ARCH, argv=LM_TRAIN_MESH_ARGV,
         mesh={"data": 1, "model": 1}, group="nccl, one rank",
         losses=mesh["losses"], unsharded_losses=single["losses"],
         loss_rel=rel, tolerance=LM_TRAIN_MESH_TOL,
         step_ms=mesh["step_ms"], unsharded_step_ms=single["step_ms"],
         run_seconds=mesh["seconds"], unsharded_run_seconds=single["seconds"],
         resumed_losses=runs["mesh_resumed"]["losses"],
         unsharded_resumed_losses=runs["single_resumed"]["losses"],
         resume_equal="steps 3-4, exact", card=card)
    assert not bad, bad
    assert not any(launches["lm_dryrun"].values()), launches
    assert len(rel) == 4 and max(rel) <= LM_TRAIN_MESH_TOL, (mesh, single)
    assert mesh["files"] == single["files"] == [
        "ckpt_00000002.npz", "ckpt_00000004.npz"], (mesh, single)
    for name in ("mesh", "single"):
        resumed = runs[name + "_resumed"]["losses"]
        assert resumed[:2] == runs[name]["losses"][2:4], (name, runs)
    seconds = time.perf_counter() - t_phase
    emit(phase="lm_dryrun", part="total", seconds=seconds,
         cells={"/".join(map(str, k)): c["status"]
                for k, c in sorted(cells.items(), key=str)},
         launches=launches, card=card)
    return {"launches": launches, "seconds": seconds, "cells": cells,
            "train": runs}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms import edge_centric
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import accel
    from repro_torch.core.dram import PRESETS
    from repro_torch.graphs.datasets import instantiate
    from repro_torch.graphs.generators import rmat
    from repro_torch.kernels import build, launch_counts, zero_launch_counts
    from repro_torch.kernels.dram_timing.ops import (chunk_steps, dram_serve,
                                                     serve_prepass,
                                                     serve_records)
    from repro_torch.kernels.dram_timing.ref import serve_prepass_ref
    from repro_torch.sim import SimSession, get_accelerator, simulate
    from repro_torch.sim.session import resolve_run_config
    from repro_torch.kernels.dram_timing.ref import dram_serve_ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=str(lib_path.relative_to(ROOT)))

    # ---- 3. kernels vs plain on random programs -----------------------
    worst, launches0 = 0, dram_serve.launches
    cases = 0
    for preset in ("hitgraph", "accugraph", "hbm2", "hbm2e"):
        cfg = PRESETS[preset]()
        for hit_heavy in (False, True):
            rng = np.random.default_rng(100 + cases)
            packed = accel.pack_program(random_program(rng, hit_heavy), cfg)
            state = cold_state(packed, cfg.channels, dev)
            split = packed.n_steps // 2 + 1
            diff, _, _ = serve_both(packed, 0, len(packed.boundary), split,
                                    state, dev)
            worst = max(worst, diff)
            cases += 1
    assert worst == 0, f"dram_serve differs from its plain version: {worst}"
    meta_worst = any_meta_serve(dev)
    assert meta_worst == 0, (
        f"dram_serve differs from its plain version on any-meta blocks: "
        f"{meta_worst}")
    batch = check_serve_batch(dev)
    batch_err = batch["dram_serve_batch_max_abs_diff"]
    emit(phase="kernels", tolerance="exact", dram_serve_cases=cases,
         dram_serve_launches=dram_serve.launches - launches0,
         max_abs_diff=worst, any_meta_max_abs_diff=meta_worst,
         **check_sweep(dev), **check_dram_timing(dev),
         **check_cache_lookup(dev), **batch)
    emit(phase="kernels", kernels=["segment_reduce", "edge_scatter",
                                   "spmv_ell"],
         tolerance={"min/max, edge_scatter": "exact",
                    "f32 sum, spmv_ell": "rtol 1e-5, atol 1e-4",
                    "spmv_sell": "rtol 1e-5, atol 1e-6",
                    "bf16 sum": "rtol 5e-2, atol 5e-2"},
         **check_stationary_kernels(dev))

    # ---- 4. goldens on the card ---------------------------------------
    golden = json.loads(
        (ROOT / "tests" / "goldens" / "simreports.json").read_text())
    graphs = {"rmat7": rmat(7, 4, seed=101).undirected_view(),
              "rmat8": rmat(8, 5, seed=102).undirected_view()}
    # the reference machine runs on its paper default memory and config
    memories = {"hitgraph": ("ddr3", "hbm2"),
                "accugraph": ("ddr4", "ddr4-8gb", "hbm2"),
                "reference": (None,)}
    overrides = {"hitgraph": {"partition_elements": 64},
                 "accugraph": {"partition_elements": 64}, "reference": {}}
    checked, bad = 0, []
    for gname, gg in graphs.items():
        for acc, mems in memories.items():
            for mem in mems:
                for prob in ("wcc", "bfs"):
                    key = f"{gname}/{acc}/{mem or 'default'}/{prob}"
                    r = simulate(gg, prob, accelerator=acc, memory=mem,
                                 **overrides[acc])
                    if digest(r) != golden[key]:
                        bad.append(key)
                    checked += 1
    assert not bad, f"golden digests differ on the card: {bad}"
    assert checked == 24, checked
    emit(phase="goldens", checked=checked, mismatched=len(bad))
    paths = sweep_paths(dev, card)

    # ---- 5. the main path at full size --------------------------------
    t0 = time.perf_counter()
    wt = instantiate("wt", 1.0).undirected_view()
    emit(phase="graph", name=wt.name, vertices=wt.n, edges=wt.m,
         seconds=time.perf_counter() - t0)
    sessions, reports = {}, {}
    zero_launch_counts()
    accel.zero_pack_route_counts()
    for acc in ("hitgraph", "accugraph"):
        sessions[acc] = SimSession(wt)
        t0 = time.perf_counter()
        reports[acc] = sessions[acc].run("wcc", acc)
        reports[acc].stage_seconds["total"] = time.perf_counter() - t0
    launches = {"main": launch_counts()}
    routes = {"main": accel.pack_route_counts()}
    # every program of the path packed on the card, none on the host
    assert routes["main"] == {"device_pack": 2, "host_pack": 0}, routes
    for name in ("dram_serve", "serve_prepass", "sweep_min_rounds"):
        assert launches["main"][name] > 0, (
            f"{name} was never launched on the main path")
    # one round-kernel launch a sweep (AccuGraph's 5 WCC sweeps of its one
    # block), never the serial route; one serve a program
    want = {"sweep_min_rounds": MAIN_EXPECT["accugraph"][0], "sweep_min": 0,
            "dram_serve": 2, "serve_prepass": 2}
    assert {k: launches["main"][k] for k in want} == want, launches["main"]
    for acc, r in reports.items():
        assert r.runtime_ns == PINNED_RUNTIME_NS["main", acc], (
            acc, r.runtime_ns)

    # ---- 6. the dynamic path at full size -------------------------------
    zero_launch_counts()
    accel.zero_pack_route_counts()
    apply_phases = {}
    dyn = {acc: run_dynamic_path(wt, acc, sessions[acc], reports[acc], card,
                                 apply_phases)
           for acc in DYNAMIC_CASES}
    launches["dynamic"] = launch_counts()
    routes["dynamic"] = accel.pack_route_counts()
    # one program an epoch (epoch 0 included), each packed on the card
    assert routes["dynamic"] == {
        "device_pack": sum(r.n_epochs for r in dyn.values()),
        "host_pack": 0}, routes
    for name in ("dram_serve", "dram_timing", "sweep_min_rounds"):
        assert launches["dynamic"][name] > 0, (
            f"{name} was never launched on the dynamic path")
    # one chunked scan a rewrite phase, never the serial kernel
    assert launches["dynamic"]["dram_timing_serial"] == 0, launches["dynamic"]
    assert launches["dynamic"]["dram_timing"] == sum(
        len(r.epochs) - 1 for r in dyn.values()), launches["dynamic"]

    # ---- 7. the stationary path at full size ----------------------------
    accel.zero_pack_route_counts()
    launches["stationary"], stat_runs = run_stationary_path(
        wt, sessions, card, dev)
    routes["stationary"] = accel.pack_route_counts()
    assert routes["stationary"] == {
        "device_pack": 2 * len(STATIONARY), "host_pack": 0}, routes

    # ---- 7b. the cached main path and a cached dynamic run --------------
    launches["cache"], lookup_calls = run_cache_path(sessions, card, dev)
    cached_dyn = run_cached_dynamic(wt, sessions["accugraph"], card)
    emit(phase="pack_routes", routes=routes, card=card)
    # one pull launch an iteration: 2 AccuGraph runs x STATIONARY_ITERS
    assert launches["stationary"]["spmv_ell"] == 2 * STATIONARY_ITERS, (
        launches["stationary"])

    # ---- 8. kernels vs plain on the paths' inputs ----------------------
    kernels = {}
    for acc in ("hitgraph", "accugraph"):
        sess, r = sessions[acc], reports[acc]
        spec = get_accelerator(acc)
        cfg = resolve_run_config(spec)
        run = sess.algorithm_run(spec, Problem.WCC, cfg, 0, None, dev)
        program = sess.model_for(spec, cfg).build_program(Problem.WCC, run)
        t0 = time.perf_counter()
        packed = accel.pack_program(program, cfg.dram_config())
        host_pack_s = time.perf_counter() - t0
        emit(phase="device_pack", accelerator=acc, card=card,
             **compare_device_pack(program, cfg.dram_config(), packed,
                                   host_pack_s, dev))
        S, C, K = packed.issue.shape
        want_iters, want_steps = MAIN_EXPECT[acc]
        assert np.isfinite(r.runtime_ns) and r.runtime_ns > 0
        assert (r.iterations, packed.n_steps) == (want_iters, want_steps), (
            acc, r.iterations, packed.n_steps)
        assert r.total_requests == len(program)
        emit(phase="main", accelerator=acc, memory=cfg.dram_config().name,
             iterations=r.iterations, requests=r.total_requests,
             n_steps=packed.n_steps, shape=[S, C, K],
             runtime_ns=r.runtime_ns, row_hit_rate=r.row_hit_rate,
             stage_seconds=r.stage_seconds, card=card)
        # the full program, timed as the main path calls the kernel
        full = [i32(a, dev) for a in (packed.issue, packed.meta,
                                      packed.boundary, packed.timing)]
        cold = cold_state(packed, C, dev)
        full_ms = cuda_ms(lambda: dram_serve(*full, cold), reps=2)
        B, R = packed.n_banks, cold[3].shape[1]
        # its two launches apart, and its finishes and carry against
        # those of the serve's first design on the card
        T = chunk_steps(C, K)
        rec = serve_prepass(*full, B // R, R, T)
        prepass_ms = cuda_ms(
            lambda: serve_prepass(*full, B // R, R, T), reps=5)
        records_ms = cuda_ms(lambda: serve_records(rec, full[3], cold, S),
                             reps=2)
        fin_full, st_full = serve_records(rec, full[3], cold, S)
        got_digest = serve_digest(fin_full, st_full)
        assert got_digest == PINNED_SERVE_DIGEST[acc], (
            f"dram_serve's full {acc} program differs from the pinned "
            f"finishes: {got_digest}")
        del rec, fin_full
        # a window of the real program crossing its first phase boundary,
        # started from the kernel's own carry at the window's start
        W = 8192
        first_bnd = int(np.flatnonzero(packed.boundary)[0])
        lo = max(0, first_bnd - W // 2)
        _, st = dram_serve(*(x[:lo].contiguous() for x in full[:3]),
                           full[3], cold)
        diff, win, timing = serve_both(packed, lo, lo + W, lo + W // 2,
                                       st, dev)
        assert diff == 0, f"dram_serve differs on the {acc} window: {diff}"
        win_ms = cuda_ms(lambda: dram_serve(*win, timing, st), reps=5)
        plain_ms = host_ms(lambda: dram_serve_ref(*win, timing, st))
        win_rec = serve_prepass(*win, timing, B // R, R, T)
        rec_p = serve_prepass_ref(*win, timing, B // R, R, win_rec.shape[1])
        diff = max(diff, max_abs_diff(win_rec, rec_p))
        assert diff == 0, f"serve_prepass differs on the {acc} window"
        prepass_win_ms = cuda_ms(
            lambda: serve_prepass(*win, timing, B // R, R, T), reps=5)
        prepass_plain_ms = cuda_ms(
            lambda: serve_prepass_ref(*win, timing, B // R, R,
                                      win_rec.shape[1]), reps=3)
        k = kernels.setdefault("dram_serve", {"max_abs_err": 0,
                                              "windows": {}})
        k["max_abs_err"] = max(k["max_abs_err"], diff)
        k["windows"][acc] = {
            "steps": W, "shape": [W, C, K], "ms": win_ms,
            "plain_ms": plain_ms,
            "bound_ms": serve_bytes(W, C, K, B, R) / HBM_BYTES_PER_S * 1e3,
            "prepass_ms": prepass_win_ms,
            "prepass_plain_ms": prepass_plain_ms,
            "prepass_bound_ms": prepass_bytes(W, C, K, T)
            / HBM_BYTES_PER_S * 1e3,
            "full_program": {"shape": [S, C, K], "ms": full_ms,
                             "prepass_ms": prepass_ms,
                             "records_ms": records_ms,
                             "us_per_step": records_ms * 1e3 / S,
                             "digest": got_digest,
                             "bound_ms": serve_bytes(S, C, K, B, R)
                             / HBM_BYTES_PER_S * 1e3,
                             "prepass_bound_ms": prepass_bytes(S, C, K, T)
                             / HBM_BYTES_PER_S * 1e3}}
        del full, win

    kernels["sweep_min_rounds"] = sweep_main_block(wt, sessions, dev, card)

    # ---- CPU cross-check of the card's edge-centric run at full size ---
    t0 = time.perf_counter()
    run_cpu = edge_centric.run(wt.with_unit_weights(), Problem.WCC,
                               device="cpu")
    run_gpu = sessions["hitgraph"].algorithm_run(
        get_accelerator("hitgraph"), Problem.WCC,
        resolve_run_config(get_accelerator("hitgraph")), 0, None, dev)
    assert run_cpu.iterations == run_gpu.iterations
    assert np.array_equal(run_cpu.values, run_gpu.values)
    assert all(np.array_equal(a.changed, b.changed)
               for a, b in zip(run_cpu.per_iter, run_gpu.per_iter))
    emit(phase="edge_centric_cross_check", iterations=run_gpu.iterations,
         seconds=time.perf_counter() - t0)

    kernels["dram_timing"] = compare_dram_timing(apply_phases, dev)
    del apply_phases
    kernels.update(compare_stationary(wt, stat_runs, dev))

    # ---- 9. the event-driven side -------------------------------------
    t_event = time.perf_counter()
    launches["trace"] = check_trace(card)
    launches["event"] = run_event_main(sessions, reports, card)
    launches["reference"] = run_reference(card, dev)
    run_analytical(wt, reports, card)
    launches["study"] = run_study_line(card, dev)
    event_s = time.perf_counter() - t_event

    # ---- 10. the sweep engine ------------------------------------------
    swept = run_sweep_phase(wt, card, dev)
    launches.update(swept["launches"])

    # ---- 11. the corpus -------------------------------------------------
    corp = run_corpus_phase(card, dev)
    launches.update({f"corpus_{part}": counts
                     for part, counts in corp["launches"].items()})

    # ---- 12. the service and the tuner ----------------------------------
    served = run_service_phase(card, dev)
    launches.update({f"service_{part}": counts
                     for part, counts in served["launches"].items()})

    # ---- 13. the lock witness -------------------------------------------
    witnessed = run_lock_witness_phase(card, dev, wt, reports)
    launches.update({f"lock_{part}": counts
                     for part, counts in witnessed["launches"].items()})

    # ---- 14. the distributed engine and devices=N ------------------------
    distributed = run_distributed_phase(wt, sessions, swept, card, dev)
    launches.update({f"distributed_{part}": counts
                     for part, counts in distributed["launches"].items()})

    # phase 18's longest dry-run cells (fake tensors, one host core each)
    # run on the card's host beside phases 15-17
    dry_dir = tempfile.mkdtemp(prefix="lm_dryrun_")
    early = lm_dryrun_start(dry_dir, more=True)
    try:
        # ---- 15. the LM serve path ---------------------------------------
        lm = run_lm_phase(card, dev)

        # ---- 16. LM training ---------------------------------------------
        lm_train = run_lm_train_phase(card, dev)

        # ---- 17. the LM cost tooling and the LM on a mesh ----------------
        lm_mesh = run_lm_mesh_phase(card, dev)
        launches.update(lm_mesh["launches"])

        # ---- 18. the dry run and training on a mesh ----------------------
        lm_dry = run_lm_dryrun_phase(card, dev, early)
        launches.update(lm_dry["launches"])
    finally:
        for _, proc, _, log, _, _ in early:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(dry_dir, ignore_errors=True)
    emit(phase="wall", seconds=time.perf_counter() - t_start,
         event_phase_seconds=event_s, sweep_phase_seconds=swept["seconds"],
         corpus_phase_seconds=corp["seconds"],
         service_phase_seconds=served["seconds"],
         lock_witness_phase_seconds=witnessed["seconds"],
         distributed_phase_seconds=distributed["seconds"],
         lm_phase_seconds=lm["seconds"],
         lm_train_phase_seconds=lm_train["seconds"],
         lm_mesh_phase_seconds=lm_mesh["seconds"],
         lm_dryrun_phase_seconds=lm_dry["seconds"], card=card)

    ds = kernels["dram_serve"]
    hw = ds["windows"]["hitgraph"]
    dt = kernels["dram_timing"]
    sw = kernels["sweep_min_rounds"]
    by_path = {name: {path: counts[name] for path, counts in launches.items()}
               for name in KERNELS}
    table = [
        {"name": "dram_serve", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_serve.cu",
         "replaces": "src/repro/kernels/dram_timing/kernel.py:210",
         "launches": launches["main"]["dram_serve"],
         "launches_by_path": by_path["dram_serve"],
         "max_abs_err": ds["max_abs_err"],
         "ms": hw["ms"], "plain_ms": hw["plain_ms"],
         "bound_ms": hw["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "inputs": "hitgraph main-path window",
         "windows": ds["windows"]},
        {"name": "dram_timing", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_timing.cu",
         "replaces": "src/repro/kernels/dram_timing/kernel.py:117",
         "launches": launches["dynamic"]["dram_timing"],
         "launches_by_path": by_path["dram_timing"],
         "max_abs_err": max(d["max_abs_err"] for d in dt.values()),
         "ms": dt["hitgraph"]["window"]["ms"],
         "plain_ms": dt["hitgraph"]["window"]["plain_ms"],
         "bound_ms": dt["hitgraph"]["window"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "inputs": "hitgraph ep1_apply window",
         "full_phases": {acc: d["full_phase"] for acc, d in dt.items()},
         "windows": {acc: d["window"] for acc, d in dt.items()},
         "lm_cost_traces": {name: {k: t[k] for k in (
             "shape", "kernel_ms", "device_call_ms", "host_ms", "bound_ms")}
             for name, t in lm_mesh["traces"].items()}},
        {"name": "dram_timing_serial", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_timing_serial.cu",
         "replaces": "src/repro/kernels/dram_timing/kernel.py:117",
         "launches": launches["dynamic"]["dram_timing_serial"],
         "launches_by_path": by_path["dram_timing_serial"],
         "max_abs_err": max(d["max_abs_err"] for d in dt.values()),
         "ms": dt["hitgraph"]["window"]["serial_ms"],
         "plain_ms": dt["hitgraph"]["window"]["plain_ms"],
         "bound_ms": dt["hitgraph"]["window"]["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "inputs": "hitgraph ep1_apply window",
         "full_phase_ms": {acc: d["full_phase"]["serial_ms"]
                           for acc, d in dt.items()}},
        {"name": "serve_prepass", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_serve.cu",
         "replaces": "src/repro/kernels/dram_timing/kernel.py:210",
         "launches": launches["main"]["serve_prepass"],
         "launches_by_path": by_path["serve_prepass"],
         "max_abs_err": ds["max_abs_err"],
         "ms": hw["prepass_ms"], "plain_ms": hw["prepass_plain_ms"],
         "bound_ms": hw["prepass_bound_ms"], "bound_by": "bytes",
         "library_ms": None, "inputs": "hitgraph main-path window",
         "full_program_ms": {acc: w["full_program"]["prepass_ms"]
                             for acc, w in ds["windows"].items()},
         "full_program_bound_ms": {
             acc: w["full_program"]["prepass_bound_ms"]
             for acc, w in ds["windows"].items()}},
        {"name": "sweep_min_rounds", "route": "cuda",
         "source": "src/repro_torch/csrc/sweep_min_rounds.cu",
         "replaces": "src/repro/algorithms/vertex_centric.py:41",
         "launches": launches["main"]["sweep_min_rounds"],
         "launches_by_path": by_path["sweep_min_rounds"],
         "max_abs_err": sw["max_abs_err"], "ms": sw["ms"],
         "call_ms": sw["call_ms"],
         "rounds": sw["rounds"], "plain_ms": sw["plain_ms"],
         "bound_ms": sw["bound_ms"], "bound_by": "bytes",
         "rounds_bound_ms": sw["rounds_bound_ms"],
         "library_ms": None,
         "inputs": "accugraph main-path block, first WCC sweep",
         "sweeps": sw["sweeps"], "pack_ms": sw["pack_ms"],
         "paths": paths, "shape": sw["shape"]},
        {"name": "sweep_min", "route": "cuda",
         "source": "src/repro_torch/csrc/sweep_min.cu",
         "replaces": "src/repro/algorithms/vertex_centric.py:41",
         "launches": launches["main"]["sweep_min"],
         "launches_by_path": by_path["sweep_min"],
         "max_abs_err": sw["max_abs_err"], "ms": sw["serial_route_ms"],
         "plain_ms": sw["plain_ms"], "bound_ms": sw["serial_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "inputs": "accugraph main-path block, first WCC sweep",
         "shape": sw["shape"]},
    ]
    sw_win, sw_serve = swept["window"], swept["serve"]
    table += [
        {"name": "dram_serve_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_serve.cu",
         "replaces": "src/repro/core/vectorized.py:798",
         "launches": launches["sweep"]["dram_serve_batch"],
         "launches_by_path": by_path["dram_serve_batch"],
         "max_abs_err": max(sw_win["max_abs_err"], batch_err),
         "ms": sw_win["ms"], "plain_ms": sw_win["plain_ms"],
         "bound_ms": sw_win["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "inputs": f"hitgraph main-path window, {sw_win['M']} timing "
                   "cases sharing the program",
         "full_programs": sw_serve},
        {"name": "serve_prepass_batch", "route": "cuda",
         "source": "src/repro_torch/csrc/dram_serve.cu",
         "replaces": "src/repro/core/vectorized.py:798",
         "launches": launches["sweep"]["serve_prepass_batch"],
         "launches_by_path": by_path["serve_prepass_batch"],
         "max_abs_err": max(sw_win["max_abs_err"], batch_err),
         "ms": sw_win["prepass_ms"], "plain_ms": sw_win["prepass_plain_ms"],
         "bound_ms": sw_win["prepass_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "inputs": f"hitgraph main-path window, {sw_win['M']} timing "
                   "cases sharing the program",
         "full_program_ms": {acc: v["prepass_ms"]
                             for acc, v in sw_serve.items()},
         "full_program_bound_ms": {acc: v["prepass_bound_ms"]
                                   for acc, v in sw_serve.items()}}]
    first = lookup_calls[0]
    table.append({
        "name": "cache_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/cache_lookup.cu",
        "replaces": "src/repro/core/cache.py:258",
        "launches": launches["cache"]["cache_lookup"],
        "launches_by_path": by_path["cache_lookup"],
        "max_abs_err": max(c["max_abs_err"] for c in lookup_calls),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "inputs": "accugraph cached main path (cache=\"default\"), "
                  "first lookup",
        "calls": lookup_calls,
        "cached_dynamic_lookups": sum(
            ep.report.kernel_launches.get("cache_lookup", 0)
            for ep in cached_dyn.epochs)})
    replaces = {"segment_reduce": "segment_reduce/kernel.py:60",
                "edge_scatter": "edge_scatter/kernel.py:63",
                "spmv_ell": "spmv_ell/kernel.py:46"}
    inputs = {"segment_reduce": "hitgraph PR gather, full size, "
                                "dst-sorted updates",
              "edge_scatter": "hitgraph PR scatter, full size, "
                              "dst-sorted edges",
              "spmv_ell": "accugraph PR pull step (memset + one launch), "
                          "sliced ELL"}
    for name, where in replaces.items():
        k = kernels[name]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{where}",
            "launches": launches["stationary"][name],
            "launches_by_path": by_path[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
            "library_call": k["library_call"], "inputs": inputs[name],
            **{key: v for key, v in k.items() if key not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
                "library_call")}})
    print(json.dumps({"kernels": table}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def digest(r):
    """The golden digest of tests/test_goldens.py::_digest."""
    return {
        "system": r.system,
        "problem": r.problem,
        "runtime_ns": r.runtime_ns,
        "iterations": r.iterations,
        "edges": r.edges,
        "vertices": r.vertices,
        "total_requests": r.total_requests,
        "total_bytes": r.total_bytes,
        "row_hit_rate": r.row_hit_rate,
        "n_phases": len(r.phases),
        "phase_requests": sum(p.requests for p in r.phases),
        "row_hits": sum(p.row_hits for p in r.phases),
        "row_conflicts": sum(p.row_conflicts for p in r.phases),
        "end_cycle": r.phases[-1].end_cycle if r.phases else 0,
        "cache_hits": r.cache_hits,
        "prefetch_hits": r.prefetch_hits,
    }


if __name__ == "__main__":
    sys.exit(main())
