"""Rapid accelerator-prototyping studies (paper Sect. 5).

The paper's engineering claim: new accelerator ideas can be evaluated in
the simulation environment instead of RTL.  This module packages that
workflow: enumerate design variants, simulate each (on the card by
default, through the ``dram_serve`` kernel), and report speedups over the
baseline.

Variants (paper's two enhancements + beyond-paper ones we propose):

* ``prefetch_skip``  — skip re-prefetching a partition already in BRAM.
* ``partition_skip`` — dirty-bit partition skipping (exact; Sect. 5).
* ``both``           — combined.
* ``hbm``            — beyond-paper: swap DDR4 for an HBM2 stack (the
  paper's §7 future work), same accelerator logic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.algorithms.common import Problem
from repro_torch.core import accugraph
from repro_torch.core.accel import SimReport
from repro_torch.core.dram import hbm2
from repro_torch.graphs.formats import Graph


@dataclasses.dataclass
class StudyResult:
    variant: str
    report: SimReport
    speedup: float


def accugraph_variants(
    base: accugraph.AccuGraphConfig = accugraph.AccuGraphConfig(),
) -> Dict[str, accugraph.AccuGraphConfig]:
    return {
        "baseline": base,
        "prefetch_skip": dataclasses.replace(base, prefetch_skipping=True),
        "partition_skip": dataclasses.replace(base, partition_skipping=True),
        "both": dataclasses.replace(
            base, prefetch_skipping=True, partition_skipping=True),
        # HBM needs channel-interleaved placement: with the contiguous
        # (channel-as-MSB) layout the whole working set lands in one of 8
        # channels and HBM *loses* to DDR4 — the [Gh19]-style
        # workload/DRAM interaction the paper's §7 anticipates.
        "hbm": dataclasses.replace(base, dram=hbm2()),
    }


def run_study(
    g: Graph,
    problem: Problem,
    base: accugraph.AccuGraphConfig = accugraph.AccuGraphConfig(),
    root: int = 0,
    fixed_iters: Optional[int] = None,
    variants: Optional[List[str]] = None,
    device=None,
) -> List[StudyResult]:
    """Simulate all variants on ``device`` (default the card); speedup =
    baseline_runtime / variant_runtime.

    Partition skipping is definitionally inapplicable to stationary
    problems (PR/SpMV) — the paper notes PR "is not shown, since no
    partitions can be skipped"; we keep the variant but it degenerates to
    the baseline execution.
    """
    cfgs = accugraph_variants(base)
    names = variants if variants is not None else list(cfgs)
    baseline = accugraph.simulate(g, problem, cfgs["baseline"], root=root,
                                  fixed_iters=fixed_iters, device=device)
    out = [StudyResult("baseline", baseline, 1.0)]
    for name in names:
        if name == "baseline":
            continue
        rep = accugraph.simulate(g, problem, cfgs[name], root=root,
                                 fixed_iters=fixed_iters, device=device)
        out.append(StudyResult(
            name, rep, baseline.runtime_ns / max(rep.runtime_ns, 1e-9)))
    return out
