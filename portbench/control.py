"""The comparison's control: the plain reference put in the program's place
with one guarantee of the configuration broken (the banks' and buses'
state carried across phase barriers: here forgotten at each), judged by
the same comparison as the program.  It has
to come out not correct.  The benchmark's own runs do not run it.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

prints, a seed, the numbers the comparison reads beside their limits
(host only: no card is used).
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import bench, compare, graphgen  # noqa: E402
from portbench.reference import expected_reports  # noqa: E402


def control_verdict(cell: "bench.Cell", seed: int,
                    processes=None) -> compare.Verdict:
    graph = graphgen.make_graph(cell.config["graph"], seed)
    grid = cell.traffic["grid"]
    want = expected_reports(cell.config, graph, grid, processes=processes)
    got = expected_reports(cell.config, graph, grid, carry_state=False,
                           processes=processes)
    return compare.judge([got], want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = bench.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        v = control_verdict(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": v.correct,
                          "mismatched_reports": v.mismatched_reports,
                          "first_diffs": v.first_diffs,
                          "checks": v.checks(),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
