"""The port's ``simulate`` against the golden SimReport digests of the JAX
package (``tests/goldens/simreports.json``, all 36 keys: HitGraph,
AccuGraph and the event-driven reference machine) and against
``repro.sim.simulate`` phase by phase, on the CPU."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core.accugraph import AccuGraphConfig as RAccuGraphConfig
from repro.core.dram import hbm2 as r_hbm2
from repro.core.hitgraph import HitGraphConfig as RHitGraphConfig
from repro.graphs.corpus import GRAPH_PRESETS
from repro.graphs.generators import rmat as r_rmat
from repro.algorithms.common import Problem as RProblem
from repro.sim import ScenarioSpec, get_accelerator as r_get_accelerator
from repro.sim import simulate as r_simulate

from repro_torch import interop
from repro_torch.algorithms.common import Problem
from repro_torch.graphs.generators import rmat
from repro_torch.sim import get_accelerator, simulate

GOLDEN_PATH = Path(__file__).parent / "goldens" / "simreports.json"

#: the axes of tests/test_goldens.py: the reference machine runs on its
#: paper default memory and config only
MEMORIES = {"hitgraph": ["ddr3", "hbm2"],
            "accugraph": ["ddr4", "ddr4-8gb", "hbm2"],
            "reference": [None]}
OVERRIDES = {"hitgraph": {"partition_elements": 64},
             "accugraph": {"partition_elements": 64},
             "reference": {}}
PROBLEMS = ("wcc", "bfs")


def _graphs():
    return {
        "rmat7": rmat(7, 4, seed=101).undirected_view(),
        "rmat8": rmat(8, 5, seed=102).undirected_view(),
        "karate": interop.graph(GRAPH_PRESETS["karate"].build()),
    }


def _digest(r):
    """Copy of tests/test_goldens.py::_digest."""
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


def test_goldens_reproduced_on_cpu():
    golden = json.loads(GOLDEN_PATH.read_text())
    got = {}
    for gname, g in _graphs().items():
        for accel, mems in MEMORIES.items():
            for mem in mems:
                for prob in PROBLEMS:
                    key = f"{gname}/{accel}/{mem or 'default'}/{prob}"
                    got[key] = _digest(simulate(
                        g, prob, accelerator=accel, memory=mem,
                        device="cpu", **OVERRIDES[accel]))
    assert len(got) == len(golden) == 36
    mismatched = {k: (golden[k], got[k]) for k in sorted(got)
                  if golden[k] != got[k]}
    assert not mismatched, mismatched


@pytest.mark.parametrize("accel,mem,prob", [("hitgraph", "ddr3", "wcc"),
                                            ("accugraph", "ddr4", "bfs"),
                                            ("accugraph", "hbm2", "wcc"),
                                            ("reference", None, "bfs")])
def test_phases_equal_jax_package(accel, mem, prob):
    r = simulate(rmat(7, 4, seed=101).undirected_view(), prob,
                 accelerator=accel, memory=mem, device="cpu",
                 **OVERRIDES[accel])
    want = r_simulate(r_rmat(7, 4, seed=101).undirected_view(), prob,
                      accelerator=accel, memory=mem, **OVERRIDES[accel])
    assert ([dataclasses.astuple(p) for p in r.phases]
            == [dataclasses.astuple(p) for p in want.phases])
    assert r.runtime_ns == want.runtime_ns
    assert r.row_hit_rate == want.row_hit_rate


def test_paper_default_configs_match():
    """No memory override, no partition override: the paper's Tab. 4
    configurations on a graph larger than one partition."""
    g = rmat(9, 4, seed=5).undirected_view()
    r_g = r_rmat(9, 4, seed=5).undirected_view()
    for accel in ("hitgraph", "accugraph"):
        got = _digest(simulate(g, "wcc", accelerator=accel, device="cpu",
                               partition_elements=200))
        want = _digest(r_simulate(r_g, "wcc", accelerator=accel,
                                  partition_elements=200))
        assert got == want, accel


@pytest.mark.parametrize("accel,r_cfg,variant", [
    ("hitgraph", RHitGraphConfig(partition_elements=100, dram=r_hbm2(),
                                 update_merging=False), None),
    ("accugraph", RAccuGraphConfig(partition_elements=90,
                                   model_stalls=False), "both"),
])
def test_configs_carried_across(accel, r_cfg, variant):
    """A JAX-package config (explicit DRAM device, optimisation flags)
    converted field by field drives the port to the same report."""
    convert = (interop.hitgraph_config if accel == "hitgraph"
               else interop.accugraph_config)
    g = rmat(8, 5, seed=102).undirected_view()
    got = simulate(g, "bfs", accelerator=accel, config=convert(r_cfg),
                   variant=variant, device="cpu")
    want = r_simulate(ScenarioSpec(
        r_rmat(8, 5, seed=102).undirected_view(), "bfs",
        accelerator=accel, config=r_cfg, variant=variant))
    assert _digest(got) == _digest(want)


@pytest.mark.parametrize("accel", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("prob", PROBLEMS)
def test_trace_models_vs_jax(accel, prob):
    """The trace models alone: the JAX package's algorithm run, carried
    across, must give the JAX package's request program exactly."""
    r_g = r_rmat(8, 5, seed=102).undirected_view()
    r_spec = r_get_accelerator(accel)
    r_cfg = r_spec.make_config(partition_elements=64)
    r_run = r_spec.run_algorithm(r_g, RProblem(prob), r_cfg)
    want = r_spec.build_model(r_g, r_cfg).build_program(RProblem(prob),
                                                        r_run)
    spec = get_accelerator(accel)
    cfg = spec.make_config(partition_elements=64)
    got = spec.build_model(interop.graph(r_g), cfg).build_program(
        Problem(prob), interop.run_result(r_run))
    assert got.names == want.names
    for f in ("line_addr", "is_write", "issue", "offsets"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
