"""``repro_torch.sim`` — the public simulation API.

>>> from repro_torch.sim import simulate
>>> r = simulate(g, "wcc", accelerator="hitgraph")            # on the card
>>> r = simulate(ScenarioSpec("powerlaw-social", "wcc", ordering="degree",
...                           accelerator="accugraph", cache="default"))
>>> r = simulate(g, "wcc", accelerator="accugraph", device="cpu")
>>> r = simulate(g, "wcc", accelerator="hitgraph", backend="event")
>>> r = simulate(g, "bfs", accelerator="reference")         # event-driven
>>> res = run_dynamic(g, "wcc", updates="pa-growth", device="cpu")
>>> rows = sweep(graphs=["karate", "road-grid:bfs"], problems=["wcc"],
...              device="cpu")
>>> rows = sweep(graphs=[g], problems=["wcc"],
...              memories=[None] + timing_variants("ddr4"),
...              batch_memories=True, device="cpu")
"""

from repro_torch.algorithms.common import Problem
from repro_torch.core.accel import PhaseStats, SimReport
from repro_torch.core.cache import CacheConfig, CacheStats
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs.corpus import (GRAPH_PRESETS, GraphPreset,
                                       GraphStore, bfs_reorder, degree_sort,
                                       graph_name, graph_variants,
                                       resolve_graph)
from repro_torch.graphs.updates import (UPDATE_PRESETS, UpdateBatch,
                                        UpdateStream, apply_batch,
                                        resolve_updates, updates_name)
from repro_torch.sim.backends import BACKENDS, EventDRAM, make_backend
from repro_torch.sim.memory import (CACHE_PRESETS, MEMORY_PRESETS,
                                    TIMING_PRESETS, MemoryConfig,
                                    cache_name, cache_variants, memory_name,
                                    resolve_cache, resolve_memory,
                                    timing_variants)
from repro_torch.sim.reference_model import ReferenceConfig, ReferenceModel
from repro_torch.sim.policy import (PartitionPolicy,
                                    resolve_partitioned_config, scaled_q)
from repro_torch.sim.registry import (AcceleratorSpec, get_accelerator,
                                      list_accelerators,
                                      register_accelerator)
from repro_torch.sim.scenario import ScenarioSpec, coerce_scenario
from repro_torch.sim.session import SimSession, simulate
from repro_torch.sim.dynamic import (DynamicResult, DynamicTimeline,
                                     EpochReport, run_dynamic)
from repro_torch.sim.sweep import (SweepCase, SweepError, SweepInterrupted,
                                   SweepRow, SweepStats, Sweeper, sweep)
from repro_torch.sim.specs import AccuGraphSpec, HitGraphSpec, ReferenceSpec

__all__ = [
    "Problem", "SimReport", "PhaseStats", "UnknownPresetError",
    "simulate", "SimSession",
    "sweep", "Sweeper", "SweepCase", "SweepRow", "SweepStats", "SweepError",
    "SweepInterrupted", "ScenarioSpec", "coerce_scenario",
    "run_dynamic", "DynamicTimeline", "EpochReport", "DynamicResult",
    "AcceleratorSpec", "register_accelerator", "get_accelerator",
    "list_accelerators",
    "MemoryConfig", "MEMORY_PRESETS", "resolve_memory", "resolve_cache",
    "CACHE_PRESETS", "TIMING_PRESETS", "timing_variants", "memory_name",
    "cache_name", "cache_variants", "CacheConfig", "CacheStats",
    "GRAPH_PRESETS", "GraphPreset", "GraphStore", "resolve_graph",
    "graph_variants", "graph_name", "degree_sort", "bfs_reorder",
    "UpdateStream", "UpdateBatch", "UPDATE_PRESETS", "apply_batch",
    "resolve_updates", "updates_name",
    "BACKENDS", "EventDRAM", "make_backend",
    "PartitionPolicy", "resolve_partitioned_config", "scaled_q",
    "ReferenceConfig", "ReferenceModel",
    "HitGraphSpec", "AccuGraphSpec", "ReferenceSpec",
]
