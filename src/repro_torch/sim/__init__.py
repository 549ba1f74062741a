"""``repro_torch.sim`` — the public simulation API.

>>> from repro_torch.sim import simulate
>>> r = simulate(g, "wcc", accelerator="hitgraph")            # on the card
>>> r = simulate(g, "wcc", accelerator="accugraph", device="cpu")
>>> r = simulate(g, "wcc", accelerator="hitgraph", backend="event")
>>> r = simulate(g, "bfs", accelerator="reference")         # event-driven
>>> res = run_dynamic(g, "wcc", updates="pa-growth", device="cpu")
"""

from repro_torch.algorithms.common import Problem
from repro_torch.core.accel import PhaseStats, SimReport
from repro_torch.errors import UnknownPresetError
from repro_torch.sim.backends import BACKENDS, make_backend
from repro_torch.sim.memory import (MEMORY_PRESETS, MemoryConfig,
                                    resolve_cache, resolve_memory)
from repro_torch.sim.reference_model import ReferenceConfig, ReferenceModel
from repro_torch.sim.policy import (PartitionPolicy,
                                    resolve_partitioned_config, scaled_q)
from repro_torch.sim.registry import (AcceleratorSpec, get_accelerator,
                                      list_accelerators,
                                      register_accelerator)
from repro_torch.sim.session import SimSession, simulate
from repro_torch.sim.dynamic import (DynamicResult, DynamicTimeline,
                                     EpochReport, run_dynamic)

__all__ = [
    "Problem", "SimReport", "PhaseStats", "UnknownPresetError",
    "simulate", "SimSession",
    "run_dynamic", "DynamicTimeline", "EpochReport", "DynamicResult",
    "AcceleratorSpec", "register_accelerator", "get_accelerator",
    "list_accelerators",
    "MemoryConfig", "MEMORY_PRESETS", "resolve_memory", "resolve_cache",
    "BACKENDS", "make_backend",
    "PartitionPolicy", "resolve_partitioned_config", "scaled_q",
    "ReferenceConfig", "ReferenceModel",
]
