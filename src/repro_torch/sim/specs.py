"""Built-in accelerator specs: HitGraph, AccuGraph, and the event-driven
reference machine, registered under their paper names.

The parity contract: ``run_algorithm`` must reproduce bit-identically the
algorithm execution each model performs internally when ``run=None``, so
cached runs yield the same SimReport as standalone simulation.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.algorithms import edge_centric, incremental, vertex_centric
from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core import accugraph, hitgraph
from repro_torch.core.accel import SimReport
from repro_torch.core.cache import CacheConfig
from repro_torch.graphs.formats import Graph
from repro_torch.sim.reference_model import ReferenceConfig, ReferenceModel
from repro_torch.sim.registry import (EVENT, AcceleratorSpec,
                                      register_accelerator)


def _graph_key(g: Graph):
    """Identity-based graph key with structural guards (id() alone could
    collide after garbage collection; n/m/name make that harmless)."""
    return (id(g), g.n, g.m, g.name, g.weights is None)


@register_accelerator
class HitGraphSpec(AcceleratorSpec):
    name = "hitgraph"
    description = ("HitGraph [Zh19]: edge-centric scatter/gather, 4 PEs "
                   "on 4 DDR3 channels (paper Tab. 4)")
    config_cls = hitgraph.HitGraphConfig

    def build_model(self, g, config):
        return hitgraph.HitGraphModel(g, config)

    def run_algorithm(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None,
                      device=None) -> RunResult:
        g = g.with_unit_weights() if g.weights is None else g
        return edge_centric.run(g, problem, root=root,
                                fixed_iters=fixed_iters, device=device)

    def algorithm_key(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None):
        return ("edge", _graph_key(g), problem, root, fixed_iters)

    def incremental_run(self, g_old, g_new, batch, problem: Problem,
                        old_values, config, root: int = 0, plan=None,
                        device=None) -> RunResult:
        return incremental.run_incremental(
            g_old, g_new, batch, problem, old_values, engine="edge",
            root=root, plan=plan, device=device)

    def variants(self):
        return {
            "baseline": {},
            "no_merging": {"update_merging": False},
            "no_filtering": {"update_filtering": False},
            "no_skipping": {"partition_skipping": False},
        }

    def default_cache(self):
        """HitGraph's on-chip story is *prefetching*: edge lists, update
        queues and value regions stream sequentially.  The declared
        hierarchy is a pure sequential stream prefetcher, 8 requests deep
        (one per pipeline); it never drops or reorders requests, so it can
        only shorten a run."""
        return CacheConfig(prefetch_degree=8,
                           name="hitgraph-stream-prefetch")

    def design_space(self):
        """Default searchable space (paper Tab. 4 geometry +/- a factor
        of ~4 each way, the three memory grades, and the prefetch-depth
        ladder).  Partition sizing is graph-relative
        (:class:`~repro_torch.sim.policy.PartitionPolicy` counts) so one
        space serves every scenario scale.  The ``pes-within-channels``
        constraint prunes points whose scatter/gather engines outnumber
        the memory channels they are pinned to."""
        from repro_torch.sim.memory import resolve_memory
        from repro_torch.sim.policy import PartitionPolicy
        from repro_torch.tune.space import Constraint, DesignSpace, Dimension

        def pes_within_channels(a) -> bool:
            return a["n_pes"] <= resolve_memory(a["memory"]).channels

        return DesignSpace(
            accelerator=self.name,
            dimensions=(
                Dimension("n_pes", (1, 2, 4, 8)),
                Dimension("pipelines", (4, 8, 16)),
                Dimension("partition_elements",
                          tuple(PartitionPolicy(count=c)
                                for c in (4, 16, 64))),
                Dimension("memory", ("ddr3", "ddr4", "hbm2")),
                Dimension("cache",
                          ("none", "prefetch-4", "prefetch-8")),
            ),
            constraints=(
                Constraint("pes-within-channels", pes_within_channels),
            ))


@register_accelerator
class AccuGraphSpec(AcceleratorSpec):
    name = "accugraph"
    description = ("AccuGraph [Ya18]: vertex-centric pull with on-chip "
                   "accumulation, 1 DDR4 channel (paper Tab. 4)")
    config_cls = accugraph.AccuGraphConfig

    def build_model(self, g, config):
        return accugraph.AccuGraphModel(g, config)

    def _q(self, g, config) -> int:
        return (config.partition_elements if config.partition_elements
                else g.n)

    def run_algorithm(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None,
                      device=None) -> RunResult:
        return vertex_centric.run(
            g, problem, q=self._q(g, config), root=root,
            fixed_iters=fixed_iters,
            block_skipping=config.partition_skipping, device=device)

    def algorithm_key(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None):
        return ("vertex", _graph_key(g), problem, self._q(g, config),
                config.partition_skipping, root, fixed_iters)

    def incremental_run(self, g_old, g_new, batch, problem: Problem,
                        old_values, config, root: int = 0, plan=None,
                        device=None) -> RunResult:
        return incremental.run_incremental(
            g_old, g_new, batch, problem, old_values, engine="vertex",
            root=root, q=self._q(g_new, config),
            block_skipping=config.partition_skipping, plan=plan,
            device=device)

    def variants(self):
        from repro_torch.core.dram import hbm2
        return {
            "baseline": {},
            "prefetch_skip": {"prefetch_skipping": True},
            "partition_skip": {"partition_skipping": True},
            "both": {"prefetch_skipping": True,
                     "partition_skipping": True},
            # paper §7 future work: swap DDR4 for an HBM2 stack
            "hbm": {"dram": hbm2()},
        }

    def default_cache(self):
        """AccuGraph's defining feature is the vertex BRAM.  The declared
        hierarchy is a BRAM-class 2 MiB 16-way LRU vertex cache over the
        read streams: repeated value/pointer traffic hits on chip and
        never reaches DRAM."""
        return CacheConfig(lines=32768, ways=16,
                           name="accugraph-vertex-bram")

    #: searchable BRAM budget: the original's 2 MiB of vertex storage
    BRAM_BUDGET_BYTES = 2 * 1024 * 1024

    def design_space(self):
        """Default searchable space: pipeline widths around the paper
        geometry, all-BRAM vs partitioned execution, the DDR4 grades plus
        the HBM2 stack, and a vertex-cache capacity ladder that includes
        an over-budget 4 MiB point, which the ``bram-budget`` constraint
        prunes."""
        from repro_torch.sim.memory import resolve_cache
        from repro_torch.sim.policy import PartitionPolicy
        from repro_torch.tune.space import Constraint, DesignSpace, Dimension

        budget = self.BRAM_BUDGET_BYTES

        def bram_within_budget(a) -> bool:
            cache = resolve_cache(a["cache"], self)
            return cache is None or cache.capacity_bytes <= budget

        return DesignSpace(
            accelerator=self.name,
            dimensions=(
                Dimension("edge_pipelines", (8, 16, 32)),
                Dimension("vertex_pipelines", (4, 8)),
                Dimension("partition_elements",
                          (None,) + tuple(PartitionPolicy(count=c)
                                          for c in (4, 16))),
                Dimension("memory", ("ddr4", "ddr4-8gb", "hbm2")),
                Dimension("cache",
                          ("none", "vertex-256k", "vertex-1m",
                           "vertex-2m",
                           CacheConfig(lines=65536, ways=16,
                                       name="vertex-4m"))),
            ),
            constraints=(
                Constraint("bram-budget", bram_within_budget),
            ))


@register_accelerator
class ReferenceSpec(AcceleratorSpec):
    name = "reference"
    description = ("event-driven reference machine (Fig. 6 abstraction "
                   "graph, element granularity; slow — small graphs only)")
    config_cls = ReferenceConfig
    backends = (EVENT,)

    def build_model(self, g, config):
        return ReferenceModel(g, config)

    def run_algorithm(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None,
                      device=None) -> RunResult:
        return vertex_centric.run(g, problem, q=g.n, root=root,
                                  fixed_iters=fixed_iters, device=device)

    def algorithm_key(self, g, problem: Problem, config, root: int = 0,
                      fixed_iters: Optional[int] = None):
        return ("vertex", _graph_key(g), problem, g.n, False, root,
                fixed_iters)

    def simulate(self, g, problem: Problem, config=None,
                 backend: Optional[str] = None, root: int = 0,
                 fixed_iters: Optional[int] = None,
                 run: Optional[RunResult] = None,
                 model=None, device=None) -> SimReport:
        # inherently event-driven: the model drives its own Engine, so no
        # backend object is injected.
        if backend is None:
            backend = EVENT
        if backend not in self.backends:
            raise ValueError(
                f"accelerator 'reference' supports backends "
                f"{self.backends}, got {backend!r}")
        cfg = config if config is not None else self.config_cls()
        if cfg.dram_config().effective_cache is not None:
            # explicit beats silent: the Engine replay has no filter
            # hook, so accepting a cache would mislabel no-cache rows.
            raise ValueError(
                "the event-driven reference machine models its on-chip "
                "behavior internally (everything fits BRAM); cache= is "
                "not supported for accelerator 'reference'")
        if model is None:
            model = self.build_model(g, cfg)
        return model.simulate(problem, root=root, fixed_iters=fixed_iters,
                              run=run, device=device)
