"""Session facade: the public entry point for running simulations.

``simulate(graph, problem, accelerator=..., memory=..., device=...)``
resolves the accelerator spec, the memory device and the DRAM backend,
and returns the shared :class:`~repro_torch.core.accel.SimReport`.  It
runs on the card unless ``device`` says otherwise.

:class:`SimSession` binds a graph and caches, across repeated calls,
**algorithm runs** by ``spec.algorithm_key`` and **models** (edge sorts,
layout, static streams) by config with the DRAM device reduced to its
structure and clock.  Both caches are single-flight and thread-safe; a
session rebinds to a mutated graph (:meth:`SimSession.rebind`) on the
dynamic-graph path.

Models are keyed on the DRAM structure alone, so they are shared across
every cache variant of a memory point too (the cache filter runs
downstream of trace emission).

``simulate(..., updates=...)`` runs a dynamic-graph update stream through
:func:`repro_torch.sim.dynamic.run_dynamic` and returns its aggregate
report.  Not in this slice (each raises and names ROADMAP.md): corpus
preset names and ``ScenarioSpec`` as the graph argument.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core.accel import SimReport
from repro_torch.device import resolve_device
from repro_torch.graphs.formats import Graph
from repro_torch.sim.memory import (CacheLike, MemoryLike, resolve_cache,
                                   resolve_memory)
from repro_torch.sim.policy import resolve_partitioned_config
from repro_torch.sim.registry import get_accelerator

# built-in specs register on import
from repro_torch.sim import specs as _specs  # noqa: F401


def _coerce_problem(problem) -> Problem:
    return problem if isinstance(problem, Problem) else Problem(problem)


def resolve_run_config(spec, config=None, memory: MemoryLike = None,
                       cache: CacheLike = None,
                       variant: Optional[str] = None, **overrides):
    """Resolve the effective accelerator config from the public axis
    selectors (defaults <- config <- overrides <- memory <- variant <-
    cache)."""
    cfg = spec.make_config(config, memory=resolve_memory(memory),
                           **overrides)
    cfg = spec.apply_variant(cfg, variant)
    cache_cfg = resolve_cache(cache, spec)
    if cache_cfg is not None:
        # after variants: a dram-overriding variant (AccuGraph "hbm")
        # must not discard the requested on-chip cache
        cfg = spec.make_config(cfg, cache=cache_cfg)
    return cfg


def _check_graph(graph) -> Graph:
    if not isinstance(graph, Graph):
        raise TypeError(
            f"SimSession takes a Graph, got {type(graph).__name__}; "
            "corpus preset names come with a later slice (see "
            "ROADMAP.md)")
    return graph


def _dram_cfg_key(spec_name: str, config):
    """Cache key for state that depends on the config and the DRAM
    *structure + clock* but not its timing; ``None`` when the config has
    no pluggable DRAM or is unhashable."""
    if not hasattr(config, "dram_config"):
        return None
    try:
        dram = config.dram_config()
        key = (spec_name, dataclasses.replace(config, dram=None),
               dram.structure_key, dram.clock_ghz)
        hash(key)
        return key
    except (TypeError, dataclasses.FrozenInstanceError):
        return None


class SimSession:
    """A graph bound to caches of algorithm runs and models.

    >>> sess = SimSession(g)
    >>> sess.run(Problem.WCC, accelerator="hitgraph")
    >>> sess.run(Problem.WCC, accelerator="hitgraph", memory="hbm2")
    # second call reuses the edge-centric WCC execution
    """

    def __init__(self, graph: Graph):
        self.graph = _check_graph(graph)
        self._lock = threading.Lock()
        self._runs: Dict[object, Future] = {}
        self._models: Dict[object, Future] = {}
        self.invalidations = 0
        self.invalidation_skips = 0

    def _singleflight(self, cache: Dict[object, Future], key, build):
        """Get-or-build ``cache[key]``: exactly one thread runs
        ``build()`` per key; concurrent lookups wait on its Future."""
        with self._lock:
            fut = cache.get(key)
            owner = fut is None
            if owner:
                fut = cache[key] = Future()
        if owner:
            try:
                fut.set_result(build())
            except BaseException as e:
                with self._lock:
                    cache.pop(key, None)
                fut.set_exception(e)
                raise
        return fut.result()

    def model_for(self, spec, config):
        """Graph-bound model cache, shared across problems and across
        every timing variant of one memory structure."""
        key = _dram_cfg_key(spec.name, config)
        if key is None:
            try:
                key = (spec.name, config)
                hash(key)
            except TypeError:
                return spec.build_model(self.graph, config)
        return self._singleflight(
            self._models, key,
            lambda: spec.build_model(self.graph, config))

    def algorithm_run(self, spec, problem: Problem, config, root: int,
                      fixed_iters: Optional[int], device) -> RunResult:
        key = spec.algorithm_key(self.graph, problem, config, root=root,
                                 fixed_iters=fixed_iters)
        return self._singleflight(
            self._runs, key,
            lambda: spec.run_algorithm(self.graph, problem, config,
                                       root=root, fixed_iters=fixed_iters,
                                       device=device))

    def invalidate(self, touched_partitions) -> int:
        """Invalidate the session's run and model caches after the bound
        graph mutated, keyed by which partitions actually changed: an
        empty ``touched_partitions`` is a guaranteed no-op (every cached
        entry stays), a non-empty one drops all entries (they are
        whole-graph artifacts).  Returns the number of entries dropped."""
        with self._lock:
            if len(touched_partitions) == 0:
                self.invalidation_skips += 1
                return 0
            dropped = len(self._runs) + len(self._models)
            self._runs.clear()
            self._models.clear()
            self.invalidations += 1
        return dropped

    def rebind(self, graph: Graph, touched_partitions) -> int:
        """Swap the resident graph (a long-lived session whose graph
        evolves in place) and invalidate accordingly.  Returns the number
        of cache entries dropped."""
        dropped = self.invalidate(touched_partitions)
        self.graph = _check_graph(graph)
        return dropped

    def run(self, problem, accelerator: str = "hitgraph", *,
            config=None, memory: MemoryLike = None,
            cache: CacheLike = None,
            backend: Optional[str] = None, variant: Optional[str] = None,
            root: int = 0, fixed_iters: Optional[int] = None,
            device=None, **overrides) -> SimReport:
        """Simulate ``problem`` on the bound graph on ``device`` (default
        the card; raises when CUDA is absent)."""
        device = resolve_device(device)
        problem = _coerce_problem(problem)
        spec = get_accelerator(accelerator)
        cfg = resolve_run_config(spec, config, memory=memory, cache=cache,
                                 variant=variant, **overrides)
        t0 = time.perf_counter()
        run = self.algorithm_run(spec, problem, cfg, root, fixed_iters,
                                 device)
        t1 = time.perf_counter()
        model = self.model_for(spec, cfg)
        t2 = time.perf_counter()
        report = spec.simulate(self.graph, problem, cfg, backend=backend,
                               root=root, fixed_iters=fixed_iters, run=run,
                               model=model, device=device)
        report.stage_seconds = {"algorithm": t1 - t0, "model": t2 - t1,
                                **report.stage_seconds}
        return report


def simulate(graph: Graph, problem=None,
             accelerator: str = "hitgraph", *,
             config=None, memory: MemoryLike = None,
             cache: CacheLike = None,
             backend: Optional[str] = None, variant: Optional[str] = None,
             root: int = 0, fixed_iters: Optional[int] = None,
             updates=None, device=None, **overrides) -> SimReport:
    """Run one simulation through the spec registry.

    Parameters
    ----------
    graph:        a :class:`Graph`.
    problem:      a :class:`Problem` or its string value (``"wcc"``,
                  ``"bfs"``, ``"sssp"``, ``"pr"``, ``"spmv"``).
    accelerator:  registered name (``"hitgraph"``, ``"accugraph"``,
                  ``"reference"``) or an :class:`AcceleratorSpec`
                  instance.
    config:       accelerator config dataclass (defaults per paper Tab. 4);
                  extra keyword arguments override individual fields, e.g.
                  ``simulate(g, "wcc", partition_elements=2048)``.
    memory:       ``None`` (the accelerator's paper default), a preset
                  name (``"ddr3"``, ``"ddr4-8gb"``, ``"hbm2"``...), a
                  :class:`MemoryConfig`, or a raw :class:`DRAMConfig`.
    cache:        on-chip hierarchy level in front of the DRAM device:
                  ``None`` (no cache, unless the memory selector carries
                  one), a :data:`~repro_torch.sim.memory.CACHE_PRESETS`
                  name (``"vertex-1m"``, ``"prefetch-8"``...),
                  ``"default"`` (the accelerator's declared paper
                  hierarchy — AccuGraph's vertex BRAM, HitGraph's stream
                  prefetch), or a :class:`~repro_torch.core.cache.
                  CacheConfig`.
    variant:      named optimization variant of the accelerator.
    fixed_iters:  iterations of the stationary problems (PR, SpMV);
                  ``None`` runs one, as the JAX package does.
    updates:      dynamic-graph mutation stream (``None`` = static, or
                  an ``UPDATE_PRESETS`` name / ``UpdateStream``): the run
                  goes through :func:`repro_torch.sim.dynamic.run_dynamic`
                  and returns its aggregate report over all epochs.
    device:       where the algorithm engine and the DRAM serve run:
                  ``None`` means the card (raises without CUDA);
                  ``"cpu"`` runs the plain versions on the host.
    backend:      ``"vectorized"`` (the fused serve), ``"event"`` (the
                  element-granularity replay on the host; slow), or
                  ``None`` for the accelerator's preferred backend.
    """
    if problem is None:
        raise TypeError("simulate() needs a problem")
    device = resolve_device(device)
    cfg = resolve_partitioned_config(config, graph)
    if updates is not None:
        from repro_torch.sim.dynamic import run_dynamic
        return run_dynamic(
            graph, problem, updates=updates, accelerator=accelerator,
            config=cfg, memory=memory, cache=cache, backend=backend,
            variant=variant, root=root, fixed_iters=fixed_iters,
            device=device, **overrides).report
    return SimSession(graph).run(
        problem, accelerator, config=cfg, memory=memory, cache=cache,
        backend=backend, variant=variant, root=root,
        fixed_iters=fixed_iters, device=device, **overrides)
