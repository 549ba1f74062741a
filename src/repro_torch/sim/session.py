"""Session facade: the public entry point for running simulations.

``simulate(graph, problem, accelerator=..., memory=..., device=...)``, or
``simulate(ScenarioSpec(...), device=...)``, resolves the graph (a
:class:`Graph` or a corpus preset name), the accelerator spec, the memory
device and the DRAM backend, and returns the shared
:class:`~repro_torch.core.accel.SimReport`.  It runs on the card unless
``device`` says otherwise.

:class:`SimSession` binds a graph and caches, across repeated calls:

* **algorithm runs** by ``spec.algorithm_key``;
* **models** (edge sorts, layout, static streams) by config with the
  DRAM device reduced to its structure and clock, so they are shared
  across every timing and cache variant of a memory point (the cache
  filter runs downstream of trace emission);
* **packed programs** (:meth:`SimSession.packed_program_for`, the sweep
  engine's) by the DRAM geometry and clock: packing never depends on
  timing, so a timing comparison packs each (graph, accelerator) point
  once and serves it against every timing vector
  (``pack_cache_hits`` / ``pack_cache_misses`` count the reuse).

All three caches are single-flight and thread-safe (the sweep's workers
share one session per graph); a session rebinds to a mutated graph
(:meth:`SimSession.rebind`) on the dynamic-graph path.

``simulate(..., updates=...)`` runs a dynamic-graph update stream through
:func:`repro_torch.sim.dynamic.run_dynamic` and returns its aggregate
report.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Dict, Optional

from repro_torch import spans
from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.analysis import locks
from repro_torch.core import cache as cache_mod
from repro_torch.core.accel import SimReport, pack_program_auto
from repro_torch.device import resolve_device
from repro_torch.graphs.corpus import GraphLike, resolve_graph
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


def _dram_cfg_key(spec_name: str, config, include_cache: bool):
    """Cache key for state that depends on the config and the DRAM
    *geometry + clock* but not its timing: the config with ``dram``
    nulled, plus the resolved device's geometry or structure key and
    clock.  ``include_cache=True`` keys on ``geometry_key`` (what
    *packing* depends on: the on-chip cache filters requests before
    packing); ``False`` on ``structure_key`` (what *trace emission*
    depends on: models are shared across every cache variant of a memory
    point).  ``None`` when the config has no pluggable DRAM or is
    unhashable."""
    if not hasattr(config, "dram_config"):
        return None
    try:
        dram = config.dram_config()
        dram_key = (dram.geometry_key if include_cache
                    else dram.structure_key)
        key = (spec_name, dataclasses.replace(config, dram=None),
               dram_key, dram.clock_ghz)
        hash(key)
        return key
    except (TypeError, dataclasses.FrozenInstanceError):
        return None


class SimSession:
    """A graph bound to caches of algorithm runs, models and packs.

    >>> sess = SimSession(g)
    >>> sess.run(Problem.WCC, accelerator="hitgraph")
    >>> sess.run(Problem.WCC, accelerator="hitgraph", memory="hbm2")
    # second call reuses the edge-centric WCC execution
    """

    #: max packed programs retained per session: packs are the largest
    #: cached artifact ([S, C, K] streams), so the cache is bounded with
    #: insertion-order eviction; only reuse beyond the window re-packs.
    PACK_CACHE_CAP = 256

    def __init__(self, graph: GraphLike):
        # corpus preset names resolve here, so a session can be opened
        # directly on a scenario: ``SimSession("powerlaw-social")``
        self.graph = resolve_graph(graph)
        # race-instrumented under REPRO_ANALYSIS_LOCKS=1 — every access
        # to the three single-flight caches must hold the session lock
        self._lock = locks.make_lock("session")
        self._runs: Dict[object, Future] = \
            locks.make_dict("SimSession._runs", self._lock)
        self._models: Dict[object, Future] = \
            locks.make_dict("SimSession._models", self._lock)
        self._packs: Dict[object, Future] = \
            locks.make_dict("SimSession._packs", self._lock)
        self.algo_runs = 0
        self.algo_cache_hits = 0
        self.pack_cache_hits = 0
        self.pack_cache_misses = 0
        self.invalidations = 0
        self.invalidation_skips = 0

    def _singleflight(self, cache: Dict[object, Future], key, build,
                      count=None):
        """Get-or-build ``cache[key]``: exactly one thread runs
        ``build()`` per key; concurrent lookups wait on its Future.
        ``count`` is an optional ``(miss_attr, hit_attr)`` counter
        pair."""
        with self._lock:
            fut = cache.get(key)
            owner = fut is None
            if owner:
                fut = cache[key] = Future()
            if count is not None:
                attr = count[0] if owner else count[1]
                setattr(self, attr, getattr(self, attr) + 1)
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
        def build():
            with spans.span("session.model"):
                return spec.build_model(self.graph, config)

        key = _dram_cfg_key(spec.name, config, include_cache=False)
        if key is None:
            try:
                key = (spec.name, config)
                hash(key)
            except TypeError:
                return build()
        return self._singleflight(self._models, key, build)

    def algorithm_run(self, spec, problem: Problem, config, root: int,
                      fixed_iters: Optional[int], device) -> RunResult:
        def build():
            with spans.span("session.algorithm"):
                return spec.run_algorithm(self.graph, problem, config,
                                          root=root, fixed_iters=fixed_iters,
                                          device=device)

        key = spec.algorithm_key(self.graph, problem, config, root=root,
                                 fixed_iters=fixed_iters)
        return self._singleflight(self._runs, key, build,
                                  count=("algo_runs", "algo_cache_hits"))

    def packed_program_for(self, spec, problem: Problem, config, model,
                           run: RunResult, dram, root: int = 0,
                           fixed_iters: Optional[int] = None, device=None):
        """Geometry-keyed packed-program cache; returns ``(packed,
        cache_stats)``, where ``cache_stats`` describes the on-chip
        hierarchy the program went through before packing (``None`` when
        the device has no cache).  Packs on ``device`` (default the card)
        through ``pack_program_auto``.

        The cached pack carries the timing vector it was first built with:
        callers serve it with *their* case's timing
        (``serve_packed(packed, timing=...)``), which is what makes the
        cache sound: nothing in the packed arrays (nor the cache filter,
        which sees only addresses, program order and timing-free issue
        bounds) depends on timing."""
        device = resolve_device(device)

        def _build():
            with spans.span("session.program"):
                program = model.build_program(problem, run)
                cs = None
                if dram.cache is not None and dram.cache.enabled:
                    program, cs, _ = cache_mod.filter_program(
                        program, dram.cache, device=device)
                return pack_program_auto(program, dram, device=device), cs

        cfg_key = _dram_cfg_key(spec.name, config, include_cache=True)
        if cfg_key is None:
            with self._lock:
                self.pack_cache_misses += 1
            return _build()
        key = (cfg_key, spec.algorithm_key(
            self.graph, problem, config, root=root,
            fixed_iters=fixed_iters))
        packed = self._singleflight(
            self._packs, key, _build,
            count=("pack_cache_misses", "pack_cache_hits"))
        with self._lock:
            while len(self._packs) > self.PACK_CACHE_CAP:
                oldest = next(iter(self._packs))
                if oldest == key or not self._packs[oldest].done():
                    break
                del self._packs[oldest]
        return packed

    def invalidate(self, touched_partitions) -> int:
        """Invalidate the session's run, model and pack caches after the
        bound graph mutated, keyed by which partitions actually changed:
        an empty ``touched_partitions`` is a guaranteed no-op (every
        cached entry stays), a non-empty one drops all entries (they are
        whole-graph artifacts).  Returns the number of entries dropped."""
        with self._lock:
            if len(touched_partitions) == 0:
                self.invalidation_skips += 1
                return 0
            dropped = len(self._runs) + len(self._models) + len(self._packs)
            self._runs.clear()
            self._models.clear()
            self._packs.clear()
            self.invalidations += 1
        return dropped

    def rebind(self, graph: GraphLike, touched_partitions) -> int:
        """Swap the resident graph (a long-lived session whose graph
        evolves in place) and invalidate accordingly.  Returns the number
        of cache entries dropped."""
        dropped = self.invalidate(touched_partitions)
        self.graph = resolve_graph(graph)
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


def simulate(graph: GraphLike, problem=None,
             accelerator: str = "hitgraph", *,
             config=None, memory: MemoryLike = None,
             cache: CacheLike = None,
             backend: Optional[str] = None, variant: Optional[str] = None,
             root: int = 0, fixed_iters: Optional[int] = None,
             updates=None, device=None, **overrides) -> SimReport:
    """Run one simulation through the spec registry.

    Parameters
    ----------
    graph:        a :class:`Graph` instance, a corpus preset name
                  (``"karate"``, ``"powerlaw-social:degree"``, ... — see
                  :data:`repro_torch.graphs.corpus.GRAPH_PRESETS`), or a
                  :class:`~repro_torch.sim.scenario.ScenarioSpec` bundling
                  every scenario axis (the preferred form; the per-axis
                  keywords below stay as a deprecated adapter).
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

    ``backend`` and ``device`` are execution knobs, not scenario axes:
    they stay keywords even for the ``ScenarioSpec`` form.
    """
    from repro_torch.sim.scenario import coerce_scenario
    spec = coerce_scenario(
        "simulate", graph, problem, accelerator=accelerator,
        config=config, memory=memory, cache=cache, variant=variant,
        updates=updates, root=root, fixed_iters=fixed_iters)
    device = resolve_device(device)
    g = resolve_graph(spec.resolved_graph(), scale=spec.graph_scale,
                      seed=spec.graph_seed)
    cfg = resolve_partitioned_config(spec.resolved_config(), g)
    if spec.updates is not None:
        from repro_torch.sim.dynamic import run_dynamic
        return run_dynamic(
            g, spec.problem, updates=spec.updates,
            accelerator=spec.accelerator, config=cfg, memory=spec.memory,
            cache=spec.cache, backend=backend, variant=spec.variant,
            root=spec.root, fixed_iters=spec.fixed_iters, device=device,
            **overrides).report
    return SimSession(g).run(
        spec.problem, spec.accelerator, config=cfg, memory=spec.memory,
        cache=spec.cache, backend=backend, variant=spec.variant,
        root=spec.root, fixed_iters=spec.fixed_iters, device=device,
        **overrides)
