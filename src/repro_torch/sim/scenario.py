"""``ScenarioSpec`` — one value naming everything a simulation is *of*.

The entry points (:func:`repro_torch.sim.simulate`,
:func:`repro_torch.sim.sweep`, :func:`repro_torch.sim.run_dynamic` by
way of ``updates=``, and the models' module-level ``simulate``) take the
scenario as one frozen dataclass, as the JAX package's do::

    spec = ScenarioSpec("powerlaw-social", "wcc", ordering="degree",
                        updates="pa-growth", accelerator="accugraph",
                        memory="hbm2", cache="default")
    simulate(spec)                      # instead of six keywords
    sweep(cases=[spec, ...])

Execution knobs (``backend=``, ``workers=``, ``device=``) stay keywords
on the entry points: they choose *how* and *where* to run, never *what*
is simulated, and do not belong in the scenario.

The per-axis keyword form keeps working through :func:`coerce_scenario`:
calls naming three or more scenario axes as separate keywords get a
:class:`DeprecationWarning` with the one-line ``ScenarioSpec`` migration,
with the JAX package's text and pointing at the caller's line.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

from repro_torch.graphs.corpus import GraphLike
from repro_torch.graphs.updates import UpdatesLike
from repro_torch.sim.memory import CacheLike, MemoryLike

#: scenario axes the deprecation adapter watches; values are the
#: entry-point defaults (an axis "counts" only when set away from them).
_AXIS_DEFAULTS = {
    "accelerator": "hitgraph", "memory": None, "cache": None,
    "variant": None, "config": None, "updates": None, "ordering": None,
    "policy": None, "root": 0, "fixed_iters": None,
    "graph_scale": 1.0, "graph_seed": 0,
}

#: non-default axis keywords in one call before the adapter suggests
#: bundling them into a ScenarioSpec
DEPRECATION_THRESHOLD = 3


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """What to simulate: graph (+ ordering + mutation stream), problem,
    and the accelerator/memory/cache/variant point — the unified
    scenario value of every entry point.

    ``ordering`` is a corpus transform name (``"degree"``, ``"bfs"``,
    ``"random"``) applied to a preset-named graph; ``policy`` is a
    graph-relative :class:`~repro_torch.sim.policy.PartitionPolicy`
    applied as the config's ``partition_elements``.  ``updates=None`` is
    a static scenario; a stream name or
    :class:`~repro_torch.graphs.updates.UpdateStream` makes it dynamic
    (see :func:`repro_torch.sim.dynamic.run_dynamic`).
    """

    graph: GraphLike
    problem: Any = "wcc"
    updates: UpdatesLike = None
    ordering: Optional[str] = None
    accelerator: str = "hitgraph"
    memory: MemoryLike = None
    cache: CacheLike = None
    variant: Optional[str] = None
    config: Any = None
    policy: Any = None
    root: int = 0
    fixed_iters: Optional[int] = None
    graph_scale: float = 1.0
    graph_seed: int = 0

    def resolved_graph(self) -> GraphLike:
        """The graph selector with ``ordering`` folded in (preset names
        only — a materialized :class:`Graph` is already ordered)."""
        if self.ordering is None:
            return self.graph
        if not isinstance(self.graph, str):
            raise ValueError(
                "ordering= applies a corpus transform to a preset-named "
                f"graph; got a materialized {type(self.graph).__name__} "
                "(order it before constructing the spec)")
        if ":" in self.graph:
            raise ValueError(
                f"graph {self.graph!r} already names a transform; drop "
                f"ordering={self.ordering!r} or the ':' suffix")
        return f"{self.graph}:{self.ordering}"

    def resolved_config(self) -> Any:
        """The config with ``policy`` folded into ``partition_elements``
        (resolved against the graph inside :class:`SweepCase`)."""
        if self.policy is None:
            return self.config
        from repro_torch.sim.registry import get_accelerator
        return get_accelerator(self.accelerator).make_config(
            self.config, partition_elements=self.policy)

    def to_case(self):
        """Materialize as a :class:`~repro_torch.sim.sweep.SweepCase`
        (the sweep's execution currency); axis names validate here."""
        from repro_torch.sim.sweep import SweepCase
        return SweepCase(
            graph=self.resolved_graph(), problem=self.problem,
            accelerator=self.accelerator, memory=self.memory,
            cache=self.cache, variant=self.variant,
            config=self.resolved_config(), root=self.root,
            fixed_iters=self.fixed_iters, graph_scale=self.graph_scale,
            graph_seed=self.graph_seed, updates=self.updates)

    def replace(self, **changes) -> "ScenarioSpec":
        return dataclasses.replace(self, **changes)


def coerce_scenario(fn_name: str, graph, problem=None,
                    **axes) -> ScenarioSpec:
    """Adapter behind every entry point: pass a :class:`ScenarioSpec`
    through, or bundle the legacy per-axis keywords into one — warning
    (:class:`DeprecationWarning`, with the migration spelled out) when a
    call names :data:`DEPRECATION_THRESHOLD` or more axes separately.

    Mixing a spec with legacy axis keywords is an error: the spec is
    the single source of truth (``spec.replace(...)`` to vary it).
    """
    given = sorted(k for k, v in axes.items()
                   if k in _AXIS_DEFAULTS and v != _AXIS_DEFAULTS[k])
    if isinstance(graph, ScenarioSpec):
        if problem is not None or given:
            extras = (["problem"] if problem is not None else []) + given
            raise ValueError(
                f"{fn_name}() got a ScenarioSpec plus per-axis "
                f"arguments {extras}; put the axes inside the spec "
                "(spec.replace(...))")
        return graph
    if problem is None:
        raise TypeError(
            f"{fn_name}() needs a problem (or a ScenarioSpec as its "
            "first argument)")
    if len(given) >= DEPRECATION_THRESHOLD:
        kw = ", ".join(f"{k}=..." for k in given)
        warnings.warn(
            f"{fn_name}(graph, problem, {kw}) with per-axis keywords is "
            f"deprecated; migrate to {fn_name}(ScenarioSpec(graph, "
            f"problem, {kw}))", DeprecationWarning, stacklevel=3)
    known = {k: v for k, v in axes.items() if k in _AXIS_DEFAULTS}
    return ScenarioSpec(graph=graph, problem=problem, **known)
