"""Composable accelerator design-space grammar.

A :class:`DesignSpace` declares, for one registered accelerator, the
searchable dimensions of its structure — PE/pipeline counts, partition
sizing (absolute or via a graph-relative
:class:`~repro_torch.sim.policy.PartitionPolicy`), on-chip cache geometry /
prefetch depth (``CACHE_PRESETS`` names or raw ``CacheConfig``), and the
memory device/timing grade — plus named validity constraints that prune
ill-formed combinations (a PE per channel that the memory doesn't have,
a vertex cache over the BRAM budget, ...).

A :class:`DesignPoint` is one concrete, validated assignment; its
:meth:`~DesignPoint.to_case` turns it into an ordinary
:class:`~repro_torch.sim.sweep.SweepCase`, so candidate generations ride the
existing sweep engine unchanged — structurally compatible points batch
into the same ``batch_memories`` serves (one ``dram_serve_batch`` a
signature group on the card) like any hand-written grid.

Dimension values route by name: ``memory`` / ``cache`` / ``variant``
are case-level axes (any :data:`~repro_torch.sim.memory.MemoryLike` /
:data:`~repro_torch.sim.memory.CacheLike` / variant name); every other
dimension is a field override on the accelerator's config dataclass.

The built-in accelerators declare default spaces via
``AcceleratorSpec.design_space()`` (see ``repro_torch/sim/specs.py``);
build narrower ones with :meth:`DesignSpace.restrict`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.core.cache import CacheConfig
from repro_torch.sim.memory import MemoryConfig, cache_name, memory_name
from repro_torch.sim.policy import PartitionPolicy
from repro_torch.sim.registry import get_accelerator
from repro_torch.sim.sweep import SweepCase

#: dimension names that map onto ``SweepCase`` fields instead of config
#: dataclass fields
CASE_DIMS = ("memory", "cache", "variant")


def value_label(name: str, value: Any) -> str:
    """Stable, human-readable form of one dimension value (design-point
    keys must be identical across processes, so no ``id()``/repr-of-
    object forms)."""
    if isinstance(value, PartitionPolicy):
        return value.label()
    if name == "memory":
        return memory_name(value)
    if name == "cache":
        return cache_name(value)
    if name == "variant":
        return value or "baseline"
    if value is None:
        return "none"               # e.g. partition_elements=None
    if isinstance(value, CacheConfig):
        return value.display_name()
    if isinstance(value, MemoryConfig):
        return value.kind
    return str(value)


@dataclasses.dataclass(frozen=True)
class Dimension:
    """One searchable axis: a name and its ordered candidate values."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self) -> None:
        values = tuple(self.values)
        object.__setattr__(self, "values", values)
        if not self.name:
            raise ValueError("dimension needs a name")
        if not values:
            raise ValueError(f"dimension {self.name!r} needs at least "
                             "one value")
        labels = [value_label(self.name, v) for v in values]
        if len(set(labels)) != len(labels):
            raise ValueError(
                f"dimension {self.name!r} has duplicate values: "
                f"{labels}")

    @property
    def is_case_level(self) -> bool:
        return self.name in CASE_DIMS


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A named validity predicate over a full assignment (a mapping of
    dimension name -> chosen value).  Names surface in rejection
    diagnostics and sampler stats."""

    name: str
    predicate: Callable[[Mapping[str, Any]], bool] = dataclasses.field(
        compare=False)

    TIMING_ONLY_FIELDS = {
        "predicate": "callables are identity-compared by Python; the "
                     "declared name is the constraint's identity in "
                     "diagnostics and stats",
    }

    def ok(self, assignment: Mapping[str, Any]) -> bool:
        return bool(self.predicate(assignment))


class InvalidPoint(ValueError):
    """An assignment violated the space's constraints (or named unknown
    dimensions/values)."""


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """A searchable accelerator design space (see module docstring)."""

    accelerator: str
    dimensions: Tuple[Dimension, ...]
    constraints: Tuple[Constraint, ...] = ()
    #: optional shared base config the dimension overrides apply onto
    base_config: Any = dataclasses.field(default=None, compare=False)

    TIMING_ONLY_FIELDS = {
        "base_config": "starting template only — every searched field "
                       "is overridden by a dimension value, and case "
                       "identity is DesignPoint.key over those values",
    }

    def __post_init__(self) -> None:
        object.__setattr__(self, "dimensions", tuple(self.dimensions))
        object.__setattr__(self, "constraints", tuple(self.constraints))
        get_accelerator(self.accelerator)     # fail fast on a typo
        names = [d.name for d in self.dimensions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dimension names: {names}")

    # ---- shape -------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(d.name for d in self.dimensions)

    def dimension(self, name: str) -> Dimension:
        for d in self.dimensions:
            if d.name == name:
                return d
        raise KeyError(f"no dimension {name!r} in space over "
                       f"{self.accelerator!r}; have {self.names}")

    @property
    def grid_size(self) -> int:
        """Cartesian size BEFORE constraint filtering."""
        size = 1
        for d in self.dimensions:
            size *= len(d.values)
        return size

    def size(self) -> int:
        """Number of VALID points (enumerates; use on small spaces)."""
        return sum(1 for _ in self.enumerate())

    # ---- validity ----------------------------------------------------
    def violated(self, assignment: Mapping[str, Any]) -> List[str]:
        """Names of the constraints this assignment violates."""
        return [c.name for c in self.constraints
                if not c.ok(assignment)]

    def valid(self, assignment: Mapping[str, Any]) -> bool:
        return not self.violated(assignment)

    # ---- point construction ------------------------------------------
    def point(self, **assignment: Any) -> "DesignPoint":
        """A validated :class:`DesignPoint` from one value per
        dimension.  Raises :class:`InvalidPoint` on missing/unknown
        dimensions, values not in the dimension's declared list, or a
        constraint violation."""
        names = set(self.names)
        given = set(assignment)
        if given != names:
            raise InvalidPoint(
                f"assignment keys {sorted(given)} != dimensions "
                f"{sorted(names)}")
        for d in self.dimensions:
            labels = [value_label(d.name, v) for v in d.values]
            if value_label(d.name, assignment[d.name]) not in labels:
                raise InvalidPoint(
                    f"{assignment[d.name]!r} is not a declared value "
                    f"of dimension {d.name!r} (have {labels})")
        bad = self.violated(assignment)
        if bad:
            raise InvalidPoint(
                f"assignment violates constraints {bad}: "
                f"{ {k: value_label(k, v) for k, v in assignment.items()} }")
        return DesignPoint(
            space=self,
            assignment=tuple((d.name, assignment[d.name])
                             for d in self.dimensions))

    def enumerate(self) -> List["DesignPoint"]:
        """All valid points, in grid order (product of the dimensions'
        declared value orders) — the exhaustive-sweep cross-check path;
        use only when :attr:`grid_size` is small."""
        out = []
        for combo in itertools.product(
                *(d.values for d in self.dimensions)):
            assignment = dict(zip(self.names, combo))
            if self.valid(assignment):
                out.append(DesignPoint(
                    space=self,
                    assignment=tuple(zip(self.names, combo))))
        return out

    # ---- composition -------------------------------------------------
    def restrict(self, **values: Sequence[Any]) -> "DesignSpace":
        """A copy with the named dimensions restricted to the given
        value subsets (labels must already be declared) — the standard
        way to carve a small, exhaustively-checkable space out of an
        accelerator's default one."""
        dims = []
        for d in self.dimensions:
            if d.name not in values:
                dims.append(d)
                continue
            declared = {value_label(d.name, v): v for v in d.values}
            picked = []
            for v in values[d.name]:
                lab = value_label(d.name, v)
                if lab not in declared:
                    raise KeyError(
                        f"{lab!r} is not a declared value of dimension "
                        f"{d.name!r} (have {sorted(declared)})")
                picked.append(declared[lab])
            dims.append(Dimension(d.name, tuple(picked)))
        unknown = set(values) - set(self.names)
        if unknown:
            raise KeyError(f"unknown dimensions {sorted(unknown)}; "
                           f"have {self.names}")
        return dataclasses.replace(self, dimensions=tuple(dims))


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """One concrete assignment of a :class:`DesignSpace`."""

    space: DesignSpace = dataclasses.field(compare=False)
    assignment: Tuple[Tuple[str, Any], ...] = ()

    TIMING_ONLY_FIELDS = {
        "space": "back-reference for to_case()/labels — point identity "
                 "is the canonical key over (accelerator, assignment), "
                 "explicit in __hash__/__eq__ below",
    }

    @property
    def values(self) -> Dict[str, Any]:
        return dict(self.assignment)

    @property
    def key(self) -> str:
        """Canonical identity: ``accel|dim=value|...`` in dimension
        order.  Stable across processes and runs — fronts, dedup, and
        ranking tie-breaks all key on it."""
        parts = [self.space.accelerator]
        parts += [f"{k}={value_label(k, v)}" for k, v in self.assignment]
        return "|".join(parts)

    def __hash__(self) -> int:          # assignment values may be
        return hash(self.key)           # unhashable dataclasses

    def __eq__(self, other) -> bool:
        return (isinstance(other, DesignPoint)
                and self.key == other.key)

    def to_case(self, graph, problem, *, root: int = 0,
                fixed_iters: Optional[int] = None,
                graph_scale: float = 1.0,
                graph_seed: int = 0, updates=None) -> SweepCase:
        """Materialize as a :class:`SweepCase` for one (graph, problem)
        scenario.  Config-level dimensions become field overrides on the
        accelerator's config dataclass (``PartitionPolicy`` values
        resolve against the graph inside ``SweepCase``); case-level
        dimensions (:data:`CASE_DIMS`) pass through as case fields."""
        values = self.values
        spec = get_accelerator(self.space.accelerator)
        overrides = {k: v for k, v in values.items()
                     if k not in CASE_DIMS}
        config = spec.make_config(self.space.base_config, **overrides)
        return SweepCase(
            graph=graph, problem=problem,
            accelerator=self.space.accelerator,
            memory=values.get("memory"),
            cache=values.get("cache"),
            variant=values.get("variant"),
            config=config, root=root, fixed_iters=fixed_iters,
            graph_scale=graph_scale, graph_seed=graph_seed,
            updates=updates)
