"""Seed-deterministic candidate generation over a :class:`DesignSpace`.

All randomness flows from one ``numpy`` PCG64 generator seeded by the
caller, so a search at a given seed proposes bit-identical candidate
sets on every run, machine, and worker count — the determinism half of
the Pareto-front contract.  It stays a NumPy generator in the port (not a
``torch.Generator``, which draws other numbers): the same seed proposes
the JAX package's points, so the fronts can be held to each other.
Constraint-violating draws are rejected and counted, never silently
repaired, so the accepted distribution is uniform over the VALID region
of the grid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.tune.space import DesignPoint, DesignSpace


def make_rng(seed: int) -> np.random.Generator:
    """The one sanctioned RNG constructor for search: PCG64 streams are
    stable across numpy versions and platforms."""
    return np.random.Generator(np.random.PCG64(int(seed)))


@dataclasses.dataclass
class SampleStats:
    proposed: int = 0            # raw draws
    rejected_invalid: int = 0    # constraint violations
    rejected_duplicate: int = 0  # key already seen


def _draw(space: DesignSpace, rng: np.random.Generator) -> dict:
    return {d.name: d.values[int(rng.integers(len(d.values)))]
            for d in space.dimensions}


def sample(space: DesignSpace, n: int, rng: np.random.Generator,
           seen: Optional[set] = None,
           stats: Optional[SampleStats] = None,
           max_tries_per_point: int = 200) -> List[DesignPoint]:
    """Up to ``n`` distinct valid points (uniform over the valid grid,
    deduplicated by key — against ``seen`` too, which is updated in
    place).  Returns fewer than ``n`` only when the valid region is
    exhausted within the rejection budget (tiny restricted spaces)."""
    seen = seen if seen is not None else set()
    stats = stats or SampleStats()
    out: List[DesignPoint] = []
    tries = 0
    budget = max_tries_per_point * max(n, 1)
    while len(out) < n and tries < budget:
        tries += 1
        stats.proposed += 1
        assignment = _draw(space, rng)
        if not space.valid(assignment):
            stats.rejected_invalid += 1
            continue
        point = DesignPoint(
            space=space,
            assignment=tuple((d.name, assignment[d.name])
                             for d in space.dimensions))
        if point.key in seen:
            stats.rejected_duplicate += 1
            continue
        seen.add(point.key)
        out.append(point)
    return out


def mutate(point: DesignPoint, rng: np.random.Generator,
           seen: Optional[set] = None,
           stats: Optional[SampleStats] = None,
           max_tries: int = 64) -> Optional[DesignPoint]:
    """One evolutionary mutation: resample a single dimension of
    ``point`` to a different declared value, keeping the rest.  Returns
    a valid, unseen neighbor or ``None`` when the neighborhood is
    exhausted (fully explored corner of a tiny space)."""
    space = point.space
    seen = seen if seen is not None else set()
    stats = stats or SampleStats()
    values = point.values
    for _ in range(max_tries):
        stats.proposed += 1
        dim = space.dimensions[int(rng.integers(len(space.dimensions)))]
        if len(dim.values) < 2:
            continue
        new = dim.values[int(rng.integers(len(dim.values)))]
        if new is values[dim.name] or new == values[dim.name]:
            continue
        assignment = dict(values)
        assignment[dim.name] = new
        if not space.valid(assignment):
            stats.rejected_invalid += 1
            continue
        child = DesignPoint(
            space=space,
            assignment=tuple((d.name, assignment[d.name])
                             for d in space.dimensions))
        if child.key in seen:
            stats.rejected_duplicate += 1
            continue
        seen.add(child.key)
        return child
    return None


def crossover(a: DesignPoint, b: DesignPoint,
              rng: np.random.Generator,
              seen: Optional[set] = None,
              stats: Optional[SampleStats] = None,
              max_tries: int = 64) -> Optional[DesignPoint]:
    """One uniform crossover of two parents from the same space: each
    dimension takes parent A's or B's value by fair coin.  Valid,
    unseen child or ``None``."""
    if a.space is not b.space and a.space != b.space:
        raise ValueError("crossover parents must share a DesignSpace")
    space = a.space
    seen = seen if seen is not None else set()
    stats = stats or SampleStats()
    va, vb = a.values, b.values
    for _ in range(max_tries):
        stats.proposed += 1
        assignment = {d.name: (va if rng.integers(2) else vb)[d.name]
                      for d in space.dimensions}
        if not space.valid(assignment):
            stats.rejected_invalid += 1
            continue
        child = DesignPoint(
            space=space,
            assignment=tuple((d.name, assignment[d.name])
                             for d in space.dimensions))
        if child.key in seen:
            stats.rejected_duplicate += 1
            continue
        seen.add(child.key)
        return child
    return None
