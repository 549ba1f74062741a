"""``scenario-kwargs``: sprawling per-axis simulate()/sweep() calls.

The unified :class:`repro.sim.scenario.ScenarioSpec` is the durable
way to name a scenario (graph + ordering + updates + problem + accel +
memory/cache/timing + policy): one value that travels unchanged through
``simulate``, ``sweep``, ``SimService.submit``, and
``tune.SearchDriver``.  A call site threading three or more scenario
axes as loose keywords is re-assembling that value by hand — each such
site is one more place a new axis (like ``updates``) has to be threaded
through, and the runtime shim already warns for it
(``DeprecationWarning`` at :data:`repro.sim.scenario
.DEPRECATION_THRESHOLD` axes).  This rule is the static mirror of that
shim, so the migration debt shows up in CI instead of at call time.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.framework import ModuleInfo, Rule, register

#: the entry points whose kwargs spell out a scenario
_ENTRY_POINTS = ("simulate", "sweep")

#: mirror of ``repro.sim.scenario._AXIS_DEFAULTS`` minus the identity
#: args (graph/problem are positional there) — kept literal because the
#: analysis pass is stdlib-only and must not import the sim stack
_SCENARIO_AXES = frozenset({
    "accelerator", "memory", "cache", "variant", "config", "updates",
    "ordering", "policy", "root", "fixed_iters", "graph_scale",
    "graph_seed",
})

#: mirror of ``repro.sim.scenario.DEPRECATION_THRESHOLD``
_THRESHOLD = 3


@register
class ScenarioKwargsRule(Rule):
    name = "scenario-kwargs"
    severity = "warning"
    description = ("simulate()/sweep() call threading >= "
                   f"{_THRESHOLD} scenario axes as loose keywords "
                   "instead of a ScenarioSpec")

    def check_module(self, mod: ModuleInfo):
        if mod.tree is None:
            return
        # the scenario machinery itself (and its shims/tests-of-shims)
        # legitimately spells axes out
        if mod.rel.endswith(("sim/scenario.py", "sim/session.py",
                             "sim/sweep.py")):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = (func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None)
            if name not in _ENTRY_POINTS:
                continue
            axes = sorted(kw.arg for kw in node.keywords
                          if kw.arg in _SCENARIO_AXES)
            if len(axes) >= _THRESHOLD:
                yield self.finding(
                    mod, node.lineno,
                    f"{name}() call threads {len(axes)} scenario axes "
                    f"({', '.join(axes)}) as keywords — bundle them in "
                    "a ScenarioSpec",
                    symbol=f"{name}:{':'.join(axes)}")
