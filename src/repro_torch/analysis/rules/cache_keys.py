"""``cache-key-fields``: cache-key completeness for config dataclasses.

The silent-wrongness class this guards: a new field on
``DRAMConfig``/``CacheConfig`` that ``geometry_key`` / ``structure_key``
does not consume silently poisons the geometry-keyed model/pack caches —
two *different* devices share one packed program.

This rule turns that hand check into a machine check.  For every
dataclass that defines at least one **key member** (``geometry_key``,
``structure_key``, ``fingerprint``, ``key``, ``resolve``, or
``cache_key``), every field must be

* *consumed* by at least one key member — read as ``self.<field>``
  anywhere in the member's body or in same-class methods it calls
  (transitively; passing bare ``self`` to a function such as
  ``dataclasses.replace``/``astuple`` counts as consuming everything),
  **or**
* *declared* in a class-level ``TIMING_ONLY_FIELDS`` (alias
  ``KEY_EXEMPT_FIELDS``) mapping of ``{field: reason}`` — the explicit
  "this field deliberately does not shape identity" convention
  (timing-only traced inputs, display-only names).

Additionally, any dataclass field built with ``field(compare=False)``
silently drops out of the *generated* ``__eq__``/``__hash__`` — the
same hazard for classes used directly as dict keys — so it too must be
declared or suppressed.
"""

from __future__ import annotations

import ast
from typing import Dict, Set

from repro_torch.analysis.framework import (ModuleInfo, Rule,
                                            dataclass_fields, dotted_name,
                                            is_dataclass_def,
                                            literal_str_collection, register)

KEY_MEMBERS = ("geometry_key", "structure_key", "fingerprint", "key",
               "resolve", "cache_key")
DECLARATIONS = ("TIMING_ONLY_FIELDS", "KEY_EXEMPT_FIELDS")


def _declared_exemptions(node: ast.ClassDef) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for stmt in node.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [t.id for t in stmt.targets
                       if isinstance(t, ast.Name)]
        elif (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
              and isinstance(stmt.target, ast.Name)):
            targets = [stmt.target.id]
        if not any(t in DECLARATIONS for t in targets):
            continue
        parsed = literal_str_collection(stmt.value)
        if parsed is not None:
            out.update(parsed)
    return out


class _SelfReads(ast.NodeVisitor):
    """Collect ``self.X`` attribute reads and whether bare ``self``
    escapes (passed as an argument / returned whole)."""

    def __init__(self):
        self.attrs: Set[str] = set()
        self.escapes = False

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            self.attrs.add(node.attr)
            return  # the Name below must not count as an escape
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if node.id == "self":
            self.escapes = True


def _consumed_fields(cls: ast.ClassDef, key_methods) -> (Set[str], bool):
    """Fields transitively read by the key members (``True`` second
    element = bare ``self`` escaped, i.e. everything is consumed)."""
    methods = {stmt.name: stmt for stmt in cls.body
               if isinstance(stmt, (ast.FunctionDef,
                                    ast.AsyncFunctionDef))}
    consumed: Set[str] = set()
    visited: Set[str] = set()
    work = [m for m in key_methods]
    while work:
        name = work.pop()
        if name in visited or name not in methods:
            continue
        visited.add(name)
        reads = _SelfReads()
        for stmt in methods[name].body:
            reads.visit(stmt)
        if reads.escapes:
            return consumed, True
        consumed |= reads.attrs
        # attribute reads that are same-class methods/properties:
        # follow them (property reads look identical to field reads)
        work.extend(a for a in reads.attrs if a in methods)
    return consumed, False


def _field_compare_false(field_stmt: ast.AnnAssign) -> bool:
    v = field_stmt.value
    if not (isinstance(v, ast.Call)
            and (dotted_name(v.func) or "").split(".")[-1] == "field"):
        return False
    for kw in v.keywords:
        if kw.arg == "compare" and isinstance(kw.value, ast.Constant):
            return kw.value.value is False
    return False


@register
class CacheKeyFieldsRule(Rule):
    name = "cache-key-fields"
    severity = "error"
    description = (
        "every field of a key-bearing config dataclass must be consumed "
        "by its key members or declared in TIMING_ONLY_FIELDS")

    def check_module(self, mod: ModuleInfo):
        for cls in ast.walk(mod.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and is_dataclass_def(cls)):
                continue
            yield from self._check_class(mod, cls)

    def _check_class(self, mod: ModuleInfo, cls: ast.ClassDef):
        fields = dataclass_fields(cls)
        if not fields:
            return
        declared = _declared_exemptions(cls)
        field_names = {f.target.id for f in fields}
        for name in declared:
            if name not in field_names:
                yield self.finding(
                    mod, cls.lineno,
                    f"{cls.name}.TIMING_ONLY_FIELDS declares "
                    f"{name!r}, which is not a field — stale "
                    "declaration", symbol=f"{cls.name}.{name}")
        key_methods = [stmt.name for stmt in cls.body
                       if isinstance(stmt, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                       and stmt.name in KEY_MEMBERS]
        if key_methods:
            consumed, everything = _consumed_fields(cls, key_methods)
            if not everything:
                for f in fields:
                    fname = f.target.id
                    if fname in consumed or fname in declared:
                        continue
                    yield self.finding(
                        mod, f.lineno,
                        f"field {cls.name}.{fname} is not consumed by "
                        f"{'/'.join(sorted(key_methods))} and not "
                        "declared timing-only — two configs differing "
                        "only in this field would share cache entries "
                        "(declare it in TIMING_ONLY_FIELDS with a "
                        "reason, or consume it in the key)",
                        symbol=f"{cls.name}.{fname}")
        for f in fields:
            fname = f.target.id
            if _field_compare_false(f) and fname not in declared:
                yield self.finding(
                    mod, f.lineno,
                    f"field {cls.name}.{fname} uses compare=False, "
                    "dropping it from the generated __eq__/__hash__ "
                    "that cache keys rely on — declare it in "
                    "TIMING_ONLY_FIELDS with a reason",
                    symbol=f"{cls.name}.{fname}")
