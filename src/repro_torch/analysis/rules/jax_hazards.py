"""JAX tracer-leak / recompile hazard rules.

Inside a jitted function, Python control flow and concretization on
traced values either crash at trace time or — worse — silently bake one
traced value's shape/content into the compiled artifact and recompile
per call.  These rules find the hazard *patterns* statically:

* ``jit-tracer-branch`` — ``if``/``while`` whose test references a
  traced (non-static) parameter of the enclosing jitted function.
  ``is None`` / ``is not None`` tests are exempt (pytree-structural,
  resolved at trace time), as are tests touching only static attributes
  (``.shape`` / ``.ndim`` / ``.dtype`` / ``.size``) or ``len(...)``.
* ``jit-tracer-concretize`` — ``int()`` / ``float()`` / ``bool()`` /
  ``.item()`` / ``.tolist()`` / ``np.asarray()`` applied to a traced
  parameter inside a jitted function.
* ``jit-fstring-traced`` — f-strings interpolating a traced parameter
  (formats as ``Traced<...>``: a silent wrongness when the string feeds
  names, keys, or digests).
* ``jit-static-hazard`` — ``static_argnames`` naming a parameter that
  does not exist (the typo silently traces the arg, recompiling per
  value), or a static parameter whose default/annotation is an
  unhashable container or array type (``jit`` would raise only when the
  default is actually used).

The rules are pure AST and import no JAX.  The port has no ``jax.jit``,
``torch.compile`` or ``torch.jit``, so there is no torch hazard of this
kind to check; the rules stay so that a jit brought into the port is
held to the same discipline as in the JAX package.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (ModuleInfo, Rule, dotted_name,
                                            register)

#: attribute reads on a tracer that are static at trace time
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "aval", "weak_type"}
#: calls whose result is static even on traced arguments
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr"}
UNHASHABLE_ANNOTATIONS = {"list", "dict", "set", "List", "Dict", "Set",
                          "ndarray", "Array", "ArrayLike"}


def _is_jit_expr(node: ast.AST) -> Optional[ast.Call]:
    """The ``jax.jit(...)`` / ``partial(jax.jit, ...)`` call carrying
    the static-arg config, if ``node`` is a jit application."""
    target = node.func if isinstance(node, ast.Call) else node
    name = dotted_name(target) or ""
    short = name.split(".")[-1]
    if short == "jit":
        return node if isinstance(node, ast.Call) else None
    if short == "partial" and isinstance(node, ast.Call) and node.args:
        inner = dotted_name(node.args[0]) or ""
        if inner.split(".")[-1] == "jit":
            return node
    return None


def _is_jit_decorator(dec: ast.AST) -> Tuple[bool, Optional[ast.Call]]:
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = dotted_name(target) or ""
    short = name.split(".")[-1]
    if short == "jit":
        return True, (dec if isinstance(dec, ast.Call) else None)
    if short == "partial" and isinstance(dec, ast.Call) and dec.args:
        inner = dotted_name(dec.args[0]) or ""
        if inner.split(".")[-1] == "jit":
            return True, dec
    return False, None


def _static_config(call: Optional[ast.Call],
                   fn: ast.FunctionDef) -> Tuple[Set[str], List[str]]:
    """(static parameter names, static_argnames entries that are not
    parameters)."""
    params = [a.arg for a in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs)]
    static: Set[str] = set()
    missing: List[str] = []
    if call is None:
        return static, missing
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            try:
                names = ast.literal_eval(kw.value)
            except (ValueError, SyntaxError):
                continue
            names = [names] if isinstance(names, str) else list(names)
            for n in names:
                (static.add if n in params else missing.append)(n)
        elif kw.arg == "static_argnums":
            try:
                nums = ast.literal_eval(kw.value)
            except (ValueError, SyntaxError):
                continue
            nums = [nums] if isinstance(nums, int) else list(nums)
            positional = fn.args.posonlyargs + fn.args.args
            for i in nums:
                if isinstance(i, int) and 0 <= i < len(positional):
                    static.add(positional[i].arg)
    return static, missing


class _TracedRefs(ast.NodeVisitor):
    """Names from ``traced`` referenced other than through static
    attributes / static calls."""

    def __init__(self, traced: Set[str]):
        self.traced = traced
        self.hits: List[ast.Name] = []

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in STATIC_ATTRS:
            return                      # x.shape / x.dtype are static
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if (dotted_name(node.func) or "") in STATIC_CALLS:
            return                      # len(x) etc. are static
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if node.id in self.traced:
            self.hits.append(node)


def _traced_refs(node: ast.AST, traced: Set[str]) -> List[ast.Name]:
    v = _TracedRefs(traced)
    v.visit(node)
    return v.hits


def _jitted_functions(mod: ModuleInfo):
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in fn.decorator_list:
            is_jit, call = _is_jit_decorator(dec)
            if is_jit:
                yield fn, call
                break


def _strip_none_tests(test: ast.AST) -> Iterable[ast.AST]:
    """Decompose a test, dropping ``is (not) None`` comparisons — they
    are resolved against the pytree structure at trace time."""
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            yield from _strip_none_tests(v)
        return
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        yield from _strip_none_tests(test.operand)
        return
    if (isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops)
            and all(isinstance(c, ast.Constant) and c.value is None
                    for c in test.comparators)):
        return
    yield test


@register
class TracerBranchRule(Rule):
    name = "jit-tracer-branch"
    severity = "error"
    description = ("Python if/while on a traced value inside a jitted "
                   "function")

    def check_module(self, mod: ModuleInfo):
        for fn, call in _jitted_functions(mod):
            static, _ = _static_config(call, fn)
            traced = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)
                      } - static - {"self", "cls"}
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                for part in _strip_none_tests(node.test):
                    for ref in _traced_refs(part, traced):
                        yield self.finding(
                            mod, node.lineno,
                            f"branch on traced parameter {ref.id!r} "
                            f"inside jitted {fn.name!r} — use lax.cond/"
                            "jnp.where, or mark the argument static",
                            symbol=f"{fn.name}.{ref.id}")
                        break


@register
class TracerConcretizeRule(Rule):
    name = "jit-tracer-concretize"
    severity = "error"
    description = ("int()/float()/bool()/.item() on a traced value "
                   "inside a jitted function")

    _CASTS = {"int", "float", "bool"}
    _METHODS = {"item", "tolist"}
    _NP_FUNCS = {"np.asarray", "np.array", "numpy.asarray",
                 "numpy.array"}

    def check_module(self, mod: ModuleInfo):
        for fn, call in _jitted_functions(mod):
            static, _ = _static_config(call, fn)
            traced = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)
                      } - static - {"self", "cls"}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                hit = None
                if (name in self._CASTS or name in self._NP_FUNCS):
                    for arg in node.args:
                        refs = _traced_refs(arg, traced)
                        if refs:
                            hit = (name, refs[0].id)
                            break
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr in self._METHODS
                      and _traced_refs(node.func.value, traced)):
                    hit = (f".{node.func.attr}()",
                           _traced_refs(node.func.value, traced)[0].id)
                if hit:
                    yield self.finding(
                        mod, node.lineno,
                        f"{hit[0]} concretizes traced parameter "
                        f"{hit[1]!r} inside jitted {fn.name!r} — this "
                        "fails at trace time or forces per-call "
                        "recompiles", symbol=f"{fn.name}.{hit[1]}")


@register
class FstringTracedRule(Rule):
    name = "jit-fstring-traced"
    severity = "warning"
    description = ("f-string interpolation of a traced value inside a "
                   "jitted function")

    def check_module(self, mod: ModuleInfo):
        for fn, call in _jitted_functions(mod):
            static, _ = _static_config(call, fn)
            traced = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)
                      } - static - {"self", "cls"}
            for node in ast.walk(fn):
                if not isinstance(node, ast.JoinedStr):
                    continue
                for value in node.values:
                    if not isinstance(value, ast.FormattedValue):
                        continue
                    refs = _traced_refs(value.value, traced)
                    if refs:
                        yield self.finding(
                            mod, node.lineno,
                            f"f-string interpolates traced parameter "
                            f"{refs[0].id!r} inside jitted {fn.name!r} "
                            "— it formats as 'Traced<...>', not the "
                            "value", symbol=f"{fn.name}.{refs[0].id}")
                        break


@register
class StaticHazardRule(Rule):
    name = "jit-static-hazard"
    severity = "error"
    description = ("static_argnames naming a missing parameter, or a "
                   "static parameter of an unhashable type")

    def check_module(self, mod: ModuleInfo):
        for fn, call in _jitted_functions(mod):
            static, missing = _static_config(call, fn)
            for name in missing:
                yield self.finding(
                    mod, fn.lineno,
                    f"static_argnames names {name!r}, which is not a "
                    f"parameter of {fn.name!r} — the argument is "
                    "silently traced instead",
                    symbol=f"{fn.name}.{name}")
            args = {a.arg: a for a in (fn.args.posonlyargs + fn.args.args
                                       + fn.args.kwonlyargs)}
            defaults = dict(zip([a.arg for a in fn.args.args
                                 ][len(fn.args.args)
                                   - len(fn.args.defaults):],
                                fn.args.defaults))
            defaults.update({a.arg: d for a, d in
                             zip(fn.args.kwonlyargs, fn.args.kw_defaults)
                             if d is not None})
            for name in sorted(static):
                arg = args.get(name)
                ann = getattr(arg, "annotation", None)
                ann_base = ann.value if isinstance(ann, ast.Subscript) \
                    else ann
                ann_name = ((dotted_name(ann_base) or "").split(".")[-1]
                            if ann_base is not None else "")
                default = defaults.get(name)
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    yield self.finding(
                        mod, fn.lineno,
                        f"static parameter {name!r} of {fn.name!r} has "
                        "an unhashable (mutable container) default — "
                        "jit raises when it is used",
                        symbol=f"{fn.name}.{name}")
                elif ann_name in UNHASHABLE_ANNOTATIONS:
                    yield self.finding(
                        mod, fn.lineno,
                        f"static parameter {name!r} of {fn.name!r} is "
                        f"annotated {ann_name!r}, an unhashable/array "
                        "type — static args must be hashable",
                        symbol=f"{fn.name}.{name}")
