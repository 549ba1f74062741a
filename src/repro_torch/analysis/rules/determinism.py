"""``nondeterministic-order``: unordered-set iteration feeding program
order.

Sweep expansion order, cache-key construction, and golden digests must
be reproducible run-to-run; iterating a ``set`` (hash order varies with
``PYTHONHASHSEED`` for str contents and with insertion history) anywhere
in the live tree is how nondeterminism sneaks into all three.  Dict
iteration is insertion-ordered and deterministic, so only set types are
flagged.  The fix is ``sorted(...)`` (accepted as an immediate wrapper)
or an order-preserving container.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.framework import (ModuleInfo, Rule, dotted_name,
                                            register, scope_map)

_SET_CALLS = {"set", "frozenset"}
_ITER_WRAPPERS = {"list", "tuple", "enumerate", "reversed", "iter"}
_ORDER_SAFE = {"sorted", "min", "max", "sum", "len", "any", "all",
               "bool"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = (dotted_name(node.func) or "").split(".")[-1]
        return name in _SET_CALLS
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        # set algebra: a | b, a - b ... only when an operand is a set
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


@register
class NondeterministicOrderRule(Rule):
    name = "nondeterministic-order"
    severity = "error"
    description = "iteration over an unordered set"

    def check_module(self, mod: ModuleInfo):
        scopes = scope_map(mod.tree)
        for node in ast.walk(mod.tree):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            elif isinstance(node, ast.Call):
                name = (dotted_name(node.func) or "").split(".")[-1]
                if name in _ITER_WRAPPERS and node.args:
                    iters.append(node.args[0])
            for it in iters:
                if _is_set_expr(it):
                    yield self.finding(
                        mod, it.lineno,
                        "iteration over an unordered set — order leaks "
                        "into downstream state; wrap in sorted(...) or "
                        "use an order-preserving container",
                        symbol=scopes.get(node, "<module>"))
