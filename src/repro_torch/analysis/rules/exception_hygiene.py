"""``bare-base-exception``: broad exception traps must not swallow.

``except:`` and ``except BaseException`` catch ``KeyboardInterrupt``,
``SystemExit``, and the service's injected :class:`WorkerCrash` — the
exact signals that must *escape* ordinary error handling.  A handler
that swallows them turns a Ctrl-C into a hang and defeats the worker
supervisor (the sweep engine's crash-injection tests rely on
``BaseException`` escaping every per-case guard).

A broad handler is sanctioned when it provably forwards the exception
instead of absorbing it:

* it re-raises — a bare ``raise``, or ``raise <something> from err``
  chaining the caught name; or
* it hands the caught exception to a future via
  ``<fut>.set_exception(err)`` (the single-flight cache idiom: the
  exception still reaches every waiter through ``fut.result()``).

Anything else needs an explicit ``# repro: noqa[bare-base-exception]``
with a justification — the repo's one legitimate swallow site is the
service supervisor itself, whose whole job is to absorb a dying worker
thread.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.framework import ModuleInfo, Rule, TreeInfo, register


def _caught_name(handler: ast.ExceptHandler):
    return handler.name  # ``except ... as e`` -> "e", else None


def _forwards(handler: ast.ExceptHandler) -> bool:
    """True when the handler body re-raises or set_exception-forwards
    the caught exception."""
    name = _caught_name(handler)
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True                      # bare ``raise``
            if isinstance(node.exc, ast.Name) and node.exc.id == name:
                return True                      # ``raise e``
            cause = node.cause
            if (isinstance(cause, ast.Name) and cause.id == name):
                return True                      # ``raise X(...) from e``
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "set_exception"
                and name is not None
                and any(isinstance(a, ast.Name) and a.id == name
                        for a in node.args)):
            return True                          # ``fut.set_exception(e)``
    return False


@register
class BareBaseExceptionRule(Rule):
    name = "bare-base-exception"
    severity = "error"
    description = ("broad except (bare / BaseException) that swallows "
                   "instead of forwarding")

    def check_tree(self, tree: TreeInfo):
        for mod in tree.modules:
            if mod.tree is None:
                continue
            yield from self._check(mod)

    def _check(self, mod: ModuleInfo):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = (node.type is None
                     or (isinstance(node.type, ast.Name)
                         and node.type.id == "BaseException"))
            if not broad or _forwards(node):
                continue
            what = ("bare except:" if node.type is None
                    else "except BaseException")
            yield self.finding(
                mod, node.lineno,
                f"{what} swallows KeyboardInterrupt/WorkerCrash — "
                "narrow to Exception, re-raise, or forward via "
                "set_exception (supervisors may noqa with a reason)",
                symbol=what)
