"""``dtype-drift``: implicit platform-default dtypes in trace builders.

``np.arange(n)`` is int64 on Linux and int32 on Windows; ``np.zeros(n)``
is float64 everywhere but silently widens when mixed into an int32
pipeline.  In the trace builders and algorithm engines — whose outputs
feed byte-exact golden digests and bit-identical host/device parity
checks — an unspecified dtype is a portability and silent-promotion
hazard, so array constructors inside the configured ``dtype_scope``
directories must pin ``dtype=`` explicitly.

The same holds for torch's constructors (``torch.arange(n)`` is int64,
``torch.zeros(n)`` float32 by the global default).  Their ``dtype`` is
keyword-only, so a positional argument never pins it there.  A
``**kwargs`` splat counts as explicit, as a positional dtype does: the
port pins dtypes through shared keyword sets such as ``**i32``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.framework import (Rule, TreeInfo, dotted_name,
                                            register, scope_map)

#: constructors whose default dtype is platform- or promotion-dependent,
#: mapped to the positional index of their ``dtype`` parameter
_CTORS = {"arange": 3, "zeros": 1, "ones": 1, "empty": 1, "full": 2}
_MODULES = {"np", "numpy", "jnp", "torch"}
#: modules whose constructors take ``dtype`` by keyword only
_KEYWORD_ONLY = {"torch"}


@register
class DtypeDriftRule(Rule):
    name = "dtype-drift"
    severity = "warning"
    description = ("array constructor without an explicit dtype in a "
                   "trace-builder module")

    def check_tree(self, tree: TreeInfo):
        scope_dirs = tuple(d.rstrip("/") + "/"
                           for d in tree.config.dtype_scope)
        for mod in tree.modules:
            if mod.tree is None or not mod.rel.startswith(scope_dirs):
                continue
            scopes = scope_map(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                parts = name.split(".")
                if not (len(parts) == 2 and parts[0] in _MODULES
                        and parts[1] in _CTORS):
                    continue
                if any(kw.arg in ("dtype", None) for kw in node.keywords):
                    continue             # dtype= or a **kwargs splat
                if parts[0] not in _KEYWORD_ONLY and \
                        len(node.args) > _CTORS[parts[1]]:
                    continue             # dtype passed positionally
                # full(shape, fill) inherits the fill value's dtype —
                # only flag when the fill is a bare Python literal
                if parts[1] == "full" and len(node.args) >= 2 and not \
                        isinstance(node.args[1], (ast.Constant,
                                                  ast.UnaryOp)):
                    continue
                yield self.finding(
                    mod, node.lineno,
                    f"{name}(...) without dtype= relies on the "
                    "platform default — pin the dtype explicitly in "
                    "trace-builder code",
                    symbol=scopes.get(node, "<module>"))
