"""``quarantine-import``: live code must not import the LLM remnants.

``repro.models`` / ``repro.train`` / ``repro.configs.legacy`` are
quarantined seed-era LLM machinery: excluded from analysis (see
``analysis.cfg``) and scheduled for removal.  Any *analyzed* module
importing them re-attaches dead weight to the live simulation platform
— and, because the quarantined tree is unanalyzed, creates a blind spot
the rest of the suite cannot see into.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.framework import ModuleInfo, Rule, TreeInfo, register


@register
class QuarantineImportRule(Rule):
    name = "quarantine-import"
    severity = "error"
    description = "import of a quarantined (excluded) module"

    def check_tree(self, tree: TreeInfo):
        prefixes = tuple(tree.config.quarantine)
        if not prefixes:
            return
        for mod in tree.modules:
            if mod.tree is None:
                continue
            yield from self._check(mod, prefixes)

    def _check(self, mod: ModuleInfo, prefixes):
        def hit(name: str):
            return any(name == p or name.startswith(p + ".")
                       for p in prefixes)

        for node in ast.walk(mod.tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module:
                names = [f"{node.module}.{a.name}" for a in node.names]
                names.append(node.module)
            for name in names:
                if hit(name):
                    yield self.finding(
                        mod, node.lineno,
                        f"import of quarantined module {name!r} from "
                        "live code — fold the needed surface into the "
                        "live tree or drop the dependency",
                        symbol=name)
                    break
