"""``quarantine-import``: live code must not import the LLM remnants.

``repro.models`` / ``repro.train`` / ``repro.configs.legacy`` are
quarantined seed-era LLM machinery: excluded from analysis (see
``analysis.cfg``) and scheduled for removal.  Any *analyzed* module
importing them re-attaches dead weight to the live simulation platform
— and, because the quarantined tree is unanalyzed, creates a blind spot
the rest of the suite cannot see into.

The port analyses its quarantined packages too (``repro_torch.models``,
``repro_torch.configs``; nothing is excluded), so a module that
lies inside a quarantined package the tree holds, or is itself a
quarantined module, may import any such package (``models/model.py`` its
sibling ``models/layers.py``, the ``configs`` registry and its ``legacy``
modules ``models/config.py``, ``launch/train.py`` the ``train``
package).  An
import of a quarantined name the tree does not hold (``repro``, ``jax``)
is a finding from every module.
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
        # the quarantined packages some analysed module lies inside
        held = tuple(p for p in prefixes
                     if any(_inside(m.rel, p) for m in tree.modules))
        for mod in tree.modules:
            if mod.tree is None:
                continue
            inside = any(_inside(mod.rel, p) for p in held)
            yield from self._check(mod, prefixes, held if inside else ())

    def _check(self, mod: ModuleInfo, prefixes, allowed=()):
        def under(name: str, roots):
            return any(name == p or name.startswith(p + ".") for p in roots)

        def hit(name: str):
            return under(name, prefixes) and not under(name, allowed)

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


def _inside(rel: str, package: str) -> bool:
    """Whether the module at path ``rel`` lies inside the dotted
    ``package`` (its parts appear in the path's directories, in order) or
    is that module (its path ends with the parts of a dotted name; a bare
    name such as ``jax`` never names a module of the tree)."""
    parts = rel[:-3].split("/") if rel.endswith(".py") else rel.split("/")
    dirs, pkg = parts[:-1], package.split(".")
    return (len(pkg) > 1 and parts[-len(pkg):] == pkg) or any(
        dirs[i:i + len(pkg)] == pkg for i in range(len(dirs) - len(pkg) + 1))
