"""``kernel-parity``: every kernel must keep its plain version.

The repo's kernel discipline takes two forms, one a package:

* the JAX package's Pallas kernels: each ``kernels/<op>/kernel.py``
  public entry point has a pure-jnp/NumPy reference ``<stem>_ref`` in the
  sibling ``ref.py`` whose parameters are a subset of the kernel's (no
  block-shape or ``interpret`` tuning knobs), and interpret-path
  coverage in the kernel test module, so CPU CI exercises the Pallas
  body without an accelerator;
* the port's hand-written CUDA kernels (when the config names a
  ``csrc_root``): each ``<csrc_root>/<stem>.cu`` has a public wrapper
  ``<stem>`` in some ``kernels/*/ops.py`` and a plain PyTorch version
  ``<stem>_ref`` in the sibling ``ref.py``, again with a subset of the
  wrapper's parameters.

A kernel without its plain version (or with a drifted signature)
silently loses the bit-equivalence contract the whole device/host split
rests on; this rule makes the pairing structural.
``kernel-parity-coverage`` checks the other direction: every
``<stem>_ref`` is named by the kernel test files, the places where a
kernel is held against its plain version.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.framework import Rule, TreeInfo, register


def _public_defs(tree) -> Dict[str, List[str]]:
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            out[node.name] = [a.arg for a in (node.args.posonlyargs
                                              + node.args.args
                                              + node.args.kwonlyargs)]
    return out


def _def_line(tree, name: str) -> int:
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node.lineno
    return 1


def _kernel_tests_source(tree: TreeInfo) -> str:
    """The kernel test files' text, joined (missing files read empty)."""
    parts = []
    for rel in tree.config.kernel_tests:
        path = tree.root / rel
        if path.exists():
            parts.append(path.read_text(encoding="utf-8"))
    return "\n".join(parts)


def _kernel_modules(tree: TreeInfo, suffix: str):
    root = tree.config.kernels_root.rstrip("/")
    return [m for m in tree.modules
            if m.rel.startswith(root + "/") and m.rel.endswith(suffix)
            and m.tree is not None]


@register
class KernelParityRule(Rule):
    name = "kernel-parity"
    severity = "error"
    description = ("every public kernel.py op (and every CUDA source's "
                   "ops.py wrapper) needs a matching ref.py oracle and "
                   "test coverage")

    def check_tree(self, tree: TreeInfo):
        yield from self._check_pallas(tree)
        yield from self._check_csrc(tree)

    def _oracle(self, mod, ref_mod, name, stem, line):
        """Findings for op ``name`` of ``mod`` against ``<stem>_ref`` in
        ``ref_mod`` (a missing ref.py, a missing ref, drifted
        parameters)."""
        want = f"{stem}_ref"
        if ref_mod is None:
            pkg = mod.rel.rsplit("/", 2)[-2]
            yield self.finding(
                mod, line,
                f"kernel package {pkg!r} has no ref.py oracle "
                f"for {name!r}", symbol=name)
            return
        refs = (_public_defs(ref_mod.tree) if ref_mod.tree is not None
                else {})
        if want not in refs:
            yield self.finding(
                mod, line,
                f"kernel op {name!r} has no {want!r} "
                "counterpart in ref.py — the bit-equivalence "
                "oracle is missing", symbol=name)
            return
        params = _public_defs(mod.tree)[name]
        extra = [p for p in refs[want] if p not in params]
        if extra:
            yield self.finding(
                mod, line,
                f"ref oracle {want!r} takes {extra} which "
                f"{name!r} does not — signatures drifted",
                symbol=name)

    def _check_pallas(self, tree: TreeInfo):
        tests_src = _kernel_tests_source(tree)
        for kmod in _kernel_modules(tree, "/kernel.py"):
            pkg = kmod.rel.rsplit("/", 2)[-2]
            ref_mod = tree.module(kmod.rel[:-len("kernel.py")]
                                  + "ref.py")
            for name in _public_defs(kmod.tree):
                stem = (name[:-len("_kernel")]
                        if name.endswith("_kernel") else name)
                yield from self._oracle(kmod, ref_mod, name, stem,
                                        _def_line(kmod.tree, name))
            if pkg not in tests_src:
                yield self.finding(
                    kmod, 1,
                    f"kernel package {pkg!r} is not referenced by "
                    f"{tree.config.kernel_tests_label} — interpret-path "
                    "coverage is missing", symbol=pkg)

    def _check_csrc(self, tree: TreeInfo):
        """Each CUDA source against its wrapper and plain version.  Runs
        only when the pass covers the kernels root (a pass over part of
        the tree cannot see the wrappers)."""
        csrc_root = tree.config.csrc_root.rstrip("/")
        ops_mods = _kernel_modules(tree, "/ops.py")
        csrc = tree.root / csrc_root if csrc_root else None
        if csrc is None or not csrc.is_dir() or not ops_mods:
            return
        for src in sorted(csrc.glob("*.cu")):
            stem, rel = src.stem, f"{csrc_root}/{src.name}"
            owner = next((m for m in ops_mods
                          if stem in _public_defs(m.tree)), None)
            if owner is None:
                yield self.finding(
                    None, 1,
                    f"CUDA source {rel} has no public {stem!r} wrapper in "
                    f"any {tree.config.kernels_root.rstrip('/')}/*/ops.py",
                    symbol=stem, path=rel)
                continue
            ref_mod = tree.module(owner.rel[:-len("ops.py")] + "ref.py")
            yield from self._oracle(owner, ref_mod, stem, stem,
                                    _def_line(owner.tree, stem))


@register
class KernelParityCoverageRule(Rule):
    name = "kernel-parity-coverage"
    severity = "error"
    description = ("every ref.py oracle symbol must be exercised by the "
                   "kernel parity tests")

    def check_tree(self, tree: TreeInfo):
        """The inverse direction of ``kernel-parity``: that rule proves
        each kernel op HAS an oracle; this one proves each oracle is
        actually *used* — a ``<stem>_ref`` never named by the kernel
        test files is a parity test that silently stopped running
        (e.g. the test was deleted or renamed while the oracle stayed
        behind)."""
        tests_src = _kernel_tests_source(tree)
        for rmod in _kernel_modules(tree, "/ref.py"):
            for name in _public_defs(rmod.tree):
                if not name.endswith("_ref"):
                    continue
                if name not in tests_src:
                    yield self.finding(
                        rmod, _def_line(rmod.tree, name),
                        f"ref oracle {name!r} is never exercised by "
                        f"{tree.config.kernel_tests_label} — its parity "
                        "test is missing or was renamed away", symbol=name)
