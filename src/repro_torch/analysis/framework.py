"""Core of the repo-aware static-analysis suite: findings, the rule
registry, module loading, ``# repro: noqa[...]`` suppressions, and the
``[analysis]`` config.

The framework is deliberately stdlib-only (``ast`` + ``configparser``):
the lint pass must run in CI jobs and pre-commit hooks without importing
torch or the simulation stack.  Rules live in
:mod:`repro_torch.analysis.rules` and register themselves via
:func:`register`; each rule is either *per-module* (``check_module`` sees
one parsed file) or *tree-wide* (``check_tree`` sees every analyzed
module at once — e.g. the kernel parity rule, which pairs each CUDA
source with its wrapper and its plain version).

Severity semantics: **every** unbaselined finding fails the run
(``error`` and ``warning`` alike) — severity encodes *policy*, not
whether CI cares: ``error`` findings in the live simulation packages
must be fixed, never baselined without justification; ``warning``
findings may be baselined with a one-line justification
(see :mod:`repro_torch.analysis.baseline`).
"""

from __future__ import annotations

import ast
import configparser
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

SEVERITIES = ("error", "warning")

#: suppression comment: ``# repro: noqa[rule-a,rule-b]`` silences the
#: named rules on that line; bare ``# repro: noqa`` silences every rule.
_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\s*\[([A-Za-z0-9_,\- ]+)\])?", re.IGNORECASE)

#: the port's config at the repository root (``analysis.cfg`` beside it
#: configures the JAX package's pass; ``--config`` reads either)
CONFIG_FILENAME = "analysis_torch.cfg"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported defect.

    ``symbol`` is the stable anchor (class/function/field name) used for
    baseline fingerprints, so committed baselines survive line drift.
    """

    rule: str
    severity: str
    path: str                       # repo-relative, posix separators
    line: int
    message: str
    symbol: str = ""

    #: the fingerprint deliberately drops line/severity/message-detail —
    #: baselines must survive line drift and severity retuning
    KEY_EXEMPT_FIELDS = {
        "severity": "a rule's severity can be retuned without "
                    "invalidating baselined findings",
        "line": "line numbers drift on unrelated edits",
    }

    @property
    def fingerprint(self):
        return (self.rule, self.path, self.symbol or self.message)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}"
                f"[{self.rule}] {self.message}")


class Rule:
    """Base class for lint rules; subclasses set ``name`` / ``severity``
    / ``description`` and override one of the two hooks."""

    name: str = ""
    severity: str = "error"
    description: str = ""

    def check_module(self, mod: "ModuleInfo") -> Iterable[Finding]:
        return ()

    def check_tree(self, tree: "TreeInfo") -> Iterable[Finding]:
        return ()

    def finding(self, mod: Optional["ModuleInfo"], line: int,
                message: str, symbol: str = "",
                path: Optional[str] = None) -> Finding:
        return Finding(rule=self.name, severity=self.severity,
                       path=path if path is not None else mod.rel,
                       line=line, message=message, symbol=symbol)


RULES: Dict[str, Rule] = {}


def register(rule_cls: Callable[[], Rule]):
    """Class decorator: instantiate and add to the global registry."""
    inst = rule_cls()
    if not inst.name or inst.severity not in SEVERITIES:
        raise ValueError(f"rule {rule_cls!r} needs a name and a "
                         f"severity in {SEVERITIES}")
    if inst.name in RULES:
        raise ValueError(f"duplicate rule name {inst.name!r}")
    RULES[inst.name] = inst
    return rule_cls


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file."""

    path: Path
    rel: str
    source: str
    lines: List[str]
    tree: Optional[ast.AST]          # None when the file failed to parse
    #: line -> suppressed rule names (``None`` = blanket noqa)
    noqa: Dict[int, Optional[frozenset]]


@dataclasses.dataclass
class AnalysisConfig:
    """The ``[analysis]`` section of the config file at the repo root.

    ``exclude`` scopes the pass *explicitly* (a skipped tree must be
    listed, not silently dropped, so dead code can't mask real
    findings); the remaining keys point the repo-aware rules at their
    subjects.  ``kernel_tests`` names every file that holds a kernel
    against its plain version (one path or several); ``csrc_root`` is
    the directory of CUDA sources that the kernel-parity rule pairs with
    their wrappers (``""``: none).
    """

    exclude: Sequence[str] = ()
    quarantine: Sequence[str] = ("repro", "jax", "jaxlib",
                                 "repro_torch.models",
                                 "repro_torch.configs",
                                 "repro_torch.train",
                                 "repro_torch.launch.train",
                                 "repro_torch.launch.specs",
                                 "repro_torch.launch.costmodel",
                                 "repro_torch.launch.roofline",
                                 "repro_torch.launch.dryrun")
    kernels_root: str = "src/repro_torch/kernels"
    kernel_tests: Sequence[str] = ("tests/test_torch_cuda.py",
                                   "chip_smoke.py")
    dtype_scope: Sequence[str] = ("src/repro_torch/core",
                                  "src/repro_torch/algorithms")
    csrc_root: str = "src/repro_torch/csrc"

    def __post_init__(self):
        if isinstance(self.kernel_tests, str):
            self.kernel_tests = (self.kernel_tests,)
        self.kernel_tests = tuple(self.kernel_tests)

    @property
    def kernel_tests_label(self) -> str:
        """The kernel test files as findings name them."""
        return " or ".join(self.kernel_tests)


def load_config(root: Path, filename: str = CONFIG_FILENAME
                ) -> AnalysisConfig:
    """The config in ``root / filename``; the defaults where it is
    missing.  A config file that names no ``csrc_root`` pairs no CUDA
    sources (the JAX package's ``analysis.cfg`` has none)."""
    cfg_path = root / filename
    cfg = AnalysisConfig()
    if not cfg_path.exists():
        return cfg
    parser = configparser.ConfigParser()
    parser.read(cfg_path)
    if not parser.has_section("analysis"):
        return cfg

    def _list(key, default):
        raw = parser.get("analysis", key, fallback=None)
        if raw is None:
            return default
        return tuple(x.strip() for x in raw.split() if x.strip())

    return AnalysisConfig(
        exclude=_list("exclude", cfg.exclude),
        quarantine=_list("quarantine", cfg.quarantine),
        kernels_root=parser.get("analysis", "kernels_root",
                                fallback=cfg.kernels_root),
        kernel_tests=_list("kernel_tests", cfg.kernel_tests),
        dtype_scope=_list("dtype_scope", cfg.dtype_scope),
        csrc_root=parser.get("analysis", "csrc_root", fallback="").strip(),
    )


@dataclasses.dataclass
class TreeInfo:
    """Everything a tree-wide rule sees."""

    root: Path
    modules: List[ModuleInfo]
    config: AnalysisConfig

    def module(self, rel: str) -> Optional[ModuleInfo]:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None


def _noqa_map(lines: List[str]) -> Dict[int, Optional[frozenset]]:
    out: Dict[int, Optional[frozenset]] = {}
    for i, line in enumerate(lines, start=1):
        m = _NOQA_RE.search(line)
        if not m:
            continue
        names = m.group(1)
        out[i] = (None if names is None else frozenset(
            n.strip() for n in names.split(",") if n.strip()))
    return out


def load_module(path: Path, root: Path) -> ModuleInfo:
    source = path.read_text(encoding="utf-8")
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError:
        tree = None
    return ModuleInfo(path=path, rel=path.relative_to(root).as_posix(),
                      source=source, lines=lines, tree=tree,
                      noqa=_noqa_map(lines))


def _excluded(rel: str, config: AnalysisConfig) -> bool:
    return any(rel == e or rel.startswith(e.rstrip("/") + "/")
               for e in config.exclude)


def collect_modules(paths: Sequence[Path], root: Path,
                    config: AnalysisConfig) -> List[ModuleInfo]:
    seen = set()
    mods: List[ModuleInfo] = []
    for p in paths:
        p = p if p.is_absolute() else root / p
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            rel = f.relative_to(root).as_posix()
            if rel in seen or _excluded(rel, config):
                continue
            seen.add(rel)
            mods.append(load_module(f, root))
    return mods


def _suppressed(f: Finding, by_rel: Dict[str, ModuleInfo]) -> bool:
    mod = by_rel.get(f.path)
    if mod is None:
        return False
    names = mod.noqa.get(f.line, ())
    return names is None or f.rule in names


def run_analysis(paths: Sequence[Path], root: Path,
                 config: Optional[AnalysisConfig] = None
                 ) -> List[Finding]:
    """Run every registered rule over ``paths``; returns findings sorted
    by (path, line, rule), ``noqa``-suppressed ones removed."""
    # importing the rules registers them
    from repro_torch.analysis import rules as _rules  # noqa: F401

    config = config if config is not None else load_config(root)
    modules = collect_modules(paths, root, config)
    tree = TreeInfo(root=root, modules=modules, config=config)
    findings: List[Finding] = []
    for mod in modules:
        if mod.tree is None:
            findings.append(Finding(
                rule="syntax-error", severity="error", path=mod.rel,
                line=1, message="file does not parse",
                symbol="<module>"))
    for rule in RULES.values():
        for mod in modules:
            if mod.tree is not None:
                findings.extend(rule.check_module(mod))
        findings.extend(rule.check_tree(tree))
    by_rel = {m.rel: m for m in modules}
    findings = [f for f in findings if not _suppressed(f, by_rel)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# ---------------------------------------------------------------------------
# Shared AST helpers used by several rules.
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def is_dataclass_def(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target) or ""
        if name == "dataclass" or name.endswith(".dataclass"):
            return True
    return False


def dataclass_fields(node: ast.ClassDef) -> List[ast.AnnAssign]:
    """Annotated class-level assignments that become dataclass fields
    (``ClassVar`` annotations are not fields)."""
    out = []
    for stmt in node.body:
        if not (isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)):
            continue
        ann = stmt.annotation
        base = ann.value if isinstance(ann, ast.Subscript) else ann
        if (dotted_name(base) or "").split(".")[-1] == "ClassVar":
            continue
        out.append(stmt)
    return out


def scope_map(tree: ast.AST) -> Dict[ast.AST, str]:
    """Map every node to its enclosing def/class qualname (``<module>``
    at top level) — the stable symbol anchor for baseline entries."""
    out: Dict[ast.AST, str] = {}

    def visit(node: ast.AST, scope: str):
        out[node] = scope
        child_scope = scope
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            child_scope = (node.name if scope == "<module>"
                           else f"{scope}.{node.name}")
            out[node] = child_scope
        for child in ast.iter_child_nodes(node):
            visit(child, child_scope)

    visit(tree, "<module>")
    return out


def literal_str_collection(node: ast.AST) -> Optional[Dict[str, str]]:
    """Parse a declaration literal into ``{name: reason}``: accepts a
    dict of str -> str, or a set/tuple/list/frozenset of str (reasons
    empty)."""
    if isinstance(node, ast.Call) and (dotted_name(node.func) or "") in (
            "frozenset", "set", "tuple", "list", "dict") and node.args:
        return literal_str_collection(node.args[0])
    try:
        value = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    if isinstance(value, dict):
        if all(isinstance(k, str) and isinstance(v, str)
               for k, v in value.items()):
            return dict(value)
        return None
    if isinstance(value, (set, frozenset, tuple, list)):
        if all(isinstance(k, str) for k in value):
            return {k: "" for k in value}
    return None
