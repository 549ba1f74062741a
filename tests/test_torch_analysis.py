"""Per-rule positive/negative fixtures for the port's static suite
(``repro_torch.analysis``), baseline-gate semantics and the CLI contract
(synthetic bugs must fail the gate naming rule, file, and line): the 52
cases of ``tests/test_analysis.py``, on the same synthetic sources, run
on the port.  Then what the port adds: torch constructors in
``dtype-drift``, the CUDA-source pairing of ``kernel-parity`` (each
``csrc/<stem>.cu`` with a wrapper in ``kernels/*/ops.py`` and a plain
version in the sibling ``ref.py``), the port's config and gate over its
own tree, parity with ``repro.analysis`` (the same findings and gate on
the same trees, and over ``src/repro`` with ``analysis.cfg``), and a
probe that the static pass imports neither torch, JAX nor ``repro``."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import (apply_baseline as r_apply_baseline,
                            load_baseline as r_load_baseline,
                            load_config as r_load_config,
                            run_analysis as r_run_analysis)
from repro.analysis.framework import AnalysisConfig as RAnalysisConfig

from repro_torch.analysis import (BaselineEntry, apply_baseline,
                                  load_baseline, load_config, run_analysis,
                                  save_baseline, update_baseline)
from repro_torch.analysis.baseline import UNREVIEWED
from repro_torch.analysis.framework import AnalysisConfig

REPO_ROOT = Path(__file__).resolve().parents[1]
SRC = REPO_ROOT / "src"

CFG = AnalysisConfig(
    exclude=(),
    quarantine=("repro.models", "repro.train"),
    kernels_root="kernels",
    kernel_tests="tests/test_kernels.py",
    dtype_scope=("core",),
    csrc_root="",
)


def lint(tmp_path, source, rel="core/mod.py", cfg=CFG, extra=None):
    """Write fixture files into a scratch repo and run the full suite.

    Sources are dedented per-line-block, so a ``DC``-prefixed class
    body (unindented prefix + indented triple-quote body) still lands
    at column zero."""
    files = {rel: source}
    files.update(extra or {})
    for r, src in files.items():
        f = tmp_path / r
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src), encoding="utf-8")
    return run_analysis([tmp_path], tmp_path, cfg)


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# cache-key-fields
# ---------------------------------------------------------------------------

def dc(body: str) -> str:
    """A dataclass fixture module: dedent the body, prepend imports."""
    return ("import dataclasses\n\n\n@dataclasses.dataclass\n"
            + textwrap.dedent(body))


class TestCacheKeyFields:
    def test_unconsumed_field_flagged(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int
                banks: int
                label: str

                def geometry_key(self):
                    return (self.channels, self.banks)
            """))
        assert rules_of(out) == ["cache-key-fields"]
        (f,) = out
        assert f.symbol == "Cfg.label"
        assert f.severity == "error"

    def test_declared_timing_only_passes(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int
                label: str

                TIMING_ONLY_FIELDS = {"label": "display only"}

                def geometry_key(self):
                    return (self.channels,)
            """))
        assert out == []

    def test_transitive_consumption_through_method(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int
                banks: int

                def _inner(self):
                    return self.banks

                def geometry_key(self):
                    return (self.channels, self._inner())
            """))
        assert out == []

    def test_bare_self_escape_consumes_everything(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int
                label: str

                def key(self):
                    return dataclasses.astuple(self)
            """))
        assert out == []

    def test_compare_false_needs_declaration(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int
                name: str = dataclasses.field(default="", compare=False)
            """))
        assert rules_of(out) == ["cache-key-fields"]
        assert out[0].symbol == "Cfg.name"

    def test_stale_declaration_flagged(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Cfg:
                channels: int

                TIMING_ONLY_FIELDS = {"ghost": "never existed"}

                def geometry_key(self):
                    return (self.channels,)
            """))
        assert rules_of(out) == ["cache-key-fields"]
        assert out[0].symbol == "Cfg.ghost"

    def test_keyless_dataclass_ignored(self, tmp_path):
        out = lint(tmp_path, dc("""\
            class Row:
                value: int
                label: str
            """))
        assert out == []


# ---------------------------------------------------------------------------
# jit hazard rules
# ---------------------------------------------------------------------------

class TestJaxHazards:
    def test_branch_on_traced_param(self, tmp_path):
        out = lint(tmp_path, """\
            import jax


            @jax.jit
            def f(x):
                if x > 0:
                    return x
                return -x
            """)
        assert rules_of(out) == ["jit-tracer-branch"]
        assert out[0].symbol == "f.x"

    def test_branch_on_static_param_ok(self, tmp_path):
        out = lint(tmp_path, """\
            import functools
            import jax


            @functools.partial(jax.jit, static_argnames="mode")
            def f(x, mode):
                if mode:
                    return x
                return -x
            """)
        assert out == []

    def test_is_none_and_shape_tests_ok(self, tmp_path):
        out = lint(tmp_path, """\
            import jax


            @jax.jit
            def f(x, y):
                if y is None:
                    return x
                if x.ndim == 2:
                    return x + y
                return x - y
            """)
        assert out == []

    def test_concretize_traced_param(self, tmp_path):
        out = lint(tmp_path, """\
            import jax


            @jax.jit
            def f(x):
                return int(x)
            """)
        assert rules_of(out) == ["jit-tracer-concretize"]

    def test_item_on_traced_param(self, tmp_path):
        out = lint(tmp_path, """\
            import jax


            @jax.jit
            def f(x):
                return x.item()
            """)
        assert rules_of(out) == ["jit-tracer-concretize"]

    def test_fstring_on_traced_param_warns(self, tmp_path):
        out = lint(tmp_path, """\
            import jax


            @jax.jit
            def f(x):
                label = f"value={x}"
                return x, label
            """)
        assert rules_of(out) == ["jit-fstring-traced"]
        assert out[0].severity == "warning"

    def test_static_argnames_typo(self, tmp_path):
        out = lint(tmp_path, """\
            import functools
            import jax


            @functools.partial(jax.jit, static_argnames=("mdoe",))
            def f(x, mode=0):
                return x * mode
            """)
        assert rules_of(out) == ["jit-static-hazard"]
        assert out[0].symbol == "f.mdoe"

    def test_unhashable_static_annotation(self, tmp_path):
        out = lint(tmp_path, """\
            import functools
            import jax


            @functools.partial(jax.jit, static_argnames=("shape",))
            def f(x, shape: list):
                return x.reshape(shape)
            """)
        assert rules_of(out) == ["jit-static-hazard"]

    def test_unjitted_function_untouched(self, tmp_path):
        out = lint(tmp_path, """\
            def f(x):
                if x > 0:
                    return int(x)
                return -x
            """)
        assert out == []


# ---------------------------------------------------------------------------
# nondeterministic-order
# ---------------------------------------------------------------------------

class TestDeterminism:
    def test_iterating_a_set_flagged(self, tmp_path):
        out = lint(tmp_path, """\
            def f(items):
                seen = set(items)
                return [x + 1 for x in seen if x]  # not flagged: name

            def g(items):
                out = []
                for x in {i.name for i in items}:
                    out.append(x)
                return out
            """)
        assert rules_of(out) == ["nondeterministic-order"]
        assert out[0].symbol == "g"

    def test_sorted_set_ok(self, tmp_path):
        out = lint(tmp_path, """\
            def g(items):
                return [x for x in sorted(set(items))]
            """)
        assert out == []

    def test_set_algebra_flagged(self, tmp_path):
        out = lint(tmp_path, """\
            def g(a, b):
                return list(set(a) - set(b))
            """)
        assert rules_of(out) == ["nondeterministic-order"]


# ---------------------------------------------------------------------------
# dtype-drift
# ---------------------------------------------------------------------------

class TestDtypeDrift:
    def test_default_dtype_in_scope_flagged(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)
            """)
        assert rules_of(out) == ["dtype-drift"]
        assert out[0].severity == "warning"
        assert out[0].symbol == "build"

    def test_explicit_or_positional_dtype_ok(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                a = np.arange(n, dtype=np.int64)
                b = np.zeros((n, n), np.int32)
                c = np.full(n, np.float32(0))
                return a, b, c
            """)
        assert out == []

    def test_out_of_scope_module_ignored(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)
            """, rel="tools/mod.py")
        assert out == []


# ---------------------------------------------------------------------------
# kernel-parity
# ---------------------------------------------------------------------------

KERNEL = """\
    def scan_kernel(x, block=128, interpret=False):
        return x
"""


class TestKernelParity:
    def test_missing_ref_module(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"tests/test_kernels.py": "# exercises scan\n"})
        assert rules_of(out) == ["kernel-parity"]
        assert "no ref.py" in out[0].message

    def test_missing_ref_function(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py": "def other_ref(x):\n"
                                                 "    return x\n",
                          "tests/test_kernels.py":
                          "# exercises scan via other_ref\n"})
        assert rules_of(out) == ["kernel-parity"]
        assert out[0].symbol == "scan_kernel"

    def test_ref_signature_drift(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py":
                          "def scan_ref(x, extra_knob):\n    return x\n",
                          "tests/test_kernels.py":
                          "# exercises scan_ref\n"})
        assert rules_of(out) == ["kernel-parity"]
        assert "extra_knob" in out[0].message

    def test_missing_test_coverage(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py":
                          "def scan_ref(x):\n    return x\n",
                          "tests/test_kernels.py": "# nothing here\n"})
        # both directions fire: the package isn't referenced
        # (kernel-parity) and its oracle is never exercised
        # (kernel-parity-coverage)
        assert rules_of(out) == ["kernel-parity",
                                 "kernel-parity-coverage"]
        assert any("coverage is missing" in f.message for f in out)

    def test_paired_kernel_passes(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py":
                          "def scan_ref(x, block=128):\n    return x\n",
                          "tests/test_kernels.py":
                          "# exercises scan_ref\n"})
        assert out == []


class TestKernelParityCoverage:
    def test_unexercised_ref_flagged(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py":
                          "def scan_ref(x, block=128):\n    return x\n"
                          "def extra_ref(x):\n    return x\n",
                          "tests/test_kernels.py":
                          "# exercises scan_ref only\n"})
        assert rules_of(out) == ["kernel-parity-coverage"]
        (f,) = out
        assert f.symbol == "extra_ref"
        assert f.path == "kernels/scan/ref.py"

    def test_private_and_non_ref_helpers_ignored(self, tmp_path):
        out = lint(tmp_path, KERNEL, rel="kernels/scan/kernel.py",
                   extra={"kernels/scan/ref.py":
                          "def scan_ref(x, block=128):\n    return x\n"
                          "def _loop_ref(x):\n    return x\n"
                          "def unpack(x):\n    return x\n",
                          "tests/test_kernels.py":
                          "# exercises scan_ref\n"})
        assert out == []


# ---------------------------------------------------------------------------
# quarantine-import
# ---------------------------------------------------------------------------

class TestQuarantine:
    def test_import_flagged(self, tmp_path):
        out = lint(tmp_path, """\
            from repro.models.config import ModelConfig
            import repro.train.optimizer
            """)
        assert rules_of(out) == ["quarantine-import"]
        assert len(out) == 2

    def test_live_imports_ok(self, tmp_path):
        out = lint(tmp_path, """\
            from repro.sim.sweep import Sweeper
            import repro.graphs.corpus
            """)
        assert out == []


# ---------------------------------------------------------------------------
# framework: noqa, syntax errors, exclusion
# ---------------------------------------------------------------------------

class TestFramework:
    def test_noqa_suppresses_named_rule(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)  # repro: noqa[dtype-drift]
            """)
        assert out == []

    def test_noqa_other_rule_does_not_suppress(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)  # repro: noqa[kernel-parity]
            """)
        assert rules_of(out) == ["dtype-drift"]

    def test_blanket_noqa(self, tmp_path):
        out = lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)  # repro: noqa
            """)
        assert out == []

    def test_syntax_error_is_a_finding(self, tmp_path):
        out = lint(tmp_path, "def broken(:\n")
        assert rules_of(out) == ["syntax-error"]

    def test_excluded_dir_skipped(self, tmp_path):
        cfg = AnalysisConfig(exclude=("core/legacy",),
                             quarantine=CFG.quarantine,
                             kernels_root=CFG.kernels_root,
                             kernel_tests=CFG.kernel_tests,
                             dtype_scope=CFG.dtype_scope,
                             csrc_root=CFG.csrc_root)
        out = lint(tmp_path, """\
            import numpy as np
            a = np.arange(4)
            """, rel="core/legacy/mod.py", cfg=cfg)
        assert out == []


# ---------------------------------------------------------------------------
# baseline gate
# ---------------------------------------------------------------------------

class TestBaseline:
    def _findings(self, tmp_path):
        return lint(tmp_path, """\
            import numpy as np

            def build(n):
                return np.arange(n)
            """)

    def test_unjustified_entries_fail_gate(self, tmp_path):
        findings = self._findings(tmp_path)
        entries = update_baseline(findings, [])
        assert [e.justification for e in entries] == [UNREVIEWED]
        gate = apply_baseline(findings, entries)
        assert not gate.ok and gate.unjustified_entries

    def test_justified_entries_pass_gate(self, tmp_path):
        findings = self._findings(tmp_path)
        entries = update_baseline(findings, [])
        entries = [BaselineEntry(e.rule, e.path, e.symbol,
                                 "accepted: fixture") for e in entries]
        gate = apply_baseline(findings, entries)
        assert gate.ok and gate.baselined == len(findings)

    def test_new_finding_fails_gate(self, tmp_path):
        gate = apply_baseline(self._findings(tmp_path), [])
        assert not gate.ok and len(gate.new_findings) == 1

    def test_stale_entry_fails_gate(self, tmp_path):
        ghost = BaselineEntry("dtype-drift", "core/gone.py", "f",
                              "accepted: fixture")
        gate = apply_baseline([], [ghost])
        assert not gate.ok and gate.stale_entries == [ghost]

    def test_update_preserves_justifications(self, tmp_path):
        findings = self._findings(tmp_path)
        entries = [BaselineEntry(f.rule, f.path, f.symbol or f.message,
                                 "accepted: fixture") for f in findings]
        merged = update_baseline(findings, entries)
        assert [e.justification for e in merged] == ["accepted: fixture"]

    def test_roundtrip(self, tmp_path):
        entries = [BaselineEntry("r", "p.py", "s", "because")]
        path = tmp_path / "baseline.json"
        save_baseline(path, entries)
        assert load_baseline(path) == entries
        data = json.loads(path.read_text())
        assert data["version"] == 1

    def test_fingerprint_survives_line_drift(self, tmp_path):
        before = self._findings(tmp_path)
        after = lint(tmp_path, """\
            import numpy as np

            # a comment pushing everything down


            def build(n):
                return np.arange(n)
            """)
        assert before[0].line != after[0].line
        assert before[0].fingerprint == after[0].fingerprint


# ---------------------------------------------------------------------------
# CLI contract: synthetic bugs fail the gate naming rule, file, line
# ---------------------------------------------------------------------------

SYNTHETIC_BUGS = {
    "cache-key-fields": dc("""\
        class Cfg:
            channels: int
            new_knob: int

            def geometry_key(self):
                return (self.channels,)
        """),
    "jit-tracer-branch": """\
        import jax


        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """,
    "jit-tracer-concretize": """\
        import jax


        @jax.jit
        def f(x):
            return float(x)
        """,
    "nondeterministic-order": """\
        def f(items):
            return [x for x in set(items)]
        """,
    "dtype-drift": """\
        import numpy as np
        a = np.zeros(8)
        """,
    "quarantine-import": """\
        from repro.models.config import ModelConfig
        """,
}

TMP_CFG = """\
[analysis]
exclude =
quarantine =
    repro.models
    repro.train
kernels_root = kernels
kernel_tests = tests/test_kernels.py
dtype_scope =
    core
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_cli(root, *paths):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(root),
         *(paths or ("core",))],
        capture_output=True, text=True, env=_env(), cwd=root)


@pytest.mark.parametrize("rule", sorted(SYNTHETIC_BUGS))
def test_cli_fails_on_synthetic_bug(tmp_path, rule):
    (tmp_path / "analysis_torch.cfg").write_text(TMP_CFG)
    mod = tmp_path / "core" / "mod.py"
    mod.parent.mkdir()
    mod.write_text(textwrap.dedent(SYNTHETIC_BUGS[rule]))
    proc = run_cli(tmp_path)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    # the finding must name rule, file, and line: "core/mod.py:N: ..[rule]"
    hit = [ln for ln in proc.stdout.splitlines()
           if f"[{rule}]" in ln and "core/mod.py:" in ln]
    assert hit, proc.stdout
    line_no = int(hit[0].split("core/mod.py:")[1].split(":")[0])
    assert line_no >= 1


def test_cli_kernel_parity_synthetic_bug(tmp_path):
    (tmp_path / "analysis_torch.cfg").write_text(TMP_CFG)
    k = tmp_path / "kernels" / "scan" / "kernel.py"
    k.parent.mkdir(parents=True)
    k.write_text(textwrap.dedent(KERNEL))
    proc = run_cli(tmp_path, "kernels")
    assert proc.returncode == 1
    assert "[kernel-parity]" in proc.stdout
    assert "kernels/scan/kernel.py:" in proc.stdout


def test_cli_clean_tree_exits_zero(tmp_path):
    (tmp_path / "analysis_torch.cfg").write_text(TMP_CFG)
    mod = tmp_path / "core" / "mod.py"
    mod.parent.mkdir()
    mod.write_text("import numpy as np\na = np.zeros(8, dtype=np.float64)\n")
    proc = run_cli(tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_repo_head_passes_the_gate():
    """The committed tree + committed baseline must be green: the port's
    gate, ``python -m repro_torch.analysis`` from the repo root (its
    defaults: ``src/repro_torch``, ``analysis_torch.cfg``,
    ``analysis_torch_baseline.json``)."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"],
        capture_output=True, text=True, env=_env(), cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("-> OK"), proc.stdout


# ---------------------------------------------------------------------------
# what the port adds: torch dtype-drift
# ---------------------------------------------------------------------------

class TestTorchDtypeDrift:
    def test_torch_default_dtype_flagged(self, tmp_path):
        out = lint(tmp_path, """\
            import torch

            def build(n):
                a = torch.arange(n)
                b = torch.zeros(n, 3)
                c = torch.full((n,), 0)
                d = torch.empty(n, n, n, n)
                return a, b, c, d
            """)
        assert rules_of(out) == ["dtype-drift"]
        # torch's dtype is keyword-only: positional sizes never pin it
        assert [f.line for f in out] == [4, 5, 6, 7]
        assert {f.symbol for f in out} == {"build"}

    def test_torch_explicit_or_splatted_dtype_ok(self, tmp_path):
        out = lint(tmp_path, """\
            import torch

            i32 = dict(dtype=torch.int32)

            def build(n, x, device):
                a = torch.arange(n, dtype=torch.int64)
                b = torch.zeros(n, **i32)
                c = torch.full((n,), -1, device=device, **i32)
                d = torch.full((n,), x)
                e = torch.zeros_like(b)
                return a, b, c, d, e
            """)
        assert out == []

    def test_torch_out_of_scope_module_ignored(self, tmp_path):
        out = lint(tmp_path, """\
            import torch
            a = torch.zeros(4)
            """, rel="tools/mod.py")
        assert out == []


# ---------------------------------------------------------------------------
# what the port adds: CUDA sources paired with wrappers and plain versions
# ---------------------------------------------------------------------------

CSRC_CFG = dataclasses.replace(
    CFG, kernel_tests=("tests/test_cuda.py", "smoke.py"),
    csrc_root="csrc")

OPS = """\
    def scan(x, block=128, stream=None):
        return x

    def helper(x):
        return x
"""


def csrc_lint(tmp_path, ops=OPS, ref="def scan_ref(x, block=128):\n"
              "    return x\n", tests="# holds scan_ref\n", smoke="",
              cu=("scan",)):
    extra = {f"csrc/{stem}.cu": "// kernel\n" for stem in cu}
    extra["tests/test_cuda.py"] = tests
    extra["smoke.py"] = smoke
    if ref is not None:
        extra["kernels/scan/ref.py"] = ref
    return lint(tmp_path, ops, rel="kernels/scan/ops.py", cfg=CSRC_CFG,
                extra=extra)


class TestCsrcParity:
    def test_paired_source_passes(self, tmp_path):
        assert csrc_lint(tmp_path) == []

    def test_source_without_wrapper(self, tmp_path):
        out = csrc_lint(tmp_path, cu=("scan", "gather"))
        assert rules_of(out) == ["kernel-parity"]
        (f,) = out
        assert (f.path, f.symbol, f.line) == ("csrc/gather.cu", "gather", 1)
        assert "no public 'gather' wrapper" in f.message

    def test_missing_ref_module(self, tmp_path):
        out = csrc_lint(tmp_path, ref=None)
        assert rules_of(out) == ["kernel-parity"]
        assert out[0].path == "kernels/scan/ops.py"
        assert "no ref.py" in out[0].message

    def test_missing_ref_function(self, tmp_path):
        out = csrc_lint(tmp_path, ref="def other_ref(x):\n    return x\n",
                        tests="# holds other_ref\n")
        assert rules_of(out) == ["kernel-parity"]
        assert out[0].symbol == "scan" and out[0].line == 1

    def test_ref_signature_drift(self, tmp_path):
        out = csrc_lint(tmp_path, ref="def scan_ref(x, src, dst):\n"
                                      "    return x\n")
        assert rules_of(out) == ["kernel-parity"]
        assert "['src', 'dst']" in out[0].message

    def test_uncovered_ref(self, tmp_path):
        out = csrc_lint(tmp_path, tests="# nothing here\n")
        assert rules_of(out) == ["kernel-parity-coverage"]
        (f,) = out
        assert f.symbol == "scan_ref" and f.path == "kernels/scan/ref.py"
        assert "tests/test_cuda.py or smoke.py" in f.message

    def test_coverage_from_any_listed_file(self, tmp_path):
        out = csrc_lint(tmp_path, tests="# nothing here\n",
                        smoke="scan_ref(x)\n")
        assert out == []

    def test_pass_without_the_kernels_root_skips_pairing(self, tmp_path):
        csrc_lint(tmp_path, cu=("scan", "gather"))
        out = run_analysis([tmp_path / "csrc"], tmp_path, CSRC_CFG)
        assert out == []

    def test_no_csrc_root_pairs_nothing(self, tmp_path):
        csrc_lint(tmp_path, cu=("scan", "gather"))
        cfg = dataclasses.replace(CSRC_CFG, csrc_root="")
        assert run_analysis([tmp_path], tmp_path, cfg) == []


def test_cli_csrc_parity_synthetic_bug(tmp_path):
    (tmp_path / "analysis_torch.cfg").write_text(
        TMP_CFG + "csrc_root = csrc\n")
    for rel, src in {"csrc/scan.cu": "// kernel\n",
                     "kernels/scan/ops.py": OPS,
                     "kernels/scan/ref.py": "def scan_ref(x, knob):\n"
                                            "    return x\n",
                     "tests/test_kernels.py": "# scan_ref\n"}.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    proc = run_cli(tmp_path, "kernels")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "kernels/scan/ops.py:1: error[kernel-parity]" in proc.stdout
    assert "'knob'" in proc.stdout


# ---------------------------------------------------------------------------
# the port's config and its own tree
# ---------------------------------------------------------------------------

def test_port_config_and_jax_config_load():
    cfg = load_config(REPO_ROOT)
    assert cfg == AnalysisConfig()
    assert cfg.quarantine == ("repro", "jax", "jaxlib", "repro_torch.models",
                              "repro_torch.configs",
                              "repro_torch.train", "repro_torch.launch.train",
                              "repro_torch.launch.specs",
                              "repro_torch.launch.costmodel",
                              "repro_torch.launch.roofline",
                              "repro_torch.launch.dryrun")
    assert cfg.csrc_root == "src/repro_torch/csrc"
    assert cfg.kernel_tests == ("tests/test_torch_cuda.py", "chip_smoke.py")
    jax_cfg = load_config(REPO_ROOT, "analysis.cfg")
    r_cfg = r_load_config(REPO_ROOT)
    assert jax_cfg.csrc_root == ""
    assert jax_cfg.kernel_tests == (r_cfg.kernel_tests,)
    assert (jax_cfg.exclude, jax_cfg.quarantine, jax_cfg.kernels_root,
            jax_cfg.dtype_scope) == (r_cfg.exclude, r_cfg.quarantine,
                                     r_cfg.kernels_root, r_cfg.dtype_scope)


def test_port_tree_has_no_findings_and_an_empty_baseline():
    """Every finding of the port is repaired in the code: no baseline
    entry stands for one."""
    assert run_analysis([SRC / "repro_torch"], REPO_ROOT) == []
    assert load_baseline(REPO_ROOT / "analysis_torch_baseline.json") == []


def test_quarantine_catches_an_import_of_the_jax_package(tmp_path):
    cfg = dataclasses.replace(CFG, quarantine=("repro", "jax", "jaxlib"))
    out = lint(tmp_path, """\
        import jax.numpy as jnp
        from repro.sim import simulate
        from repro_torch.sim import simulate as t_simulate
        """, cfg=cfg)
    assert rules_of(out) == ["quarantine-import"]
    assert [f.symbol for f in out] == ["jax.numpy", "repro.sim.simulate"]


LM_QUARANTINE = dataclasses.replace(
    CFG, quarantine=("repro", "jax", "jaxlib", "repro_torch.models",
                     "repro_torch.configs.legacy"))


def test_quarantine_keeps_the_lm_stack_out_of_the_live_tree(tmp_path):
    """A live module importing the port's LM stack is a finding; the LM
    stack's own modules import each other freely (a departure from
    ``repro``, whose quarantined tree is excluded, not analysed)."""
    out = lint(tmp_path, """\
        from repro_torch.models import model as M
        import repro_torch.configs.legacy.qwen3_0_6b
        from repro_torch.sim import simulate
        """, rel="repro_torch/sim/mod.py", cfg=LM_QUARANTINE,
        extra={"repro_torch/models/model.py": """\
            from repro_torch.models import layers as L
            from repro_torch.models.config import ModelConfig
            """,
               "repro_torch/configs/legacy/qwen3_0_6b.py":
               "from repro_torch.models.config import ModelConfig\n"})
    assert rules_of(out) == ["quarantine-import"]
    assert [(f.path, f.symbol) for f in out] == [
        ("repro_torch/sim/mod.py", "repro_torch.models.model"),
        ("repro_torch/sim/mod.py", "repro_torch.configs.legacy.qwen3_0_6b")]


TRAIN_QUARANTINE = dataclasses.replace(
    CFG, quarantine=LM_QUARANTINE.quarantine + ("repro_torch.train",
                                                "repro_torch.launch.train"))


def test_quarantine_keeps_lm_training_out_of_the_live_tree(tmp_path):
    """A live module importing ``repro_torch.train`` (or the training
    launcher) is a finding; ``launch/train.py``, quarantined by its own
    name, imports the training and the models freely, as
    ``train/step.py`` does."""
    out = lint(tmp_path, """\
        from repro_torch.train import optimizer as opt
        from repro_torch.launch.train import main
        from repro_torch.launch.mesh import make_sweep_mesh
        """, rel="repro_torch/sim/mod.py", cfg=TRAIN_QUARANTINE,
        extra={"repro_torch/launch/train.py": """\
            from repro_torch.models import model as M
            from repro_torch.train import data as D
            from repro_torch.train.step import make_train_step
            """,
               "repro_torch/train/step.py": """\
            from repro_torch.models import model as M
            from repro_torch.train import optimizer as opt
            """,
               "repro_torch/models/model.py": "import torch\n",
               "repro_torch/launch/mesh.py": "import os\n"})
    assert rules_of(out) == ["quarantine-import"]
    assert [(f.path, f.symbol) for f in out] == [
        ("repro_torch/sim/mod.py", "repro_torch.train.optimizer"),
        ("repro_torch/sim/mod.py", "repro_torch.launch.train.main")]


COST_QUARANTINE = dataclasses.replace(
    CFG, quarantine=TRAIN_QUARANTINE.quarantine + (
        "repro_torch.launch.specs", "repro_torch.launch.costmodel",
        "repro_torch.launch.roofline"))


def test_quarantine_admits_the_cost_tooling_as_repro_lays_it_out(tmp_path):
    """``launch/{specs,costmodel,roofline}`` import the models and each
    other (quarantined by their own names, as ``repro``'s import its LM
    stack); the live tree may import ``core/hbm_adapter`` but not them,
    and the adapter, live, may not import the models."""
    out = lint(tmp_path, """\
        from repro_torch.launch.roofline import analyze_cell
        from repro_torch.core.hbm_adapter import pattern_fractions
        """, rel="repro_torch/sim/mod.py", cfg=COST_QUARANTINE,
        extra={"repro_torch/launch/roofline.py": """\
            from repro_torch.core.hbm_adapter import pattern_fractions
            from repro_torch.launch.costmodel import cell_cost
            from repro_torch.launch.specs import SHAPE_SPECS
            from repro_torch.models.config import ModelConfig
            """,
               "repro_torch/launch/specs.py":
               "from repro_torch.models import model as M\n",
               "repro_torch/launch/costmodel.py":
               "from repro_torch.launch.specs import SHAPE_SPECS\n",
               "repro_torch/core/hbm_adapter.py":
               "from repro_torch.models.config import ModelConfig\n",
               "repro_torch/models/config.py": "import torch\n"})
    assert rules_of(out) == ["quarantine-import"]
    assert [(f.path, f.symbol) for f in out] == [
        ("repro_torch/core/hbm_adapter.py",
         "repro_torch.models.config.ModelConfig"),
        ("repro_torch/sim/mod.py", "repro_torch.launch.roofline.analyze_cell")]


def test_quarantine_by_name_needs_a_dotted_name(tmp_path):
    """A module named as a bare quarantined name (``jax.py``) is not
    quarantined by its name, so it may not import JAX."""
    out = lint(tmp_path, "import jax.numpy as jnp\n",
               rel="repro_torch/sim/jax.py", cfg=TRAIN_QUARANTINE)
    assert [f.symbol for f in out] == ["jax.numpy"]


def test_quarantine_inside_the_lm_stack_still_refuses_jax(tmp_path):
    out = lint(tmp_path, """\
        import jax.numpy as jnp
        from repro.models import layers
        from repro_torch.models import ssm
        """, rel="repro_torch/models/model.py", cfg=LM_QUARANTINE)
    assert [f.symbol for f in out] == ["jax.numpy", "repro.models.layers"]


# ---------------------------------------------------------------------------
# parity with repro.analysis
# ---------------------------------------------------------------------------

def _rows(findings):
    return [(f.rule, f.severity, f.path, f.line, f.message, f.symbol)
            for f in findings]


def _r_cfg(cfg):
    return RAnalysisConfig(exclude=cfg.exclude, quarantine=cfg.quarantine,
                           kernels_root=cfg.kernels_root,
                           kernel_tests=cfg.kernel_tests[0],
                           dtype_scope=cfg.dtype_scope)


PARITY_TREES = {
    **{f"bug-{rule}": {"core/mod.py": src}
       for rule, src in SYNTHETIC_BUGS.items()},
    "kernel-missing-ref": {"kernels/scan/kernel.py": KERNEL,
                           "tests/test_kernels.py": "# exercises scan\n"},
    "kernel-drift": {"kernels/scan/kernel.py": KERNEL,
                     "kernels/scan/ref.py": "def scan_ref(x, knob):\n"
                                            "    return x\n"
                                            "def extra_ref(x):\n"
                                            "    return x\n",
                     "tests/test_kernels.py": "# scan_ref\n"},
    "kernel-uncovered": {"kernels/scan/kernel.py": KERNEL,
                         "kernels/scan/ref.py": "def scan_ref(x):\n"
                                                "    return x\n",
                         "tests/test_kernels.py": "# nothing\n"},
    "noqa-and-syntax": {
        "core/a.py": "import numpy as np\n"
                     "x = np.arange(3)  # repro: noqa[dtype-drift]\n"
                     "y = np.ones(3)  # repro: noqa[kernel-parity]\n",
        "core/b.py": "def broken(:\n"},
    "compare-false-and-supervisor": {
        "core/c.py": dc("""\
            class Cfg:
                channels: int
                name: str = dataclasses.field(default="", compare=False)
                TIMING_ONLY_FIELDS = {"ghost": "gone"}

                def geometry_key(self):
                    return (self.channels,)
            """),
        "serve/s.py": "def run(f):\n"
                      "    try:\n"
                      "        f()\n"
                      "    except BaseException:\n"
                      "        pass\n"
                      "    try:\n"
                      "        f()\n"
                      "    except BaseException as e:\n"
                      "        raise RuntimeError() from e\n",
        "serve/t.py": "def go(sim):\n"
                      "    return sim.simulate(g, 'wcc', accelerator='a',"
                      " memory='m', cache='c')\n"},
}


@pytest.mark.parametrize("tree", sorted(PARITY_TREES))
def test_same_findings_as_repro_analysis(tmp_path, tree):
    for rel, src in PARITY_TREES[tree].items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src), encoding="utf-8")
    got = run_analysis([tmp_path], tmp_path, CFG)
    want = r_run_analysis([tmp_path], tmp_path, _r_cfg(CFG))
    assert want, "each parity tree holds at least one finding"
    assert _rows(got) == _rows(want)


def test_same_findings_and_gate_as_repro_on_the_jax_package():
    """Over ``src/repro`` with ``analysis.cfg`` and
    ``analysis_baseline.json``: the same findings and the same gate."""
    paths = [SRC / "repro"]
    got = run_analysis(paths, REPO_ROOT, load_config(REPO_ROOT,
                                                     "analysis.cfg"))
    want = r_run_analysis(paths, REPO_ROOT, r_load_config(REPO_ROOT))
    assert _rows(got) == _rows(want) and len(got) == 13
    baseline = REPO_ROOT / "analysis_baseline.json"
    gate = apply_baseline(got, load_baseline(baseline))
    r_gate = r_apply_baseline(want, r_load_baseline(baseline))
    assert (gate.ok, gate.baselined, _rows(gate.new_findings),
            [dataclasses.astuple(e) for e in gate.stale_entries],
            [dataclasses.astuple(e) for e in gate.unjustified_entries]) == (
        r_gate.ok, r_gate.baselined, _rows(r_gate.new_findings),
        [dataclasses.astuple(e) for e in r_gate.stale_entries],
        [dataclasses.astuple(e) for e in r_gate.unjustified_entries])
    assert gate.ok and gate.baselined == 13


def test_cli_on_the_jax_package_matches_repro():
    args = ["--config", "analysis.cfg", "--baseline",
            str(REPO_ROOT / "analysis_baseline.json"), "src/repro"]
    got = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          *args], capture_output=True, text=True,
                         env=_env(), cwd=REPO_ROOT)
    want = subprocess.run([sys.executable, "-m", "repro.analysis",
                           "src/repro"], capture_output=True, text=True,
                          env=_env(), cwd=REPO_ROOT)
    assert (got.returncode, got.stdout) == (want.returncode, want.stdout)


# ---------------------------------------------------------------------------
# the static pass stands alone
# ---------------------------------------------------------------------------

_PROBE = r"""
import runpy, sys
sys.argv = ["repro_torch.analysis", "--list-rules"]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__")
except SystemExit:
    pass
sys.argv = ["repro_torch.analysis"]
try:
    runpy.run_module("repro_torch.analysis", run_name="__main__")
except SystemExit as e:
    code = e.code
import repro_torch.analysis.locks
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro",
                                    "numpy"))
print("PROBE", code, bad)
"""


def test_static_pass_imports_no_torch_jax_or_repro():
    proc = subprocess.run([sys.executable, "-c", _PROBE],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO_ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("PROBE")]
    assert line == ["PROBE 0 []"], proc.stdout
