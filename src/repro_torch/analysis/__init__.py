"""``repro_torch.analysis`` — the repo-aware static-analysis + race-
instrumentation suite of the port.

Static half (stdlib-only, safe to run anywhere; imports no ``torch``)::

    python -m repro_torch.analysis              # src/repro_torch, the gate

AST lint rules specific to this codebase's invariants: cache-key
completeness (``cache-key-fields``), JAX tracer/recompile hazards
(``jit-tracer-branch``, ``jit-tracer-concretize``,
``jit-fstring-traced``, ``jit-static-hazard``; the port has no jit, so
they guard against one coming in), unordered-set iteration
(``nondeterministic-order``), kernel/plain-version pairing
(``kernel-parity``, ``kernel-parity-coverage``: each CUDA source under
``csrc_root`` with its wrapper in ``kernels/*/ops.py`` and its plain
version in the sibling ``ref.py``), platform-default dtypes
(``dtype-drift``, NumPy and torch constructors), broad exception traps
(``bare-base-exception``), loose scenario keywords
(``scenario-kwargs``) and quarantined-module imports
(``quarantine-import``: the port must not import ``repro`` or JAX).
Suppressions: ``# repro: noqa[rule-name]``; accepted findings live in
the committed ``analysis_torch_baseline.json`` with per-entry
justifications and a drift gate (see
:mod:`repro_torch.analysis.baseline`).

Dynamic half: :mod:`repro_torch.analysis.locks` instruments the
``SimSession`` / ``Sweeper`` / ``SimService`` / corpus locks and their
guarded dicts when ``REPRO_ANALYSIS_LOCKS=1``, recording
lock-acquisition order, lock-order inversions, and unguarded
shared-state access — ``tests/test_torch_concurrency_stress.py`` runs
under it.
"""

from repro_torch.analysis.baseline import (BaselineEntry, apply_baseline,
                                           load_baseline, save_baseline,
                                           update_baseline)
from repro_torch.analysis.framework import (Finding, Rule, RULES,
                                            load_config, run_analysis)

__all__ = [
    "BaselineEntry", "Finding", "RULES", "Rule", "apply_baseline",
    "load_baseline", "load_config", "run_analysis", "save_baseline",
    "update_baseline",
]
