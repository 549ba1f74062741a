"""Assigned-architecture registry: ``get_config(arch, smoke=False)``.

The architecture modules live under ``legacy/`` — they belong to the
LM side (``repro_torch.models``), not to the graph accelerator simulation
API (``repro_torch.sim``), and are quarantined so the public surface only
advertises graph-simulation entry points.  This registry names them by
string and re-exports ``ModelConfig``, as ``repro.configs`` does; it is
quarantined with them (``analysis_torch.cfg``): only the LM stack's own
modules import it.

Each module exports ``CONFIG`` (the exact published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), each a
``repro_torch.models.config.ModelConfig``.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCHS: List[str] = [
    "command_r_35b",
    "qwen3_0_6b",
    "gemma_2b",
    "qwen3_1_7b",
    "arctic_480b",
    "llama4_scout_17b_a16e",
    "hymba_1_5b",
    "phi_3_vision_4_2b",
    "whisper_tiny",
    "xlstm_1_3b",
]

# CLI aliases (--arch command-r-35b etc.)
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(arch: str, smoke: bool = False):
    """The ``ModelConfig`` of ``arch`` (``-`` and ``.`` read as ``_``):
    its ``SMOKE`` reduction when ``smoke``, else its published ``CONFIG``."""
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.legacy.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
