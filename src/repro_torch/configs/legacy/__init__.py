"""Quarantined LLM architecture configs (NOT part of the public API).

These model-architecture stubs belong to the host framework's LM
training/serving side (exercised by the dry-run and roofline tooling),
not to the graph-accelerator simulation this repository reproduces.
They are kept under ``legacy/`` so the advertised API surface is the
graph-simulation entry point (``repro_torch.sim``); reach them only through
``repro_torch.configs.get_config``.
"""
