"""DRAM timing: ``ops.dram_serve`` (blocked multi-phase serve) and
``ops.dram_timing`` (per-channel scan of one phase), the kernel wrappers,
with their plain versions ``ref.dram_serve_ref`` and
``ref.dram_timing_ref``."""
