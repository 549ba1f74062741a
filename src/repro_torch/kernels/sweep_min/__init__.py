"""Asynchronous min-relaxation sweep: ``ops.sweep_min`` /
``ops.sweep_min_rounds`` (kernel wrappers) and ``ref.sweep_min_ref`` /
``ref.sweep_min_rounds_ref`` (plain versions)."""
