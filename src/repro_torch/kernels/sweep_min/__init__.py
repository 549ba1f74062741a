"""Asynchronous min-relaxation sweep: ``ops.sweep_min`` (kernel wrapper)
and ``ops.sweep_min_ref`` (plain version)."""
