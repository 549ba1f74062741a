"""Blocked DRAM serve: ``ops.dram_serve`` (kernel wrapper) and
``ref.dram_serve_ref`` (plain version)."""
