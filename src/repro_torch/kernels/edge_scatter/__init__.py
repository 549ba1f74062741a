"""HitGraph's scatter, one update per edge: ``ops.edge_scatter`` (kernel
wrapper) and ``ref.edge_scatter_ref`` (plain version)."""
