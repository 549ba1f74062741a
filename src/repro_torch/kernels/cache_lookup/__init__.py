"""LRU cache lookup of a set-sorted read stream: ``ops.cache_lookup``
(kernel wrapper) and ``ref.cache_lookup_ref`` (plain version)."""
