"""Segment reduce (sum / min / max by segment id): ``ops.segment_reduce``
(kernel wrapper) and ``ref.segment_reduce_ref`` (plain version)."""
