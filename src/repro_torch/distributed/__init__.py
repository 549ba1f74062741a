"""The case-sharded batched serve (:mod:`repro_torch.distributed.sharding`):
a sweep's batch of independent cases split over a 1-D case mesh."""
