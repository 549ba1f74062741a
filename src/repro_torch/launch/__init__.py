"""Device meshes: :mod:`repro_torch.launch.mesh` builds the 1-D case mesh
that a sweep shards its batched serves over (``Sweeper(devices=N)``)."""
