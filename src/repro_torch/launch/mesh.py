"""The sweep's case mesh.

A mesh here is a plain list of ``torch.device`` values, one per shard of a
case batch: the shards share nothing while they serve (each is an
independent batched serve), so no process group or collective is needed.
A function, not a module-level constant, so that importing this module
never touches device state.
"""

from __future__ import annotations

import os
from typing import List

import torch

#: the host's device count on the CPU, where a test mocks a larger host
#: (the counterpart of JAX's ``--xla_force_host_platform_device_count``);
#: read each time a mesh is built, unset means 1
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


def visible_devices(device) -> int:
    """How many devices of ``device``'s type a mesh may use: the card
    count for CUDA (never mocked), else ``REPRO_TORCH_HOST_DEVICES`` (1
    when unset)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    raw = os.environ.get(HOST_DEVICES_ENV, "1")
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{HOST_DEVICES_ENV} must be an integer >= 1, "
                         f"got {raw!r}")
    return n


def make_sweep_mesh(devices: int, device) -> List[torch.device]:
    """The 1-D case mesh over the first ``devices`` visible devices of
    ``device``'s type: ``cuda:0 .. cuda:devices-1`` on the card, the CPU
    ``devices`` times on the host (each entry serves one shard with the
    plain version).  Raises ``ValueError`` naming ``devices`` when it
    exceeds what is visible; the mesh never shrinks silently."""
    dev = torch.device(device)
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    avail = visible_devices(dev)
    if devices > avail:
        how = ("the card count is torch.cuda.device_count()"
               if dev.type == "cuda" else
               f"set {HOST_DEVICES_ENV}=N to mock a larger CPU mesh")
        raise ValueError(f"devices={devices} exceeds the {avail} visible "
                         f"{dev.type} device(s); {how}")
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(devices)]
    return [dev] * devices
