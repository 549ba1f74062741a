"""Mesh construction: the LM meshes and the sweep's case mesh.

The LM meshes are ``DeviceMesh``es over the default process group, with
``repro``'s axis names: the production mesh, single-pod ``(data=16,
model=16)`` = 256 ranks, multi-pod ``(pod=2, data=16, model=16)`` = 512
(the ``pod`` axis composes with ``data`` for hierarchical gradient
reduction), and the host mesh ``(n // model, model)`` over whatever ranks
exist.  One rank a device: NCCL on the card, gloo on the CPU.

The case mesh is a plain list of ``torch.device`` values, one per shard of
a case batch: the shards share nothing while they serve (each is an
independent batched serve), so no process group or collective is needed.

Functions, not module-level constants, so that importing this module
never touches device or process-group state.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: the process-group backend of each device type
DEVICE_BACKEND = {"cuda": "nccl", "cpu": "gloo"}

#: torch's in-process backend whose collectives communicate nothing: the
#: dry run's world of 256 (512) ranks in one process, on either device
FAKE_BACKEND = "fake"

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


def _world(device) -> Tuple[str, int]:
    """The device type and the default group's size, checked against each
    other (a fake group goes with either); with no group, a one-rank
    group of ``device``'s backend is initialized (over an in-process
    store: one rank needs no rendezvous).  The caller owns it
    (``dist.destroy_process_group``)."""
    dev = resolve_device(device)
    want = DEVICE_BACKEND[dev.type]
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = str(dist.get_backend())
    if backend not in (want, FAKE_BACKEND):
        raise ValueError(f"a {dev.type} mesh runs over {want}, the default "
                         f"group is {backend}")
    return dev.type, dist.get_world_size()


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the default group: ``(data=16,
    model=16)``, or ``(pod=2, data=16, model=16)`` with ``multi_pod``.
    Raises ``ValueError`` naming the world size when the group has not
    exactly 256 (512) ranks, as ``jax.make_mesh`` refuses a device count
    that does not match."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = (dist.get_world_size() if dist.is_initialized() else 1)
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {need} ranks, the world has {have}")
    kind, _ = _world(device)
    return _device_mesh(kind, shape, axes)


def make_host_mesh(model: int = 2, device=None):
    """A small ``(data, model)`` mesh over every rank of the default group
    (one rank a device; tests and examples): ``model`` clipped to the
    world size, ``data`` the rest."""
    kind, n = _world(device)
    model = min(model, n)
    if n % model:
        raise ValueError(f"model={model} does not divide the world of {n}")
    return _device_mesh(kind, (n // model, model), ("data", "model"))
