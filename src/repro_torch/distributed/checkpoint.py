"""Checkpointing with atomic commit, retention, and elastic restore (a
port of ``repro.distributed.checkpoint``).

* ``save``: flattens the (params, opt_state) tree to an .npz, written to a
  temp file and atomically renamed — a preempted save never corrupts the
  latest checkpoint.  ``DTensor`` leaves are gathered in full on every
  rank (``full_tensor``, a collective); rank 0 alone writes, and the
  other ranks wait at a barrier until the file is in place.
* ``CheckpointManager``: step-tagged files, retention of the last k.
* ``restore``: rebuilds the tree; with ``shardings`` it places every leaf
  on a ``torch.device`` or, for a :class:`~repro_torch.distributed.
  context.NamedSharding`, as a ``DTensor`` on its mesh: every rank loads
  the file and keeps its own shard.  Restoring an N-rank checkpoint onto
  an N'-rank mesh (elastic rescale) is just that placement, because the
  on-disk format is mesh-agnostic (full arrays).

The file format is ``repro``'s, so a checkpoint written by either package
restores into the other: the keys are the tree's paths joined by ``/``
(dict keys sorted, list and tuple indices), and an LM's per-layer lists
(``blocks``, ``enc_blocks``, ``s_blocks``, ``m_blocks``; see
:mod:`repro_torch.tree`) are written stacked on ``repro``'s leading axes
and unstacked on restore.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.context import NamedSharding
from repro_torch.tree import STACKED, leaves, map_tree, stack


def _numpy(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sharded(tree) -> bool:
    """Whether ``tree`` holds a ``DTensor`` (its save is a collective)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in leaves(tree))


def _writes(sharded: bool) -> bool:
    """Whether this process writes a checkpoint: always, unless the tree is
    sharded over a group and this is not its rank 0."""
    return not sharded or torch.distributed.get_rank() == 0


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            v = tree[k]
            if k in STACKED and isinstance(v, list):
                v = stack(v, STACKED[k], _numpy)
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _numpy(tree)
    return out


def _unflatten_into(like, flat, prefix="", index=()):
    """``like``'s structure filled from ``flat``; ``index`` selects a
    layer of the stacked arrays under a per-layer list."""
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            if k in STACKED and isinstance(v, list):
                out[k] = _unstack_into(v, flat, f"{prefix}{k}/", index,
                                       STACKED[k])
            else:
                out[k] = _unflatten_into(v, flat, f"{prefix}{k}/", index)
        return out
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_into(v, flat, f"{prefix}{i}/", index)
                          for i, v in enumerate(like))
    a = flat[prefix[:-1]]
    return a[index] if index else a


def _unstack_into(items, flat, prefix, index, axes):
    return [(_unflatten_into(v, flat, prefix, index + (i,)) if axes == 1
             else _unstack_into(v, flat, prefix, index + (i,), axes - 1))
            for i, v in enumerate(items)]


def save(path: str, tree: Any, step: int) -> str:
    """Atomic save; returns the final path.  A tree of ``DTensor``s is
    saved by every rank of its group together."""
    sharded = _sharded(tree)
    flat = _flatten(tree)
    if _writes(sharded):
        flat["__step__"] = np.asarray(step)
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if sharded:
        torch.distributed.barrier()
    return path


def _place(a: np.ndarray, where):
    if where is None:
        return a
    a = a if a.flags.c_contiguous else np.array(a)
    if isinstance(where, (str, torch.device)):
        return torch.from_numpy(a).to(torch.device(where))
    if isinstance(where, NamedSharding):
        from torch.distributed.tensor import distribute_tensor
        full = torch.from_numpy(a).to(where.mesh.device_type)
        # every rank holds the whole array: each keeps its shard, nothing
        # is sent
        return distribute_tensor(full, where.mesh,
                                 where.placements(full.ndim),
                                 src_data_rank=None)
    raise TypeError(f"restore places leaves on a torch.device or a "
                    f"NamedSharding, not a {type(where).__name__}")


def restore(path: str, like: Any,
            shardings: Optional[Any] = None) -> Tuple[Any, int]:
    """Load a checkpoint into ``like``'s structure: NumPy leaves, or with
    ``shardings`` (a ``torch.device``, or a tree shaped as ``like`` of
    ``torch.device``s and ``NamedSharding``s) tensors on those devices and
    ``DTensor``s laid out by those shardings (elastic restore onto a
    different mesh)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    step = int(flat.pop("__step__"))
    tree = _unflatten_into(like, flat)
    if shardings is not None:
        if isinstance(shardings, (str, torch.device)):
            tree = map_tree(lambda a: _place(a, shardings), tree)
        else:
            tree = map_tree(_place, tree, shardings)
    return tree, step


class CheckpointManager:
    """Step-tagged checkpoints with retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, tree: Any, step: int) -> str:
        p = save(self._path(step), tree, step)
        if _writes(_sharded(tree)):
            self._gc()
        return p

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        pat = re.compile(r"ckpt_(\d+)\.npz$")
        steps = []
        for f in os.listdir(self.dir):
            m = pat.match(f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def restore_latest(self, like: Any, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(self._path(step), like, shardings)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            os.unlink(self._path(s))
