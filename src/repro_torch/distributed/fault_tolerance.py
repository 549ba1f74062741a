"""Fault-tolerance runbook utilities: checkpoint/restart + straggler
policy (a port of ``repro.distributed.fault_tolerance``).

The failure model: (a) node loss -> restart from the latest checkpoint on
a smaller or different mesh,
(b) stragglers -> deterministic data sharding lets any worker be replaced
without data skew, (c) preemption mid-save -> atomic checkpoint commit
(see ``checkpoint.py``).

``ElasticTrainer`` packages the loop: it owns the CheckpointManager,
restores onto the layout of the fresh state built for the currently
available ranks, and resumes the data pipeline purely from the step
counter (``train/data.py`` is a pure function of (seed, step, shard)).

:class:`StragglerMonitor` / :class:`StragglerEvent` live in
:mod:`repro_torch.serve.chaos` and are re-exported here, as ``repro``
does.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.context import NamedSharding, spec_of
from repro_torch.serve.chaos import StragglerEvent, StragglerMonitor
from repro_torch.tree import map_tree

__all__ = ["StragglerEvent", "StragglerMonitor", "ElasticTrainer"]


def _layouts(tree):
    """Where every leaf lives: a ``DTensor``'s mesh and placements (as a
    ``NamedSharding``), a tensor's device, ``None`` for other leaves."""
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return NamedSharding(a.device_mesh, spec_of(
                a.placements, a.device_mesh, a.ndim))
        return a.device if isinstance(a, torch.Tensor) else None
    return map_tree(one, tree)


class ElasticTrainer:
    """Checkpoint/restart + elastic-mesh resume driver.

    ``build_state(mesh)`` -> (params, opt_state) for a fresh start;
    ``make_step()`` -> the step function.  On resume the manager loads the
    latest checkpoint onto ``shardings`` (by default the fresh state's own
    layout: each ``DTensor`` leaf's mesh and placements, each tensor's
    device) — N -> N' rescale is transparent because checkpoints store
    full (unsharded) arrays and the data pipeline is step-addressed.
    """

    def __init__(self, ckpt_dir: str, build_state, make_step,
                 mesh_builder, save_every: int = 50, keep: int = 3):
        self.manager = ckpt.CheckpointManager(ckpt_dir, keep=keep)
        self.build_state = build_state
        self.make_step = make_step
        self.mesh_builder = mesh_builder
        self.save_every = save_every
        self.monitor = StragglerMonitor()

    def resume_or_init(self, shardings=None):
        mesh = self.mesh_builder()
        params, opt_state = self.build_state(mesh)
        like = (params, opt_state)
        restored, step = self.manager.restore_latest(
            like, _layouts(like) if shardings is None else shardings)
        if restored is not None:
            params, opt_state = restored
            start = step
        else:
            start = 0
        return mesh, params, opt_state, start

    def run(self, params, opt_state, batches, n_steps: int,
            start_step: int = 0, log_every: int = 10,
            log: Callable[[str], None] = print):
        """``n_steps`` steps from ``start_step``.  A step's time ends when
        its loss reaches the host (``float(loss)`` waits for the card); a
        step that raises ends the run."""
        step_fn = self.make_step()
        losses = []
        for step in range(start_step, start_step + n_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            loss, params, opt_state = step_fn(params, opt_state, batch)
            loss = float(loss)
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            losses.append(loss)
            if step % log_every == 0:
                log(f"step {step}: loss={loss:.4f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.save_every == 0:
                self.manager.save((params, opt_state), step + 1)
        return params, opt_state, losses
