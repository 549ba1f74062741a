"""Training launcher: mesh + sharding + the elastic checkpointed loop (a
port of ``repro.launch.train``).

Runs a config's train steps through ``ElasticTrainer`` on the card (or
on the CPU with ``--device cpu``), resuming from the latest checkpoint in
``--ckpt-dir``.  A process drives one device, so the port's counterpart
of ``repro``'s "more than one device" is a process group of ranks; the
mesh path is taken

* with ``--production-mesh``: the ``(16, 16)`` mesh, which needs a world
  of 256 ranks (``ValueError`` naming the world size otherwise, as
  ``jax.make_mesh`` refuses);
* when a default process group is initialized as ``main`` starts (a
  one-rank group gives a ``(1, 1)`` mesh);
* when torchrun's environment names a world (``WORLD_SIZE``, ``RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``): ``main`` initializes the group,
  NCCL on the card (one card a rank, ``LOCAL_RANK``), gloo with
  ``--device cpu``, and destroys it at the end.

On the mesh (``make_host_mesh``: ``(world // 2, 2)``) the parameters and
the optimizer state are ``DTensor``s placed by ``tree_shardings``, the
batches by ``batch_shardings``, and the step runs under ``make_ctx``;
checkpoints hold full arrays, so a run resumes on any world size.
Otherwise it runs on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --ckpt-dir build/ckpt [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --smoke --steps 4 --device cpu --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import ElasticTrainer
from repro_torch.launch.mesh import (DEVICE_BACKEND, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

#: torchrun's environment: a world to join
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def _join_torchrun(device) -> bool:
    """Initialize the default group from torchrun's environment where it
    names a world and no group exists; whether one was initialized."""
    if dist.is_initialized() or not all(k in os.environ
                                        for k in TORCHRUN_ENV):
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(DEVICE_BACKEND[dev.type], init_method="env://")
    return True


def _full(x):
    """A ``DTensor`` loss as the plain value every rank holds."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, return the
    losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the (16,16) mesh (needs 256 ranks)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)

    joined = _join_torchrun(args.device)
    try:
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args) -> List[float]:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.production_mesh:
        mesh = make_production_mesh(device=dev)
    elif dist.is_initialized():
        mesh = make_host_mesh(device=dev)
    else:
        mesh = None
    where = (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
             if mesh is not None else f"device {dev}")
    print(f"arch={cfg.name} (~{cfg.param_count()/1e6:.0f}M params), "
          f"{where}")

    hp = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         total_steps=args.steps)
    dc = D.DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)
    ctx = shd.make_ctx(cfg, mesh, False) if mesh is not None else None

    def build_state(_mesh):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, gen, device=dev).tree()
        opt_state = opt.init(params)
        if mesh is not None:
            params = shd.distribute_tree(
                params, shd.tree_shardings(params, mesh, False))
            opt_state = shd.distribute_tree(
                opt_state, shd.tree_shardings(opt_state, mesh, False))
        return params, opt_state

    def make_step():
        step = make_train_step(cfg, hp, grad_accum=args.grad_accum,
                               device=dev)

        def wrapped(params, opt_state, batch):
            if ctx is None:
                return step(params, opt_state, batch)
            with dctx.use(ctx):
                loss, params, opt_state = step(params, opt_state, batch)
            return _full(loss), params, opt_state

        return wrapped

    trainer = ElasticTrainer(args.ckpt_dir, build_state, make_step,
                             mesh_builder=lambda: mesh,
                             save_every=args.save_every)
    _, params, opt_state, start = trainer.resume_or_init()
    if start:
        print(f"resumed at step {start} (elastic restore)")

    def batches():
        s = start
        while True:
            batch = D.make_batch(cfg, dc, s)
            if mesh is not None:
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                batch = shd.distribute_tree(batch, shd.batch_shardings(
                    batch, mesh, False))
            yield batch
            s += 1

    params, opt_state, losses = trainer.run(
        params, opt_state, batches(), args.steps, start_step=start)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
