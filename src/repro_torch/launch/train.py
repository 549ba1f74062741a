"""Training launcher: the elastic checkpointed loop on one device (a port
of ``repro.launch.train``).

Runs a config's train steps through ``ElasticTrainer`` on the card (or
on the CPU with ``--device cpu``), resuming from the latest checkpoint in
``--ckpt-dir``.  ``repro`` also builds a device mesh here and shards
the parameters and optimizer state over it; the port has no LM sharding
yet (``ROADMAP.md`` queue 1, item 11), so ``--production-mesh``, or more
than one visible card, raises ``NotImplementedError``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 50 --ckpt-dir build/ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import ElasticTrainer
from repro_torch.models import model as M
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

_MESH = ("a device mesh waits for the LM sharding (ROADMAP.md queue 1, "
         "item 11); run on one device")


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
                    help="the (16,16) mesh: not ported (item 11)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.production_mesh:
        raise NotImplementedError(f"--production-mesh: {_MESH}")
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} visible cards: {_MESH} "
            "(set CUDA_VISIBLE_DEVICES)")
    cfg = get_config(args.arch, smoke=args.smoke)
    print(f"arch={cfg.name} (~{cfg.param_count()/1e6:.0f}M params), "
          f"device {dev}")

    hp = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         total_steps=args.steps)
    dc = D.DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)

    def build_state(_mesh):
        gen = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, gen, device=dev).tree()
        return params, opt.init(params)

    def make_step():
        return make_train_step(cfg, hp, grad_accum=args.grad_accum,
                               device=dev)

    trainer = ElasticTrainer(args.ckpt_dir, build_state, make_step,
                             mesh_builder=lambda: None,
                             save_every=args.save_every)
    _, params, opt_state, start = trainer.resume_or_init()
    if start:
        print(f"resumed at step {start}")

    def batches():
        s = start
        while True:
            yield D.make_batch(cfg, dc, s)
            s += 1

    params, opt_state, losses = trainer.run(
        params, opt_state, batches(), args.steps, start_step=start)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints in {args.ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
