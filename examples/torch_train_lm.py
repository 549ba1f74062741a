"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-param
qwen3-family model, a few hundred steps, with checkpointing, elastic
resume and straggler monitoring (``ElasticTrainer``, ``make_train_step``
and AdamW of ``repro_torch``).

The same run as ``examples/train_lm.py`` (the JAX package's), with its
flags; ``--smoke`` trains the qwen3-0.6b smoke config instead.  The
weights are drawn from a ``torch.Generator`` seeded 0.  It runs on the
CUDA device unless ``--device cpu`` asks for the host; with no card and
no ``--device cpu`` it raises.  Run it again with the same
``--ckpt-dir`` to resume from the latest checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
      PYTHONPATH=src python examples/torch_train_lm.py --smoke --steps 4 \\
          --seq-len 16 --batch 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import ElasticTrainer
from repro_torch.models import model as M
from repro_torch.train import data as D
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step

SAVE_EVERY = 50


def config(smoke: bool = False):
    """~100M params: the qwen3 family at reduced depth and width, or with
    ``smoke`` the qwen3-0.6b smoke config."""
    if smoke:
        return get_config("qwen3_0_6b", smoke=True)
    return dataclasses.replace(
        get_config("qwen3_0_6b"),
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1536, vocab=32768, name="qwen3-100m")


def train(cfg, steps: int, ckpt_dir: str, seq_len: int, batch: int,
          grad_accum: int = 1, device=None,
          init: Optional[Callable[[], dict]] = None,
          out=print) -> List[float]:
    """Train ``cfg`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint) and return the losses of the steps run.  ``init``
    gives the initial parameter tree (default: ``init_params`` from a
    generator seeded 0)."""
    dev = resolve_device(device)
    out(f"model: {cfg.name}, ~{cfg.param_count()/1e6:.0f}M params")
    hp = opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    dc = D.DataConfig(seq_len=seq_len, global_batch=batch)

    def build_state(_mesh):
        if init is not None:
            params = init()
        else:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = M.init_params(cfg, gen, device=dev).tree()
        return params, opt.init(params)

    trainer = ElasticTrainer(
        ckpt_dir,
        build_state=build_state,
        make_step=lambda: make_train_step(cfg, hp, grad_accum=grad_accum,
                                          device=dev),
        mesh_builder=lambda: None,
        save_every=SAVE_EVERY,
    )
    _, params, opt_state, start = trainer.resume_or_init()
    if start:
        out(f"resumed from step {start}")

    def batches():
        step = start
        while True:
            yield D.make_batch(cfg, dc, step)
            step += 1

    params, opt_state, losses = trainer.run(
        params, opt_state, batches(), steps, start_step=start, log=out)
    out(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"({len(trainer.monitor.events)} straggler events)")
    return losses


def main(argv: Optional[List[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="the qwen3-0.6b smoke config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return train(config(args.smoke), args.steps, args.ckpt_dir,
                 args.seq_len, args.batch, args.grad_accum, dev)


if __name__ == "__main__":
    main()
