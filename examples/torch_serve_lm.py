"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode with
the KV cache, through ``repro_torch.models.lm_engine``.

The same batch as ``examples/serve_lm.py`` (the JAX package's): the
qwen3-0.6b smoke config, three prompts of 12, 7 and 3 tokens drawn from
NumPy's generator seeded 0, 16 new tokens each.  The weights are drawn
from a ``torch.Generator`` seeded 0.  It runs on the CUDA device unless
``--device cpu`` asks for the host; with no card and no ``--device cpu``
it raises.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.lm_engine import Request, generate

PROMPT_LENGTHS = (12, 7, 3)
MAX_NEW_TOKENS = 16


def requests_for(cfg) -> List[Request]:
    """The example's requests: NumPy's generator seeded 0 draws each
    prompt's tokens below the vocabulary size."""
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=MAX_NEW_TOKENS)
            for n in PROMPT_LENGTHS]


def serve(params, cfg, device=None, out=print) -> np.ndarray:
    """Generate for :func:`requests_for`'s batch with ``params``; prints a
    line a request and returns the ``(3, 16)`` new tokens."""
    requests = requests_for(cfg)
    tokens = generate(params, cfg, requests, device=device)
    for i, row in enumerate(tokens):
        out(f"request {i}: prompt_len={len(requests[i].prompt)} "
            f"-> {row.tolist()}")
    return tokens


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("qwen3_0_6b", smoke=True)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return serve(params, cfg, dev)


if __name__ == "__main__":
    main()
