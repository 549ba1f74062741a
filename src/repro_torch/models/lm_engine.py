"""Batched LM serving (prefill + greedy decode), a port of
``repro.models.lm_engine``.

Copies ``repro``'s quirks for parity: prompts are left-padded with id 0
and attended without a mask (the pads sit at positions 0..), one scalar
position serves the whole batch, ``eos_id`` is ignored and every request
runs ``max(max_new_tokens)`` steps (``ROADMAP.md`` §3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                   # int32[S]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None


def _pad_prompts(prompts: List[np.ndarray], pad_id: int = 0):
    S = max(len(p) for p in prompts)
    out = np.full((len(prompts), S), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = p          # left-pad (aligned last token)
    return out


@torch.inference_mode()
def generate(params, cfg: ModelConfig, requests: List[Request],
             extra: Optional[Dict] = None, device=None) -> np.ndarray:
    """Greedy generation for a batch of requests; returns (B, max_new).
    The parameters are cast to the compute dtype once for the call."""
    dev = resolve_device(device)
    prompts = torch.from_numpy(_pad_prompts([r.prompt for r in requests]))
    steps = max(r.max_new_tokens for r in requests)
    params = M.compute_params(params, cfg)
    logits, cache = M.prefill(params, prompts, cfg, extra=extra, device=dev)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = M.decode_step(params, cache, tok[:, None], cfg,
                                      device=dev)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1).cpu().numpy()
