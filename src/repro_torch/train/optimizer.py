"""AdamW with decoupled weight decay over the parameter tree (a port of
``repro.train.optimizer``).

Plain torch functions over ``repro``'s state ``{"m", "v", "step"}`` (``m``
and ``v`` trees shaped as the parameters, ``step`` a 0-d int32 tensor on
their device), not ``torch.optim.AdamW``, which decays ``p * (1 - lr *
wd)`` before the step and keeps its schedule as Python float64.  The
arithmetic is ``repro``'s in float32: a Python number enters as JAX
applies one to a float32 array, rounded to float32 first; the schedule
and the bias corrections are float32 tensors on the parameters' device;
every division divides by a tensor there (torch multiplies by the
reciprocal where a CUDA tensor is divided by a Python number).

:func:`update` writes the new parameters, moments and step into the
tensors it was given, under ``torch.no_grad()``: the torch form of
``repro``'s buffer donation, which spares a second copy of the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _tree(params):
    return params.tree() if hasattr(params, "tree") else params


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def init(params) -> Dict[str, Any]:
    """Zero moments shaped and typed as the parameters, step 0."""
    tree = _tree(params)
    zeros = lambda t: map_tree(lambda p: torch.zeros_like(p.detach()), t)
    dev = leaves(tree)[0].device
    return {"m": zeros(tree), "v": zeros(tree),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(step: torch.Tensor, hp: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to a tenth of ``hp.lr``, for the
    int32 ``step``: a float32 0-d tensor."""
    warm = torch.clamp(step.float() / _f32(max(hp.warmup_steps, 1), step),
                       max=1.0)
    frac = torch.clamp(
        (step - hp.warmup_steps).float()
        / _f32(max(hp.total_steps - hp.warmup_steps, 1), step), 0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * frac))
    return hp.lr * warm * (0.1 + 0.9 * cosine)


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def update(grads, state, params, hp: AdamWConfig) -> Tuple[Any, Dict]:
    """One AdamW step: clip ``grads`` to ``hp.grad_clip`` by their global
    norm, update the moments, step the parameters.  ``params`` and
    ``state`` are updated in place and returned."""
    flat_p = leaves(_tree(params))
    flat_g, flat_m, flat_v = (leaves(grads), leaves(state["m"]),
                              leaves(state["v"]))
    assert len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v), (
        len(flat_p), len(flat_g), len(flat_m), len(flat_v))
    with torch.no_grad():
        step = state["step"].add_(1)
        gnorm = global_norm(flat_g)
        scale = torch.clamp(_f32(hp.grad_clip, gnorm) / (gnorm + 1e-9),
                            max=1.0)
        lr = _schedule(step, hp)
        s = step.float()
        bc1 = 1 - torch.pow(_f32(hp.b1, s), s)
        bc2 = 1 - torch.pow(_f32(hp.b2, s), s)
        for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
            g = g.float() * scale
            m.mul_(hp.b1).add_((1 - hp.b1) * g)
            v.mul_(hp.b2).add_((1 - hp.b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + hp.eps)
            p32 = p.float()
            p.copy_(p32 - lr * (delta + hp.weight_decay * p32))
    return params, state
