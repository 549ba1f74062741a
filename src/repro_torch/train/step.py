"""Training step: the LM cross entropy, gradient accumulation and
``make_train_step`` (a port of ``repro.train.step``).

``repro`` takes the gold logit as ``sum(one_hot(labels) * logits)`` so
that a vocab-sharded logits array never gathers; the port gathers it,
which gives the same value exactly (the other terms are zeros) without
the (B, S, V) float32 one-hot.  Under a mesh (``DTensor`` logits) each
rank takes the log-sum-exp terms and the gold logit of its own vocabulary
shard, reduced over ``model`` (:func:`_vocab_parallel`), so the logits
are never gathered, as GSPMD partitions ``repro``'s ``logsumexp`` and
one-hot sum.  A label outside ``[0, vocab)`` gives a gold logit of 0, as
``one_hot`` does; a negative one is masked out of the mean.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed.context import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, map_tree

#: the batch entries that are model inputs besides the tokens
EXTRA = ("patches", "frames")


def _on(batch: Dict, dev) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def lm_loss(params, batch: Dict, cfg: ModelConfig,
            device=None) -> torch.Tensor:
    """The mean next-token cross entropy over the labels >= 0 (a 0-d
    float32 tensor)."""
    logits, _ = M.forward(params, batch["tokens"], cfg,
                          extra={k: v for k, v in batch.items()
                                 if k in EXTRA}, device=device)
    logits = logits.float()
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    inside = (labels >= 0) & (labels < cfg.vocab)
    if isinstance(logits, DTensor):
        lse, picked = _vocab_parallel(logits, labels, cfg.vocab)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        idx = torch.where(inside, labels, 0).long()
        picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    gold = torch.where(inside, picked, 0.0)
    mask = (labels >= 0).float()
    return (torch.sum((lse - gold) * mask)
            / torch.clamp(mask.sum(), min=1.0))


def _vocab_parallel(logits, labels, vocab: int):
    """``(logsumexp(logits), gold logit)`` under a mesh context (Megatron's
    cross entropy), as a ``shard_map``: each rank takes its shard of the
    vocabulary (``model``, where it divides the vocabulary), the maximum
    and the sum of exponentials are reduced over the axis, and the gold
    logit is the one rank's that holds the label, 0 elsewhere, summed.
    Where no axis cuts the vocabulary each rank takes the unsharded ops
    on its rows, so a one-rank mesh computes what one device does."""
    ctx = dctx.current()
    sizes = dctx.axis_sizes(ctx.mesh)
    ax = ("model" if sizes.get("model", 1) > 1
          and logits.shape[-1] % sizes["model"] == 0 else None)
    batch = L._batch_axes(ctx, logits.shape[0])

    def local(lg, lab):
        lo = dctx.axis_index(ax) * lg.shape[-1] if ax else 0
        if ax is None:          # the whole vocabulary: the unsharded ops
            lse = torch.logsumexp(lg, dim=-1)
        else:
            m = dctx.pmax(lg.detach().amax(dim=-1, keepdim=True), ax)
            e = dctx.psum(torch.exp(lg - m).sum(dim=-1), ax)
            lse = torch.log(e) + m[..., 0]
        j = lab.long() - lo
        mine = (lab >= 0) & (lab < vocab) & (j >= 0) & (j < lg.shape[-1])
        picked = torch.where(mine, torch.gather(
            lg, -1, torch.where(mine, j, 0)[..., None])[..., 0], 0.0)
        return lse, (dctx.psum(picked, ax) if ax else picked)

    return dctx.shard_map(local, mesh=ctx.mesh,
                          in_specs=(P(batch, None, ax), P(batch, None)),
                          out_specs=(P(batch, None), P(batch, None)))(
        logits, labels)


def loss_and_grads(params, batch: Dict, cfg: ModelConfig,
                   device=None) -> Tuple[torch.Tensor, Dict]:
    """``jax.value_and_grad(lm_loss)``: the loss and a tree of gradients
    shaped as the parameters (zeros where a parameter gets none).  Sets
    the parameters to require grad (``model.trainable``)."""
    tree = M.trainable(M._tree(params))
    flat = leaves(tree)
    loss = lm_loss(tree, batch, cfg, device=device)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    of = {id(p): torch.zeros_like(p) if g is None else g
          for p, g in zip(flat, grads)}
    return loss.detach(), map_tree(lambda p: of[id(p)], tree)


def _split(batch: Dict, n: int) -> List[Dict]:
    """``batch`` cut on dim 0 into ``n`` microbatches, in order."""
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {n} microbatches")
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, hp: opt.AdamWConfig,
                    grad_accum: int = 1, jit: bool = True, device=None):
    """Returns step(params, opt_state, batch) -> (loss, params, opt_state).

    ``grad_accum`` > 1 splits the batch on dim 0 into microbatches and
    sums their float32 gradients and losses before dividing by
    ``grad_accum`` (``repro``'s ``lax.scan``), bounding activation memory
    at 1/grad_accum of the global batch.  The step updates ``params`` and
    ``opt_state`` in place (:func:`optimizer.update`) and returns them.
    ``jit`` is ``repro``'s compile switch and does nothing here.
    """
    dev = resolve_device(device)

    def step(params, opt_state, batch):
        batch = _on(batch, dev)
        if grad_accum > 1:
            loss, grads = None, None
            for mb in _split(batch, grad_accum):
                l, g = loss_and_grads(params, mb, cfg, device=dev)
                if grads is None:
                    loss, grads = l, map_tree(lambda x: x.float(), g)
                else:
                    loss = loss + l
                    for a, b in zip(leaves(grads), leaves(g)):
                        a.add_(b)
                del g
            n = opt._f32(grad_accum, loss)
            loss = loss / n
            for a in leaves(grads):
                a.div_(n)
        else:
            loss, grads = loss_and_grads(params, batch, cfg, device=dev)
        params, opt_state = opt.update(grads, opt_state, params, hp)
        return loss, params, opt_state

    return step
