"""Input and parameter stand-ins for every (architecture x shape) cell (a
port of ``repro.launch.specs``).

The four assigned LM shapes:

  train_4k     seq 4,096 x global batch 256   -> train step
  prefill_32k  seq 32,768 x global batch 32   -> prefill
  decode_32k   KV 32,768 x global batch 128   -> decode_step
  long_500k    KV 524,288 x global batch 1    -> decode_step
               (sub-quadratic archs only; full-attention archs are
               skipped per the shape rules)

Modality stubs per the rules: ``[vlm]``/``[audio]`` get precomputed
patch/frame embeddings in the input spec; no frontend is built.

``repro``'s stand-ins are ``jax.ShapeDtypeStruct``s from
``jax.eval_shape``; the port's are tensors on the ``meta`` device, which
carry a shape and a dtype and allocate nothing.  ``repro`` stacks a layer
stack's parameters ``[L, ...]``; the port's tree keeps one dict a layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str             # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_SPECS: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-not)."""
    if shape == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full attention at 524k context is not "
                       "sub-quadratic; skipped per the shape rules")
    return True, ""


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _modality(cfg: ModelConfig, B: int, specs: Dict[str, Any]):
    if cfg.family == "vlm":
        specs["patches"] = _sds((B, cfg.img_tokens, cfg.d_model),
                                torch.float32)
    if cfg.family == "audio":
        specs["frames"] = _sds((B, cfg.enc_frames, cfg.d_model),
                               torch.float32)
    return specs


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """Stand-ins for every model input of the given shape cell."""
    ss = SHAPE_SPECS[shape]
    B, S = ss.global_batch, ss.seq_len
    if ss.kind == "train":
        return _modality(cfg, B, {"tokens": _sds((B, S), torch.int32),
                                  "labels": _sds((B, S), torch.int32)})
    if ss.kind == "prefill":
        return _modality(cfg, B, {"tokens": _sds((B, S), torch.int32)})
    # decode: one new token against a pre-allocated cache of seq_len
    return {"tokens": _sds((B, 1), torch.int32),
            "cache": M.init_decode_cache(cfg, B, S, device=META)}


def params_specs(cfg: ModelConfig):
    """The parameter tree of ``cfg`` on ``meta``: nothing drawn or
    allocated."""
    return M.init_params(cfg, device=META).tree()
