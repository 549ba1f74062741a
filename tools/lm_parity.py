#!/usr/bin/env python3
"""How far the port's LM sits from ``repro``'s, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_parity.py

For each architecture's SMOKE config, with ``repro``'s weights (key 0)
carried across by ``interop.lm_params``: the largest |port - repro| of
the forward logits (batch 2, 16 tokens) in float32 and in bf16, and
``repro``'s own bf16 logits against its float32 ones.  Then the mLSTM
layer over 512 tokens (two chunks of 256) in float32, each package
against a float64 evaluation of the same recurrence (NumPy, below).
The tests hold the port at 1e-4 (float32) and 2e-2 (bf16); this prints
the margins.  About a minute.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def forward_logits(arch: str) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_config
    from repro.models import model as JM
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    base = j_config(arch, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), base)
    tree = jax.tree.map(np.asarray, params)
    extra = {}
    if base.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (2, base.img_tokens, base.d_model)).astype(np.float32)
    if base.family == "audio":
        extra["frames"] = rng.standard_normal(
            (2, base.enc_frames, base.d_model)).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(base, dtype=dtype)
        tc = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
        j = JM.forward(params, jnp.asarray(tokens), jc,
                       extra={k: jnp.asarray(v) for k, v in extra.items()})
        t = TM.forward(interop.lm_params(tree, tc, "cpu"), tokens, tc,
                       extra=extra, device="cpu")
        out[dtype] = (np.asarray(j[0], np.float32), t[0].float().numpy())
    return {"port_vs_repro_float32": float(np.abs(
                out["float32"][0] - out["float32"][1]).max()),
            "port_vs_repro_bf16": float(np.abs(
                out["bfloat16"][0] - out["bfloat16"][1]).max()),
            "repro_bf16_vs_float32": float(np.abs(
                out["bfloat16"][0] - out["float32"][0]).max())}


def mlstm_f64(x, p, n_heads: int) -> np.ndarray:
    """``repro.models.ssm.mlstm`` (no state) in float64 NumPy."""
    B, S, D = x.shape
    H, dh = n_heads, D // n_heads
    xz = x @ p["in_proj"]
    u, z = xz[..., :D], xz[..., D:]
    q = (u @ p["wq"]).reshape(B, S, H, dh) / math.sqrt(dh)
    k = (u @ p["wk"]).reshape(B, S, H, dh)
    v = (u @ p["wv"]).reshape(B, S, H, dh)
    gates = u @ p["w_if"]
    ig, fg = gates[..., :H], -np.logaddexp(0.0, -gates[..., H:])
    C, n = np.zeros((B, H, dh, dh)), np.zeros((B, H, dh))
    c, hs = min(256, S), []
    tri = np.tril(np.ones((c, c), bool))[None, :, :, None]
    for i in range(0, S, c):
        qb, kb, vb = q[:, i:i + c], k[:, i:i + c], v[:, i:i + c]
        ib, fcum = ig[:, i:i + c], np.cumsum(fg[:, i:i + c], axis=1)
        logw = fcum[:, :, None] - fcum[:, None] + ib[:, None]
        w = np.exp(np.where(tri, logw, -np.inf))
        scores = np.einsum("bthd,bshd->bths", qb, kb) * w.transpose(
            0, 1, 3, 2)
        dec = np.exp(fcum)
        num = (np.einsum("bths,bshd->bthd", scores, vb)
               + np.einsum("bthd,bhde->bthe", qb, C) * dec[..., None])
        den = scores.sum(-1) + np.einsum("bthd,bhd->bth", qb, n) * dec
        hs.append(num / np.maximum(np.abs(den), 1.0)[..., None])
        wk = np.exp(fcum[:, -1:] - fcum) * np.exp(ib)
        C = (C * np.exp(fcum[:, -1])[..., None, None]
             + np.einsum("bshd,bshe,bsh->bhde", kb, vb, wk))
        n = (n * np.exp(fcum[:, -1])[..., None]
             + np.einsum("bshd,bsh->bhd", kb, wk))
    h = np.concatenate(hs, axis=1).reshape(B, S, D)
    return (h * (z / (1.0 + np.exp(-z)))) @ p["out_proj"]


def mlstm_512() -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as j_config
    from repro.models import ssm as JS
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as TS

    jc = dataclasses.replace(j_config("xlstm_1_3b", smoke=True),
                             dtype="float32")
    tc = dataclasses.replace(get_config("xlstm_1_3b", smoke=True),
                             dtype="float32")
    p = jax.tree.map(np.asarray, JS.init_mlstm(jax.random.PRNGKey(5), jc,
                                               jnp.float32))
    x = np.random.default_rng(9).standard_normal(
        (2, 512, jc.d_model)).astype(np.float32)
    j = np.asarray(jax.jit(lambda a, w: JS.mlstm(a, w, jc)[0])(
        jnp.asarray(x), p))
    t = TS.mlstm(torch.from_numpy(x), {k: torch.from_numpy(np.array(v))
                                       for k, v in p.items()}, tc)[0].numpy()
    ref = mlstm_f64(x.astype(np.float64),
                    {k: v.astype(np.float64) for k, v in p.items()},
                    jc.n_heads)
    return {"repro_vs_float64": float(np.abs(j - ref).max()),
            "port_vs_float64": float(np.abs(t - ref).max()),
            "port_vs_repro": float(np.abs(t - j).max())}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS
    for arch in ARCHS:
        print(arch, {k: f"{v:.3e}" for k, v in forward_logits(arch).items()})
    print("mlstm 512 tokens float32",
          {k: f"{v:.3e}" for k, v in mlstm_512().items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
