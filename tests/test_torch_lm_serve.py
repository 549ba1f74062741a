"""LM serving (``repro_torch.models.lm_engine``, ``model.prefill`` /
``decode_step`` on their other routes) against ``repro``'s, with the
weights of ``test_torch_lm_model.py``: ``generate``'s tokens equal at
float32 for the ten architectures, the sliding-window ring past its
window, the chunked attention and two scan chunks, decoding from an
empty cache, and decode against forward on the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm_engine as JE
from repro.models import model as JM

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers as TL
from repro_torch.models import lm_engine as TE
from repro_torch.models import model as TM

from test_torch_lm_model import close, extra, pair, stacked


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_repro(arch):
    jc, jp, tc, tp = pair(arch, "float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n in (5, 9, 7)]
    ex = extra(jc, 3, rng)
    jreqs = [JE.Request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                              (4, 2, 3))]
    treqs = [TE.Request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                              (4, 2, 3))]
    want = JE.generate(jp, jc, jreqs,
                       extra={k: jnp.asarray(v) for k, v in ex.items()})
    got = TE.generate(tp, tc, treqs, extra=ex, device="cpu")
    assert got.shape == (3, 4) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_pad_prompts_left_pads_with_zero():
    prompts = [np.array([5, 6], np.int32), np.array([7, 8, 9], np.int32)]
    got = TE._pad_prompts(prompts)
    assert got.tolist() == [[0, 5, 6], [7, 8, 9]]
    np.testing.assert_array_equal(got, JE._pad_prompts(prompts))


def test_hymba_prefill_past_the_window_then_decode():
    """A 40-token prompt on hymba-smoke (window 32) makes a 40-slot ring,
    masked by the window; 10 decode steps wrap it."""
    jc, jp, tc, tp = pair("hymba_1_5b", "float32")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab, (2, 40)).astype(np.int32)
    jl, jcache = JM.prefill(jp, jnp.asarray(tokens), jc)
    tl, tcache = TM.prefill(tp, tokens, tc, device="cpu")
    assert tcache["layers"][0]["attn"]["k"].shape[1] == 40
    close(jl, tl, "float32")
    for t in rng.integers(0, jc.vocab, (10, 2, 1)).astype(np.int32):
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(t), jc)
        tl, tcache = TM.decode_step(tp, tcache, t, tc, device="cpu")
        close(jl, tl, "float32")
    close(jcache["layers"]["attn"]["pos_slots"],
          stacked(tcache["layers"], ("attn", "pos_slots")), "float32")
    close(jcache["layers"]["mamba"]["h"],
          stacked(tcache["layers"], ("mamba", "h")), "float32")


@pytest.mark.parametrize("arch,n", [("qwen3_0_6b", 256), ("xlstm_1_3b", 512)])
def test_long_prompts_take_the_other_routes(arch, n):
    """qwen3-smoke's 256 tokens take the chunked attention (4 chunks of
    64); xlstm-smoke's 512 are two scan chunks; then one decode step."""
    jc, jp, tc, tp = pair(arch, "float32")
    if tc.family != "ssm":
        assert TL.takes_chunked_route(tc, n)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jc.vocab, (1, n)).astype(np.int32)
    jl, jcache = JM.prefill(jp, jnp.asarray(tokens), jc)
    tl, tcache = TM.prefill(tp, tokens, tc, device="cpu")
    close(jl, tl, "float32")
    jl, _ = JM.decode_step(jp, jcache, jnp.asarray(tokens[:, :1]), jc)
    tl, _ = TM.decode_step(tp, tcache, tokens[:, :1], tc, device="cpu")
    close(jl, tl, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_an_empty_cache(arch):
    """``init_decode_cache`` then 3 decode steps, in both."""
    jc, jp, tc, tp = pair(arch, "float32")
    jcache = JM.init_decode_cache(jc, 2, 16)
    tcache = TM.init_decode_cache(tc, 2, 16, device="cpu")
    rng = np.random.default_rng(4)
    for t in rng.integers(0, jc.vocab, (3, 2, 1)).astype(np.int32):
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(t), jc)
        tl, tcache = TM.decode_step(tp, tcache, t, tc, device="cpu")
        close(jl, tl, "float32")


def test_decode_matches_forward_dense():
    """``test_arch_smoke.py``'s check on the port: greedy decode logits
    equal forward's at the same positions (bf16, 2e-2)."""
    cfg = get_config("qwen3_0_6b", smoke=True)
    lm = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, S = 1, 12
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    full, _ = TM.forward(lm, tokens, cfg, device="cpu")
    pre, cache = TM.prefill(lm, tokens[:, :S - 1], cfg, device="cpu")
    close(full[:, S - 2].float(), pre[:, -1], "bfloat16")
    step, _ = TM.decode_step(lm, cache, tokens[:, S - 1:S], cfg,
                             device="cpu")
    close(full[:, S - 1].float(), step[:, 0], "bfloat16")
