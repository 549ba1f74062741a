"""The LM model and its serving (``repro_torch.models.model``,
``repro_torch.configs``) against ``repro``'s, for the ten architectures:
weights made once by ``repro``'s ``init_params`` and carried across with
``interop.lm_params``.  ``forward``, then ``prefill`` and 3
``decode_step``s, at float32 (rtol and atol 1e-4) and at the published
bf16 (2e-2, as ``tests/test_arch_smoke.py`` uses); the configurations
field for field; the parameter tree of ``init_params`` against
``jax.eval_shape``'s.  Serving (``generate``, the decode ring, long
prompts) is in ``test_torch_lm_serve.py``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import ALIASES as J_ALIASES
from repro.configs import get_config as j_config
from repro.models import model as JM

from repro_torch import interop
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.distributed import context as dctx
from repro_torch.models import layers as TL
from repro_torch.models import lm_engine as TE
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def weights(arch):
    """``repro``'s parameters of ``arch``'s smoke config (key 0), as the
    NumPy tree both packages take."""
    params = JM.init_params(jax.random.PRNGKey(0), j_config(arch, smoke=True))
    return jax.tree.map(np.asarray, params)


def pair(arch, dtype):
    """(repro config, repro params, port config, port params) in
    ``dtype``."""
    jc = dataclasses.replace(j_config(arch, smoke=True), dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    tree = weights(arch)
    return (jc, jax.tree.map(jnp.asarray, tree), tc,
            interop.lm_params(tree, tc, "cpu"))


def extra(cfg, batch, rng):
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (batch, cfg.img_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)}
    return {}


def close(j, t, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(t.float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def stacked(layers, path):
    """The port's per-layer cache entry at ``path`` stacked as ``repro``
    stacks it."""
    vals = []
    for c in layers:
        for key in path:
            c = c[key]
        vals.append(c)
    return torch.stack(vals)


def close_caches(jcache, tcache, cfg):
    if cfg.family == "ssm":
        close(jcache["m"]["C"], stacked([stacked(g, ("C",))
                                         for g in tcache["m"]], ()),
              "float32")
        close(jcache["s"]["h"], stacked(tcache["s"], ("h",)), "float32")
        return
    for key in ("k", "v", "pos_slots", "length"):
        close(jcache["layers"]["attn"][key],
              stacked(tcache["layers"], ("attn", key)), "float32")


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_repro(arch, dtype):
    """The logits at both dtypes; the prefill's cache (keys, values,
    positions, lengths; xLSTM's states) at float32."""
    jc, jp, tc, tp = pair(arch, dtype)
    rng = np.random.default_rng(0)
    B, S = 2, 16
    tokens = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    ex = extra(jc, B, rng)
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    jl, _ = JM.forward(jp, jnp.asarray(tokens), jc, extra=jex)
    tl, caches = TM.forward(tp, tokens, tc, extra=ex, device="cpu")
    assert caches is None and tl.shape == (B, S, tc.vocab)
    close(jl, tl, dtype)
    jl, jcache = JM.prefill(jp, jnp.asarray(tokens[:, :8]), jc, extra=jex)
    tl, tcache = TM.prefill(tp, tokens[:, :8], tc, extra=ex, device="cpu")
    close(jl, tl, dtype)
    if dtype == "float32":
        close_caches(jcache, tcache, tc)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 8
    feed = rng.integers(0, jc.vocab, (3, B, 1)).astype(np.int32)
    for t in feed:
        jl, jcache = JM.decode_step(jp, jcache, jnp.asarray(t), jc)
        tl, tcache = TM.decode_step(tp, tcache, t, tc, device="cpu")
        close(jl, tl, dtype)
    assert int(tcache["pos"]) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro(arch):
    assert ARCHS == J_ARCHS and ALIASES == J_ALIASES
    for smoke in (False, True):
        j, t = j_config(arch, smoke), get_config(arch, smoke)
        assert isinstance(t, ModelConfig)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("hd", "q_per_kv", "d_inner", "is_subquadratic",
                     "has_decoder_cache"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_eval_shape(arch):
    """Names, shapes and dtypes of the port's ``init_params`` equal
    ``jax.eval_shape(repro.models.model.init_params)``'s, each stacked
    axis a list."""
    jc, tc = j_config(arch, smoke=True), get_config(arch, smoke=True)
    want = jax.eval_shape(lambda k: JM.init_params(k, jc),
                          jax.random.PRNGKey(0))
    lm = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    tree = lm.tree()
    axes = {"blocks": 1, "enc_blocks": 1, "s_blocks": 1, "m_blocks": 2}
    got = {}
    for top, sub in tree.items():
        n = axes.get(top, 0)
        if n == 0:
            got[(top,)] = (tuple(sub.shape), sub.dtype)
            continue
        rows = sub if n == 1 else [b for g in sub for b in g]
        lead = (len(sub),) if n == 1 else (len(sub), len(sub[0]))
        for path, leaf in leaves(rows[0], (top,)):
            got[path] = (lead + tuple(leaf.shape), leaf.dtype)
            for row in rows[1:]:
                other = row
                for key in path[1:]:
                    other = other[key]
                assert other.shape == leaf.shape
    want = {p: (tuple(a.shape), a.dtype) for p, a in leaves(want)}
    assert set(got) == set(want)
    for path, (shape, dtype) in want.items():
        assert got[path][0] == shape, path
        assert str(got[path][1]).split(".")[-1] == str(dtype), path
    assert all(not p.requires_grad for p in lm.parameters())
    state = lm.state_dict()
    assert "embed" in state and next(
        k for k in state if k.startswith(("blocks.", "m_blocks.")))


def test_init_params_draws_repro_s_scales():
    """``normal / sqrt(fan_in)``, the embedding ``normal * 0.02``."""
    cfg = get_config("qwen3_0_6b", smoke=True)
    tree = TM.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").tree()
    assert abs(float(tree["embed"].std()) - 0.02) < 1e-3
    wq = tree["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    wo = tree["blocks"][0]["attn"]["wo"]
    assert abs(float(wo.std()) * (cfg.n_heads * cfg.hd) ** 0.5 - 1.0) < 0.05
    assert torch.equal(tree["blocks"][1]["ln1"], torch.ones(cfg.d_model))
    again = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu").tree()
    assert torch.equal(again["blocks"][1]["mlp"]["w2"],
                       tree["blocks"][1]["mlp"]["w2"])


def test_lm_module_is_its_tree():
    """``LM`` holds the tree as parameters: ``LM.forward`` and the
    blocks' ``forward`` equal the functions on the tree."""
    jc, jp, tc, tp = pair("whisper_tiny", "float32")
    lm = TM.LM(tc, tp)
    assert isinstance(lm.blocks[0], TM.DecoderBlock)
    assert isinstance(lm.enc_blocks[0], TM.EncoderBlock)
    assert isinstance(lm.blocks[0].attn, TL.Attention)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tc.vocab, (2, 6)).astype(np.int32)
    ex = extra(tc, 2, rng)
    a, _ = lm(tokens, extra=ex)
    b, _ = TM.forward(tp, tokens, tc, extra=ex, device="cpu")
    assert torch.equal(a, b)
    x = torch.randn(1, 4, tc.d_model)
    pos = torch.arange(4, dtype=torch.int32)
    enc = torch.randn(1, tc.enc_frames, tc.d_model)
    with torch.inference_mode():
        got, _ = lm.blocks[1](x, positions=pos, mode="train", enc_out=enc)
        want, _ = TM._block_apply(x, tp["blocks"][1], tc, positions=pos,
                                  mode="train", enc_out=enc)
    assert torch.equal(got, want)
    xl = TM.LM(get_config("xlstm_1_3b", smoke=True),
               pair("xlstm_1_3b", "float32")[3])
    assert isinstance(xl.m_blocks[1][0], TM.MLSTMBlock)
    assert isinstance(xl.s_blocks[0].slstm, TM.S.SLSTM)


def test_lm_params_unstacks_repro_s_axes():
    tree = weights("xlstm_1_3b")
    cfg = get_config("xlstm_1_3b", smoke=True)
    got = interop.lm_params(tree, cfg, "cpu")
    G, g1 = tree["m_blocks"]["mlstm"]["wq"].shape[:2]
    assert len(got["m_blocks"]) == G and len(got["m_blocks"][0]) == g1
    np.testing.assert_array_equal(
        got["m_blocks"][1][0]["mlstm"]["wq"].numpy(),
        tree["m_blocks"]["mlstm"]["wq"][1, 0])
    np.testing.assert_array_equal(got["s_blocks"][1]["slstm"]["r_rec"].numpy(),
                                  tree["s_blocks"]["slstm"]["r_rec"][1])
    assert got["embed"].dtype == torch.float32
    bad = dict(weights("qwen3_0_6b"))
    with pytest.raises(ValueError, match="stacked layers"):
        interop.lm_params(bad, dataclasses.replace(
            get_config("qwen3_0_6b", smoke=True), n_layers=3), "cpu")


def test_entry_points_run_on_the_card_or_raise(monkeypatch):
    cfg = get_config("qwen3_0_6b", smoke=True)
    lm = TM.init_params(cfg, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TM.init_params(cfg),
                 lambda: TM.forward(lm, tokens, cfg),
                 lambda: TM.prefill(lm, tokens, cfg),
                 lambda: TM.init_decode_cache(cfg, 1, 8),
                 lambda: TE.generate(lm, cfg, [TE.Request(tokens[0])])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_a_mesh_context_is_refused_not_ignored():
    """Without a context ``constrain`` is the identity; with a mesh
    context installed the forward is not silently run unsharded: it runs
    on ``DTensor``s (here a one-rank gloo mesh) and gives the unsharded
    logits."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("qwen3_0_6b", smoke=True)
    lm = TM.init_params(cfg, device="cpu")
    x = torch.ones(2)
    assert dctx.constrain(x, "act_btd") is x
    tokens = np.arange(8, dtype=np.int32).reshape(2, 4)
    want, _ = TM.forward(lm, tokens, cfg, device="cpu")
    try:
        mesh = make_host_mesh(2, device="cpu")
        tree = SH.distribute_tree(lm.tree(), SH.tree_shardings(
            lm.tree(), mesh, False))
        with dctx.use(SH.make_ctx(cfg, mesh, False)):
            got, _ = TM.forward(tree, torch.as_tensor(tokens), cfg,
                                device="cpu")
    finally:
        dist.destroy_process_group()
    assert dctx.current() is None
    assert isinstance(got, DTensor)
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5,
                               atol=1e-5)
