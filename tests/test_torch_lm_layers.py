"""The LM layers (``repro_torch.models.layers``, ``.ssm``) against
``repro.models``' on the same inputs and weights: float32 at rtol and
atol 1e-5, bf16 at 2e-2.  The JAX side runs under ``jax.jit``, as it runs
inside ``repro``'s scans."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch.configs import get_config as t_config
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = sorted(TOL)


def configs(arch, dtype, **kw):
    """The smoke config of ``arch`` in both packages, in ``dtype``."""
    return (dataclasses.replace(j_config(arch, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(t_config(arch, smoke=True), dtype=dtype, **kw))


def arrays(rng, shape, dtype, scale=1.0):
    """A seeded normal array as (jax, torch) in ``dtype`` (the same
    rounded values in both)."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def params(tree, dtype):
    """A ``repro`` parameter dict as (jax, torch) in ``dtype``."""
    j = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), tree)
    t = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)), j)
    return j, t


def close(j, t, dtype, tol=None):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(np.asarray(t.float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    xj, xt = arrays(rng, (2, 16, 128), dtype, 3.0)
    wj, wt = arrays(rng, (128,), dtype)
    f = jax.jit(lambda x, w: JL.rms_norm(x, w, 1e-6))
    close(f(xj, wj), TL.rms_norm(xt, wt, 1e-6), dtype)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_to_long_positions(dtype, theta):
    """Positions up to 40,000: the frequencies are float64 in NumPy, then
    float32, as JAX casts them before the product."""
    rng = np.random.default_rng(1)
    xj, xt = arrays(rng, (1, 64, 4, 128), dtype)
    pos = np.sort(rng.integers(0, 40_001, 64)).astype(np.int32)
    pos[-1] = 40_000
    f = jax.jit(lambda x, p: JL.rope(x, p, theta))
    close(f(xj, jnp.asarray(pos)), TL.rope(xt, torch.from_numpy(pos), theta),
          dtype)


def qkv(rng, dtype, B, Sq, Sk, H, K, D):
    q = arrays(rng, (B, Sq, H, D), dtype)
    k = arrays(rng, (B, Sk, K, D), dtype)
    v = arrays(rng, (B, Sk, K, D), dtype)
    return (q[0], k[0], v[0]), (q[1], k[1], v[1])


@pytest.mark.parametrize("mask", ["causal", "window", "k_len", "bidir",
                                  "offsets"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa(dtype, mask):
    jc, tc = configs("qwen3_0_6b", dtype)
    kw = {"causal": {"causal": True}, "window": {"causal": True, "window": 5},
          "k_len": {"causal": True, "k_len": 11},
          "bidir": {"causal": False},
          "offsets": {"causal": True, "q_pos0": 4, "k_pos0": 0,
                      "window": 9, "k_len": 18}}[mask]
    Sq = 16 if mask != "offsets" else 12
    rng = np.random.default_rng(2)
    js, ts = qkv(rng, dtype, 2, Sq, 16 if mask != "offsets" else 20,
                 jc.n_heads, jc.n_kv_heads, jc.hd)
    f = jax.jit(lambda q, k, v: JL._sdpa(q, k, v, jc, **kw))
    close(f(*js), TL._sdpa(*ts, tc, **kw), dtype)


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa_chunked(dtype, window):
    """256 tokens in chunks of 64 (a smoke config's ``attn_chunk``): the
    route ``attention`` takes above 128 tokens."""
    jc, tc = configs("qwen3_0_6b", dtype)
    assert TL.takes_chunked_route(tc, 256) and not TL.takes_chunked_route(
        tc, 128)
    rng = np.random.default_rng(3)
    js, ts = qkv(rng, dtype, 1, 256, 256, jc.n_heads, jc.n_kv_heads, jc.hd)
    f = jax.jit(lambda q, k, v: JL._sdpa_chunked(q, k, v, jc, window=window))
    close(f(*js), TL._sdpa_chunked(*ts, tc, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_modes(dtype):
    """``attention`` whole: causal, bidir, prefill (its cache), cross."""
    jc, tc = configs("qwen3_0_6b", dtype)
    pj, pt = params(JL.init_attention(jax.random.PRNGKey(0), jc,
                                      jnp.float32), dtype)
    rng = np.random.default_rng(4)
    xj, xt = arrays(rng, (2, 12, jc.d_model), dtype)
    pos = np.arange(12, dtype=np.int32)
    for mode in ("causal", "bidir", "prefill"):
        f = jax.jit(lambda x, p: JL.attention(x, p, jc, positions=jnp.asarray(
            pos), mode=mode))
        oj, cj = f(xj, pj)
        ot, ct = TL.attention(xt, pt, tc, positions=torch.from_numpy(pos),
                              mode=mode)
        close(oj, ot, dtype)
        if mode == "prefill":
            for key in ("k", "v", "pos_slots", "length"):
                close(cj[key], ct[key], dtype)
    (kj, kt), (vj, vt) = (arrays(rng, (2, 7, jc.n_kv_heads, jc.hd), dtype)
                          for _ in range(2))
    f = jax.jit(lambda x, p, k, v: JL.attention(
        x, p, jc, positions=None, mode="cross", cross_kv=(k, v))[0])
    close(f(xj, pj, kj, vj), TL.attention(xt, pt, tc, positions=None,
                                          mode="cross",
                                          cross_kv=(kt, vt))[0], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_ring_past_the_window(dtype):
    """hymba-smoke's sliding window (32): a ring of 32 slots decoded 40
    steps, so slots wrap and old positions leave the window; every
    output and the cache (k, v, pos_slots, length) equal at each step.
    The cache the port was given stays as it was."""
    jc, tc = configs("hymba_1_5b", dtype)
    assert tc.sliding_window == 32
    pj, pt = params(JL.init_attention(jax.random.PRNGKey(1), jc,
                                      jnp.float32), dtype)
    cj = JL.init_attn_cache(jc, 2, 32, jnp.dtype(dtype))
    ct = TL.init_attn_cache(tc, 2, 32, getattr(torch, dtype), "cpu")
    rng = np.random.default_rng(5)
    step = jax.jit(lambda x, p, c, pos: JL.attention(
        x, p, jc, positions=pos, mode="decode", layer_cache=c))
    for t in range(40):
        xj, xt = arrays(rng, (2, 1, jc.d_model), dtype)
        oj, cj = step(xj, pj, cj, jnp.asarray(t, jnp.int32))
        before = ct["k"].clone()
        ot, ct_new = TL.attention(xt, pt, tc, positions=torch.tensor(
            t, dtype=torch.int32), mode="decode", layer_cache=ct)
        assert torch.equal(ct["k"], before)
        ct = ct_new
        close(oj, ot, dtype)
        for key in ("k", "v", "pos_slots", "length"):
            close(cj[key], ct[key], dtype)
    assert int(ct["length"]) == 40
    assert sorted(ct["pos_slots"].tolist()) == list(range(8, 40))


@pytest.mark.parametrize("arch,act", [("qwen3_0_6b", "silu"),
                                      ("gemma_2b", "geglu"),
                                      ("whisper_tiny", "gelu")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype, arch, act):
    """GELU in the tanh form, as ``jax.nn.gelu``'s default."""
    jc, tc = configs(arch, dtype)
    assert tc.act == act
    pj, pt = params(JL.init_mlp(jax.random.PRNGKey(2), jc,
                                dtype=jnp.float32), dtype)
    rng = np.random.default_rng(6)
    xj, xt = arrays(rng, (2, 16, jc.d_model), dtype, 2.0)
    close(jax.jit(lambda x, p: JL.mlp(x, p, jc))(xj, pj), TL.mlp(xt, pt, tc),
          dtype)


def test_top_k_is_stable_like_lax_top_k():
    x = np.array([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 2)
    vt, it = TL.top_k_stable(torch.from_numpy(x), 2)
    assert it.tolist() == np.asarray(ij).tolist() == [[1, 2], [0, 1]]
    assert vt.tolist() == np.asarray(vj).tolist()


@pytest.mark.parametrize("case", ["drops", "tie-top1", "tie-top2",
                                  "dense-branch"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_reference(dtype, case):
    """The GShard dispatch: tokens past an expert's capacity dropped in
    (token, choice) order; experts whose router columns are equal tie on
    every token, and the lower index wins as in ``jax.lax.top_k``."""
    arch = "llama4_scout_17b_a16e" if case == "tie-top1" else "arctic_480b"
    kw = {"drops": {"capacity_factor": 0.5}}.get(case, {})
    jc, tc = configs(arch, dtype, **kw)
    tree = JL.init_moe(jax.random.PRNGKey(3), jc, jnp.float32)
    if case.startswith("tie"):
        tree["router"] = tree["router"].at[:, 2].set(tree["router"][:, 1])
    pj, pt = params(tree, dtype)
    rng = np.random.default_rng(7)
    xj, xt = arrays(rng, (2, 16, jc.d_model), dtype)
    f = jax.jit(lambda x, p: JL._moe_reference(x, p, jc))
    got = TL._moe_reference(xt.reshape(32, -1), pt, tc)
    close(f(xj.reshape(32, -1), pj), got, dtype)
    if case == "drops":
        wide = dataclasses.replace(tc, capacity_factor=8.0)
        full = TL._moe_reference(xt.reshape(32, -1), pt, wide)
        dropped = (got - full).abs().amax(-1) > 0
        assert 0 < int(dropped.sum()) < 32
    if case == "dense-branch":
        close(jax.jit(lambda x, p: JL.moe_ffn(x, p, jc))(xj, pj),
              TL.moe_ffn(xt, pt, tc), dtype)


@pytest.mark.parametrize("S", [8, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba(dtype, S):
    """Stateless, and with a state (prefill from zeros, then two one-token
    steps): outputs, the conv window and h.  512 tokens are two scan
    chunks of 256."""
    jc, tc = configs("hymba_1_5b", dtype)
    pj, pt = params(JS.init_mamba(jax.random.PRNGKey(4), jc, jnp.float32),
                    dtype)
    rng = np.random.default_rng(8)
    xj, xt = arrays(rng, (2, S, jc.d_model), dtype)
    f = jax.jit(lambda x, p, s: JS.mamba(x, p, jc, state=s))
    close(f(xj, pj, None)[0], TS.mamba(xt, pt, tc)[0], dtype)
    sj = JS.init_mamba_state(jc, 2, jnp.dtype(dtype))
    st = TS.init_mamba_state(tc, 2, getattr(torch, dtype), "cpu")
    for x in [(xj, xt)] + [arrays(rng, (2, 1, jc.d_model), dtype)
                           for _ in range(2)]:
        oj, sj = f(x[0], pj, sj)
        ot, st = TS.mamba(x[1], pt, tc, state=st)
        close(oj, ot, dtype)
        for key in ("conv", "h"):
            close(sj[key], st[key], dtype)


@pytest.mark.parametrize("S", [8, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm(dtype, S):
    """Stateless and with a state, as for Mamba; zero weights above the
    diagonal come from exp(-inf).  At 512 tokens (two chunks of 256) in
    float32 the normalizer's sums cancel: ``repro``'s own result lies
    3.4e-5 from a float64 run of the same recurrence (the port's 4.6e-5;
    ``tools/lm_parity.py``), so that case holds at 1e-4."""
    tol = 1e-4 if (dtype, S) == ("float32", 512) else None
    jc, tc = configs("xlstm_1_3b", dtype)
    pj, pt = params(JS.init_mlstm(jax.random.PRNGKey(5), jc, jnp.float32),
                    dtype)
    rng = np.random.default_rng(9)
    xj, xt = arrays(rng, (2, S, jc.d_model), dtype)
    f = jax.jit(lambda x, p, s: JS.mlstm(x, p, jc, state=s))
    close(f(xj, pj, None)[0], TS.mlstm(xt, pt, tc)[0], dtype, tol)
    sj = JS.init_mlstm_state(jc, 2)
    st = TS.init_mlstm_state(tc, 2, "cpu")
    for x in [(xj, xt)] + [arrays(rng, (2, 1, jc.d_model), dtype)
                           for _ in range(2)]:
        oj, sj = f(x[0], pj, sj)
        ot, st = TS.mlstm(x[1], pt, tc, state=st)
        close(oj, ot, dtype, tol)
        for key in ("C", "n"):
            close(sj[key], st[key], dtype, tol)


def test_scan_chunks_need_a_multiple_of_the_chunk():
    """Prompts past 256 tokens must be multiples of 256, in both."""
    jc, tc = configs("xlstm_1_3b", "float32")
    pj, pt = params(JS.init_mlstm(jax.random.PRNGKey(5), jc, jnp.float32),
                    "float32")
    rng = np.random.default_rng(10)
    xj, xt = arrays(rng, (1, 300, jc.d_model), "float32")
    with pytest.raises(AssertionError):
        JS.mlstm(xj, pj, jc)
    with pytest.raises(AssertionError):
        TS.mlstm(xt, pt, tc)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm(dtype):
    jc, tc = configs("xlstm_1_3b", dtype)
    pj, pt = params(JS.init_slstm(jax.random.PRNGKey(6), jc, jnp.float32),
                    dtype)
    rng = np.random.default_rng(11)
    xj, xt = arrays(rng, (2, 16, jc.d_model), dtype)
    f = jax.jit(lambda x, p, s: JS.slstm(x, p, jc, state=s))
    close(f(xj, pj, None)[0], TS.slstm(xt, pt, tc)[0], dtype)
    sj = JS.init_slstm_state(jc, 2)
    st = TS.init_slstm_state(tc, 2, "cpu")
    for x in [(xj, xt), arrays(rng, (2, 1, jc.d_model), dtype)]:
        oj, sj = f(x[0], pj, sj)
        ot, st = TS.slstm(x[1], pt, tc, state=st)
        close(oj, ot, dtype)
        for key in ("h", "c", "n", "m"):
            close(sj[key], st[key], dtype)


def test_rope_frequencies_are_float64_then_float32():
    dh, theta = 128, 1_000_000.0
    want = np.asarray(jnp.asarray(
        theta ** (-np.arange(0, dh // 2) * 2.0 / dh)))
    assert want.dtype == np.float32
    assert np.array_equal(TL.rope_freqs(dh, theta), want)
    assert math.isclose(float(TL.rope_freqs(dh, theta)[1]),
                        theta ** (-2.0 / dh), rel_tol=1e-7)
