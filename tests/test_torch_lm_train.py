"""LM training (``repro_torch.train``) against ``repro.train`` on the CPU,
for the ten architectures: weights made once by ``repro``'s
``init_params`` and carried across with ``interop.lm_params``, moments
with ``interop.lm_opt_state``, batches from both packages' data pipelines
(equal array for array).

* the loss and every leaf's gradient against ``jax.value_and_grad(
  repro.train.step.lm_loss)``: float32 within rtol 1e-4 and atol 1e-5,
  the published bf16 within a relative leaf-norm error of 2e-2;
* ``update`` against ``repro.train.optimizer.update`` (the schedule at
  steps 0, 1, warmup and total, clipping on and off), three
  ``make_train_step`` steps, and ``grad_accum=2`` against ``repro``'s
  ``grad_accum=2`` (gemma and the two MoE configurations);
* ``repro``'s own train tests (``tests/test_arch_smoke.py``) through the
  port; the masked label, serve and train in one process, ``remat``;
* ``TestData``'s cases (``tests/test_distributed.py``) through the port.

After an AdamW step a parameter whose gradient is near 0 may take the
other sign of ``lr`` in either package (step 1's update is
``sign(g) * lr``), so parameters are held elementwise within PARAM_TOL
for all but a PARAM_SHARE of the elements, and every element within
``3 * lr * steps``.
"""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import step as JS

from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.checkpoint import _flatten
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

ROOT = Path(__file__).resolve().parents[1]
F32 = {"rtol": 1e-4, "atol": 1e-5}
BF16_NORM = 2e-2
#: an MoE router's bf16 gradient: the top-k renormalisation of the gates
#: (d p_i = (d g_i - sum_j g_j d g_j) / sum) cancels, and amplifies the
#: bf16 ulp by which the two packages' gate cotangents differ
#: (arctic-smoke: 2.04e-2 with repro's routes)
BF16_ROUTER = 5e-2
#: a leaf whose exact gradient is 0 (the router of a top-1 MoE: its gate
#: is p / p) holds float32 noise in both packages
BF16_FLOOR = 1e-6
PARAM_TOL = 1e-5
PARAM_SHARE = 1e-3
HP = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MOE = ["arctic_480b", "llama4_scout_17b_a16e"]
#: a bf16 route may flip where repro's k-th and (k+1)-th router
#: probabilities lie closer than this (the two packages' bf16 activations
#: differ by an ulp, their router probabilities by up to ~2e-3)
NEAR_TIE = 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread a test process for these smoke-sized models: the
    suite runs several processes at once, and each one's default pool of
    a thread a core oversubscribes the host (a 2 s test took 97 s)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def weights(arch):
    """``repro``'s parameters of ``arch``'s smoke config (key 0), as the
    NumPy tree both packages take."""
    params = JM.init_params(jax.random.PRNGKey(0), j_config(arch, smoke=True))
    return jax.tree.map(np.asarray, params)


def configs(arch, dtype="float32"):
    return (dataclasses.replace(j_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def j_params(arch):
    return jax.tree.map(jnp.asarray, weights(arch))


def t_params(arch, cfg):
    return interop.lm_params(weights(arch), cfg, "cpu")


def batch(cfg, step=0, seq=16, rows=2, seed=0):
    return TD.make_batch(cfg, TD.DataConfig(seq_len=seq, global_batch=rows,
                                            seed=seed), step)


@functools.lru_cache(maxsize=None)
def j_value_and_grad():
    return jax.jit(jax.value_and_grad(JS.lm_loss), static_argnums=2)


@functools.lru_cache(maxsize=None)
def j_step(arch, dtype, grad_accum):
    jc, _ = configs(arch, dtype)
    return jax.jit(JS.make_train_step(jc, JO.AdamWConfig(**HP), grad_accum,
                                      jit=False))


def flat(tree):
    """Either package's tree as ``repro``'s checkpoint keys -> float32."""
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in _flatten(tree).items()}


def assert_params_close(got, want, steps, lr=HP["lr"]):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    err = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert err.max() <= 3 * lr * steps, err.max()
    assert np.mean(err > PARAM_TOL) <= PARAM_SHARE, np.mean(err > PARAM_TOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def j_router_probs(arch, jc, jb, monkeypatch):
    """Each MoE layer's router probabilities in ``repro``'s jitted loss, in
    layer order (read by a debug callback beside ``_moe_reference``)."""
    probs, orig = [], JL._moe_reference

    def patched(x2, p, cfg):
        pr = jax.nn.softmax((x2 @ p["router"]).astype(jnp.float32), -1)
        jax.debug.callback(lambda a: probs.append(np.asarray(a)), pr)
        return orig(x2, p, cfg)

    monkeypatch.setattr(JL, "_moe_reference", patched)
    jax.jit(lambda p, b: JS.lm_loss(p, b, jc))(j_params(arch), jb)
    monkeypatch.setattr(JL, "_moe_reference", orig)
    return probs


def top_k(probs, k):
    """``lax.top_k``'s ids: the lower index first among equals."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_repro(arch, dtype, monkeypatch):
    """At bf16 an MoE token whose top-k router probabilities are a near
    tie (closer than NEAR_TIE) may take another expert in either package;
    that token's route then changes every gradient.  So at bf16 the MoE
    configurations are held to ``repro`` twice: every route that differs
    is such a near tie in ``repro``, and with ``repro``'s routes given to
    the port (``top_k_stable`` replaced, ``remat`` off so each layer
    routes once) every leaf is within the bf16 bound."""
    jc, tc = configs(arch, dtype)
    b = batch(tc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = j_value_and_grad()(j_params(arch), jb, jc)
    if dtype == "bfloat16" and arch in MOE:
        routes = [top_k(p, tc.top_k) for p in
                  j_router_probs(arch, jc, jb, monkeypatch)]
        assert len(routes) == tc.n_layers
        seen = []

        def given(probs, k):
            idx = torch.from_numpy(routes[len(seen)])
            seen.append(probs.detach().numpy())
            return torch.gather(probs, -1, idx), idx

        monkeypatch.setattr(TL, "top_k_stable", given)
        tc = dataclasses.replace(tc, remat=False)
    t_loss, t_grads = TS.loss_and_grads(t_params(arch, tc), b, tc,
                                        device="cpu")
    if dtype == "bfloat16" and arch in MOE:
        assert len(seen) == tc.n_layers
        for p_t, p_j in zip(seen, j_router_probs(arch, jc, jb, monkeypatch)):
            own = top_k(p_t, tc.top_k)
            for r in np.flatnonzero((own != top_k(p_j, tc.top_k)).any(-1)):
                kth = np.sort(p_j[r])[::-1][tc.top_k - 1:tc.top_k + 1]
                assert kth[0] - kth[1] < NEAR_TIE, (r, kth)
    want, got = flat(j_grads), flat(t_grads)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k]).all(), k
    if dtype == "float32":
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)
    else:
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=2e-2)
        for k in want:
            norm = np.linalg.norm(want[k])
            err = np.linalg.norm(got[k] - want[k])
            bound = BF16_ROUTER if k.endswith("moe/router") else BF16_NORM
            assert err <= bound * norm + BF16_FLOOR, (k, err, norm)


def test_masked_label_gives_no_loss_and_no_gold():
    """A label of -1 is masked out of the mean and gathers no gold logit
    (``one_hot`` gives a zero row), as in ``repro``."""
    jc, tc = configs("qwen3_0_6b")
    b = batch(tc)
    b["labels"] = b["labels"].copy()
    b["labels"][0, :5] = -1
    b["labels"][1, 3] = -1
    j_loss, j_grads = j_value_and_grad()(
        j_params("qwen3_0_6b"), {k: jnp.asarray(v) for k, v in b.items()}, jc)
    t_loss, t_grads = TS.loss_and_grads(t_params("qwen3_0_6b", tc), b, tc,
                                        device="cpu")
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    want, got = flat(j_grads), flat(t_grads)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)
    # the masked positions do not count: the mean over the rest
    kept = TS.lm_loss(t_params("qwen3_0_6b", tc), b, tc, device="cpu")
    assert float(kept) == pytest.approx(float(t_loss))
    b["labels"][:] = -1
    assert float(TS.lm_loss(t_params("qwen3_0_6b", tc), b, tc,
                            device="cpu")) == 0.0


def test_remat_on_and_off_give_equal_grads():
    _, tc = configs("qwen3_0_6b")
    b = batch(tc)
    on = TS.loss_and_grads(t_params("qwen3_0_6b", tc), b, tc, device="cpu")
    off_cfg = dataclasses.replace(tc, remat=False)
    off = TS.loss_and_grads(t_params("qwen3_0_6b", off_cfg), b, off_cfg,
                            device="cpu")
    assert float(on[0]) == float(off[0])
    a, c = flat(on[1]), flat(off[1])
    assert all(np.array_equal(a[k], c[k]) for k in a)


def test_remat_recomputes_each_block(monkeypatch):
    """With ``remat`` each decoder block runs twice under autograd (the
    forward and its recomputation in the backward pass), once without."""
    _, tc = configs("whisper_tiny")
    calls = {"dec": 0, "enc": 0}
    block, enc = TM._block_apply, TM._enc_block

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TM, "_block_apply", count("dec", block))
    monkeypatch.setattr(TM, "_enc_block", count("enc", enc))
    b = batch(tc)
    TS.loss_and_grads(t_params("whisper_tiny", tc), b, tc, device="cpu")
    assert calls == {"dec": 2 * tc.n_layers, "enc": 2 * tc.enc_layers}
    calls.update(dec=0, enc=0)
    off = dataclasses.replace(tc, remat=False)
    TS.loss_and_grads(t_params("whisper_tiny", off), b, off, device="cpu")
    assert calls == {"dec": off.n_layers, "enc": off.enc_layers}


def test_trainable_sets_floating_leaves_only():
    _, tc = configs("qwen3_0_6b")
    lm = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in lm.parameters())
    assert TM.trainable(lm) is lm
    assert all(p.requires_grad for p in lm.parameters())
    tree = t_params("qwen3_0_6b", tc)
    TM.trainable(tree)
    assert all(t.requires_grad for t in TM.leaves(tree))


_SERVE_AND_TRAIN = r"""
import sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.models import lm_engine as E, model as M
from repro_torch.train import data as D, optimizer as O, step as S
cfg = get_config("qwen3_0_6b", smoke=True)
params = M.init_params(cfg, torch.Generator().manual_seed(0),
                       device="cpu").tree()
state = O.init(params)
step = S.make_train_step(cfg, O.AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10), device="cpu")
dc = D.DataConfig(seq_len=16, global_batch=2)
req = [E.Request(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)]
order = sys.argv[1].split(",")
out = []
for i, what in enumerate(order):
    if what == "serve":
        out.append(E.generate(params, cfg, req, device="cpu").tolist())
    else:
        loss, params, state = step(params, state, D.make_batch(cfg, dc, i))
        out.append(float(loss))
print(out)
"""


@pytest.mark.parametrize("order", ["serve,train,serve", "train,serve,train"])
def test_serve_and_train_in_one_process(order):
    """The cached RoPE frequencies made by a serve call (under inference
    mode) are saved for a later backward pass, and a trainable tree
    serves."""
    out = subprocess.run([sys.executable, "-c", _SERVE_AND_TRAIN, order],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    vals = eval(out.stdout.strip().splitlines()[-1])
    assert len(vals) == 3
    for what, v in zip(order.split(","), vals):
        if what == "train":
            assert np.isfinite(v) and v > 0


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_opt_state_carries_across():
    jc, tc = configs("hymba_1_5b")
    p = j_params("hymba_1_5b")
    state = JO.init(p)
    state = {"m": jax.tree.map(lambda a: a + 0.5, state["m"]),
             "v": jax.tree.map(lambda a: a + 0.25, state["v"]),
             "step": jnp.asarray(7, jnp.int32)}
    got = interop.lm_opt_state(jax.tree.map(np.asarray, state), tc, "cpu")
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    for k, v in flat(state["m"]).items():
        np.testing.assert_array_equal(flat(got["m"])[k], v)
    assert flat(got["v"]).keys() == flat(state["v"]).keys()
    fresh = TO.init(t_params("hymba_1_5b", tc))
    assert flat(fresh["m"]).keys() == flat(JO.init(p)["m"]).keys()
    assert int(fresh["step"]) == 0 and fresh["step"].dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 7, 10, 11, 25])
def test_schedule_equals_repro(step):
    """Steps 0, 1, warmup (3 and 4), the cosine, total (10) and past it."""
    for hp in (JO.AdamWConfig(lr=1e-3, warmup_steps=4, total_steps=10),
               JO.AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=7)):
        want = np.float32(jax.jit(lambda s: JO._schedule(s, hp))(
            jnp.asarray(step, jnp.int32)))
        got = TO._schedule(torch.tensor(step, dtype=torch.int32),
                           TO.AdamWConfig(**dataclasses.asdict(hp)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("start", [0, 3, 9])
def test_update_equals_repro(clip, start):
    """``update`` from the same grads, moments and step: the parameters,
    moments and step within rtol 1e-6 (atol 1e-8: ``b1 * m + (1 - b1) *
    g`` may cancel, and XLA may fuse it), the global norm within rtol
    1e-6."""
    jc, tc = configs("gemma_2b")
    rng = np.random.default_rng(start)
    tree = weights("gemma_2b")
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    state = {"m": jax.tree.map(
        lambda a: 0.01 * rng.standard_normal(a.shape).astype(np.float32),
        tree),
        "v": jax.tree.map(
        lambda a: 0.01 * rng.random(a.shape).astype(np.float32), tree),
        "step": np.asarray(start, np.int32)}
    hp = dict(lr=1e-3, warmup_steps=4, total_steps=10, grad_clip=clip)
    j_new, j_state = jax.jit(lambda g, s, p: JO.update(
        g, s, p, JO.AdamWConfig(**hp)))(grads, state, j_params("gemma_2b"))
    t_p = t_params("gemma_2b", tc)
    t_state = interop.lm_opt_state(state, tc, "cpu")
    t_g = interop.lm_params(grads, tc, "cpu")
    np.testing.assert_allclose(float(TO.global_norm(t_g)),
                               float(JO.global_norm(grads)), rtol=1e-6)
    out_p, out_state = TO.update(t_g, t_state, t_p, TO.AdamWConfig(**hp))
    assert out_p is t_p and out_state is t_state
    assert int(out_state["step"]) == start + 1
    for name in ("m", "v"):
        got, want = flat(out_state[name]), flat(j_state[name])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-8, err_msg=(name, k))
    got, want = flat(out_p), flat(j_new)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def run_both(arch, grad_accum, steps, rows=2, dtype="float32"):
    jc, tc = configs(arch, dtype)
    j_fn = j_step(arch, dtype, grad_accum)
    t_fn = TS.make_train_step(tc, TO.AdamWConfig(**HP), grad_accum,
                              device="cpu")
    jp, js = j_params(arch), JO.init(j_params(arch))
    tp = t_params(arch, tc)
    ts = TO.init(tp)
    losses = []
    for i in range(steps):
        b = batch(tc, i, rows=rows)
        jl, jp, js = j_fn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tl, tp, ts = t_fn(tp, ts, b)
        losses.append((float(tl), float(jl)))
    return losses, (tp, ts), (jp, js)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "hymba_1_5b", "xlstm_1_3b"])
def test_three_steps_equal_repro(arch):
    losses, (tp, ts), (jp, js) = run_both(arch, 1, 3)
    np.testing.assert_allclose(*losses[0], rtol=1e-5)
    for got, want in losses[1:]:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_params_close(tp, jp, 3)
    assert_params_close(ts["m"], js["m"], 3)
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("arch", ["gemma_2b"] + MOE)
def test_grad_accum_equals_repro_s_grad_accum(arch):
    """Two microbatches against ``repro``'s two (MoE capacity depends on
    the token count, so each package's microbatch drops its own tokens —
    the same ones)."""
    losses, (tp, _), (jp, _) = run_both(arch, 2, 2, rows=4)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert_params_close(tp, jp, 2)


# ---------------------------------------------------------------------------
# repro's own train tests, through the port (tests/test_arch_smoke.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(arch):
    cfg = get_config(arch, smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu").tree()
    hp = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = TS.make_train_step(cfg, hp, jit=True, device="cpu")
    dc = TD.DataConfig(seq_len=16, global_batch=2, seed=0)
    opt_state = TO.init(params)
    loss1, params, opt_state = step(params, opt_state,
                                    TD.make_batch(cfg, dc, 0))
    loss2, params, opt_state = step(params, opt_state,
                                    TD.make_batch(cfg, dc, 1))
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss1) > 0
    assert all(bool(torch.isfinite(p).all()) for p in TM.leaves(params))


def test_loss_decreases_tiny_model():
    cfg = get_config("qwen3_0_6b", smoke=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu").tree()
    hp = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60)
    step = TS.make_train_step(cfg, hp, jit=True, device="cpu")
    dc = TD.DataConfig(seq_len=32, global_batch=4, seed=0)
    opt_state = TO.init(params)
    losses = []
    for i in range(30):
        loss, params, opt_state = step(params, opt_state,
                                       TD.make_batch(cfg, dc, i))
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_grad_accum_equivalence():
    cfg = get_config("gemma_2b", smoke=True)
    init = TM.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").tree()
    hp = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dc = TD.DataConfig(seq_len=16, global_batch=4, seed=3)
    b = TD.make_batch(cfg, dc, 0)
    s1 = TS.make_train_step(cfg, hp, grad_accum=1, device="cpu")
    s2 = TS.make_train_step(cfg, hp, grad_accum=2, device="cpu")
    p1 = interop.lm_params(flat_tree(init), cfg, "cpu")
    p2 = interop.lm_params(flat_tree(init), cfg, "cpu")
    l1, p1, _ = s1(p1, TO.init(p1), b)
    l2, p2, _ = s2(p2, TO.init(p2), b)
    assert abs(float(l1) - float(l2)) < 5e-2
    d = [float((a - c).abs().max().detach())
         for a, c in zip(TM.leaves(p1), TM.leaves(p2))]
    assert max(d) < 5e-2


def flat_tree(tree):
    """The port's tree as ``repro``'s stacked NumPy tree."""
    from repro_torch.tree import STACKED, stack
    return {k: (stack(v, STACKED[k], lambda t: t.detach().numpy())
                if k in STACKED else
                jax.tree.map(lambda t: t.detach().numpy(), v))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# data (tests/test_distributed.py::TestData, and the batches of both)
# ---------------------------------------------------------------------------

class TestData:
    def test_determinism(self):
        cfg = get_config("qwen3_0_6b", smoke=True)
        dc = TD.DataConfig(seq_len=32, global_batch=4, seed=9)
        a = TD.make_batch(cfg, dc, 5)
        b = TD.make_batch(cfg, dc, 5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_host_slices_partition(self):
        cfg = get_config("qwen3_0_6b", smoke=True)
        dc = TD.DataConfig(seq_len=8, global_batch=8, seed=2)
        full = TD.make_batch(cfg, dc, 3)
        parts = [TD.make_batch(cfg, dc, 3, rows=TD.host_slice(dc, h, 4))
                 for h in range(4)]
        stitched = np.concatenate([p["tokens"] for p in parts])
        np.testing.assert_array_equal(stitched, full["tokens"])

    def test_labels_shifted(self):
        cfg = get_config("qwen3_0_6b", smoke=True)
        dc = TD.DataConfig(seq_len=16, global_batch=1, seed=0)
        b = TD.make_batch(cfg, dc, 0)
        np.testing.assert_array_equal(b["tokens"][0, 1:],
                                      b["labels"][0, :-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_repro(arch):
    """Every array of every batch (``patches`` for vlm, ``frames`` for
    audio), ``host_slice`` rows and the ``batches`` iterator."""
    jc, tc = configs(arch)
    dc = dict(seq_len=24, global_batch=4, seed=5)
    for step in (0, 3):
        want = JD.make_batch(jc, JD.DataConfig(**dc), step)
        got = TD.make_batch(tc, TD.DataConfig(**dc), step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    rows = TD.host_slice(TD.DataConfig(**dc), 1, 2)
    assert rows == JD.host_slice(JD.DataConfig(**dc), 1, 2)
    it_j = JD.batches(jc, JD.DataConfig(**dc), start_step=2, rows=rows)
    it_t = TD.batches(tc, TD.DataConfig(**dc), start_step=2, rows=rows)
    for _ in range(2):
        a, b = next(it_j), next(it_t)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
