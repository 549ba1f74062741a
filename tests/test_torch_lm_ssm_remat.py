"""Mamba's and mLSTM's chunk bodies rematerialized, as ``repro`` wraps
them in ``jax.checkpoint`` (``src/repro/models/ssm.py``).

* The chunk loops (``_selective_scan_chunked``, ``_mlstm_chunks``) at the
  smoke configs' widths, over 2 and 4 chunks: the tensors autograd saves
  (hooked with ``saved_tensors_hooks``, one count a storage) are the
  loop's inputs and, from the second chunk on, each chunk's carry, and
  nothing else; with the checkpoint taken out they hold every chunk's
  ``(B, c, Di, N)`` / ``(B, c, c, H)`` intermediates.
* A mamba and an mLSTM layer: no saved tensor has a chunk intermediate's
  shape, and the saved bytes grow by the same amount with each chunk.
* xlstm-smoke and hymba-smoke at 4 chunks (``CHUNK`` 4, 16 tokens),
  float32: the loss and every gradient equal the plain loop's (the chunk
  bodies unwrapped) bit for bit, and ``repro``'s (its ``CHUNK`` cut the
  same) within ``test_torch_lm_train.py``'s float32 tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.train import step as JST

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import _flatten
from repro_torch.models import ssm as TS
from repro_torch.train import data as TD
from repro_torch.train import step as TST

B, C = 2, 8
F32 = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def plain(monkeypatch):
    """The chunk bodies unwrapped: ``scan`` runs them as a plain loop."""
    monkeypatch.setattr(TS, "remat", lambda step: step)


def saved(fn, inputs=()):
    """``fn()``'s saved tensors, one a storage other than the inputs':
    ``{storage pointer: (bytes, shape)}``."""
    out = {}

    def pack(t):
        s = t.untyped_storage()
        out.setdefault(s.data_ptr(), (s.nbytes(), tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        result = fn()
    for t in inputs:
        out.pop(t.untyped_storage().data_ptr(), None)
    del result
    return out


def leaf(rng, *shape, scale=1.0, positive=False):
    a = rng.standard_normal(shape) * scale
    return torch.tensor(np.abs(a) if positive else a,
                        dtype=torch.float32, requires_grad=True)


def mamba_loop(rng, n):
    cfg = get_config("hymba_1_5b", smoke=True)
    di, N = cfg.d_inner, cfg.ssm_state
    S = n * C
    ins = (leaf(rng, B, S, di), leaf(rng, B, S, di, scale=0.1,
                                     positive=True),
           leaf(rng, B, S, N), leaf(rng, B, S, N), leaf(rng, di, N),
           leaf(rng, B, di, N))
    carry = [(B, di, N)]
    # exp(a_log), computed once outside the loop, and a carry a chunk
    kept = [(di, N)] + carry * (n - 1)
    return (lambda: TS._selective_scan_chunked(*ins), ins, kept,
            (B, C, di, N))


def mlstm_loop(rng, n):
    cfg = get_config("xlstm_1_3b", smoke=True)
    H = cfg.n_heads
    dh = cfg.d_model * max(cfg.ssm_expand, 1) // H
    S = n * C
    ins = (leaf(rng, B, S, H, dh), leaf(rng, B, S, H, dh),
           leaf(rng, B, S, H, dh), leaf(rng, B, S, H),
           leaf(rng, B, S, H, scale=0.1), leaf(rng, B, H, dh, dh),
           leaf(rng, B, H, dh))
    kept = [(B, H, dh, dh), (B, H, dh)] * (n - 1)
    return (lambda: TS._mlstm_chunks(*ins, C, torch.float32), ins, kept,
            (B, C, C, H))


LOOPS = {"mamba": mamba_loop, "mlstm": mlstm_loop}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("block", sorted(LOOPS))
def test_chunk_loop_saves_only_its_inputs_and_carries(monkeypatch, block,
                                                      n):
    monkeypatch.setattr(TS, "CHUNK", C)
    fn, ins, kept, inner = LOOPS[block](np.random.default_rng(n), n)
    got = saved(fn, ins)
    assert sorted(s for _, s in got.values()) == sorted(kept)
    plain(monkeypatch)
    shapes = [s for _, s in saved(fn, ins).values()]
    assert inner in shapes


def layer(arch, n, seed=0):
    """One mamba (hymba) or mLSTM (xlstm) layer's forward over ``n``
    chunks, and the shape of its chunk intermediate."""
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(seed)
    x = torch.tensor(np.random.default_rng(seed).standard_normal(
        (B, n * C, cfg.d_model)), dtype=torch.float32)
    if arch == "hymba_1_5b":
        p = TS.init_mamba(gen, cfg, torch.float32, "cpu")
        fn, inner = TS.mamba, (B, C, cfg.d_inner, cfg.ssm_state)
    else:
        p = TS.init_mlstm(gen, cfg, torch.float32, "cpu")
        fn, inner = TS.mlstm, (B, C, C, cfg.n_heads)
    for v in p.values():
        v.requires_grad_(True)
    return lambda: fn(x, p, cfg)[0], inner


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b"])
def test_layer_saves_no_chunk_intermediate(monkeypatch, arch):
    monkeypatch.setattr(TS, "CHUNK", C)
    total = {}
    for n in (2, 3, 4):
        fn, inner = layer(arch, n)
        got = saved(fn)
        assert inner not in [s for _, s in got.values()]
        total[n] = sum(b for b, _ in got.values())
    # the same bytes more for each chunk: its inputs and its carry
    assert total[4] - total[3] == total[3] - total[2] > 0
    plain(monkeypatch)
    fn, inner = layer(arch, 4)
    assert sum(b for b, _ in saved(fn).values()) > total[4]


def configs(arch):
    return (dataclasses.replace(j_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def weights(arch):
    params = JM.init_params(jax.random.PRNGKey(0), j_config(arch, smoke=True))
    return jax.tree.map(np.asarray, params)


def batch(cfg):
    return TD.make_batch(cfg, TD.DataConfig(seq_len=16, global_batch=2,
                                            seed=0), 0)


def flat(tree):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in _flatten(tree).items()}


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b"])
def test_grads_equal_the_plain_loop_and_repro(monkeypatch, arch):
    """4 chunks of 4 tokens: the port with its chunk bodies checkpointed
    equals them unwrapped bit for bit, and ``repro`` within float32's
    tolerances."""
    monkeypatch.setattr(TS, "CHUNK", 4)
    monkeypatch.setattr(JSSM, "CHUNK", 4)
    jc, tc = configs(arch)
    w = weights(arch)
    b = batch(tc)
    loss, grads = TST.loss_and_grads(interop.lm_params(w, tc, "cpu"), b, tc,
                                     device="cpu")
    with monkeypatch.context() as m:
        plain(m)
        p_loss, p_grads = TST.loss_and_grads(interop.lm_params(w, tc, "cpu"),
                                             b, tc, device="cpu")
    assert torch.equal(loss, p_loss)
    got, unwrapped = flat(grads), flat(p_grads)
    for k in got:
        assert np.array_equal(got[k], unwrapped[k]), k
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(JST.lm_loss),
                              static_argnums=2)(
        jax.tree.map(jnp.asarray, w), jb, jc)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    want = flat(j_grads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)
