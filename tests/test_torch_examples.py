"""The port's four examples (``examples/torch_*.py``) against ``repro``'s.

Each example's ``main`` runs with ``--device cpu`` at a small size.  The
graph examples' reports (what they print: runtime, iterations, REPS,
row-hit rate, per-phase requests and hits) equal ``repro``'s ``simulate``
/ ``sweep`` on the same graph; the LM examples' tokens and losses equal
``repro``'s at the SMOKE config with ``repro``'s weights carried across
(``interop.lm_params``): the tokens equal, the losses within
``test_torch_lm_train.py``'s bf16 tolerance (the SMOKE config computes in
bf16).
With no card and no ``--device cpu`` each example raises.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core import analytical as r_analytical
from repro.graphs.generators import rmat as r_rmat
from repro.models import lm_engine as JE
from repro.models import model as JM
from repro.sim import SimSession as RSimSession
from repro.sim import SweepCase as RSweepCase
from repro.sim import Sweeper as RSweeper
from repro.sim import get_accelerator as r_get_accelerator
from repro.sim import sweep as r_sweep
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train.step import make_train_step as j_make_train_step

from repro_torch import interop
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_graph_accelerator_study",
            "torch_serve_lm", "torch_train_lm")
SCALE = 8


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def example(name):
    return _load(ROOT / "examples" / f"{name}.py")


@functools.lru_cache(maxsize=None)
def pins_tool():
    return _load(ROOT / "tools" / "example_pins.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as ``test_torch_lm_train.py`` runs: the suite
    runs several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_report(got, want):
    """The fields the examples print, and every phase's requests and hits,
    equal."""
    assert got.runtime_ns == want.runtime_ns
    assert got.runtime_ms == want.runtime_ms
    assert got.iterations == want.iterations
    assert got.reps == want.reps and got.teps == want.teps
    assert got.row_hit_rate == want.row_hit_rate
    assert got.total_requests == want.total_requests
    assert got.cache_hit_rate == want.cache_hit_rate
    assert [(p.name, p.requests, p.row_hits, p.row_conflicts,
             p.start_cycle, p.end_cycle) for p in got.phases] == \
        [(p.name, p.requests, p.row_hits, p.row_conflicts, p.start_cycle,
          p.end_cycle) for p in want.phases]


def test_quickstart_equals_repro(capsys):
    got = example("torch_quickstart").main(["--device", "cpu", "--scale",
                                            str(SCALE)])
    printed = capsys.readouterr().out
    want = pins_tool().repro_quickstart(SCALE)
    for acc in ("hitgraph", "accugraph"):
        _same_report(got[acc], want[acc])
        assert f"{got[acc].runtime_ms:8.3f} ms" in printed
    assert [r.variant for r in got["variants"]] == \
        [r.variant for r in want["variants"]] == [
            "baseline", "prefetch_skip", "partition_skip", "both"]
    for g, w in zip(got["variants"], want["variants"]):
        _same_report(g.report, w.report)
    for backend in ("vectorized", "event"):
        _same_report(got["cross_check"][backend],
                     want["cross_check"][backend])
    assert got["cross_check"]["event"].runtime_ns == \
        got["cross_check"]["vectorized"].runtime_ns
    assert "per-phase DRAM statistics" in printed


def test_graph_accelerator_study_equals_repro(capsys):
    got = example("torch_graph_accelerator_study").main(
        ["--device", "cpu", "--scale", str(SCALE)])
    assert "on-chip cache hierarchy" in capsys.readouterr().out
    g = r_rmat(SCALE, 16, seed=1).undirected_view()
    spec = r_get_accelerator("accugraph")
    sweeper = RSweeper()
    qs = (1024, 2048, 4096, g.n)
    rows = r_sweep(cases=[RSweepCase(
        graph=g, problem="wcc", accelerator="accugraph",
        config=spec.make_config(partition_elements=q)) for q in qs],
        sweeper=sweeper)
    assert [q for q, _, _ in got["partitions"]] == list(qs)
    for (_, row, est), want in zip(got["partitions"], rows):
        _same_report(row.report, want.report)
        west = r_analytical.estimate_accugraph(
            g, want.case.problem, want.case.config,
            iterations=want.report.iterations)
        assert (est.runtime_ns, est.bound) == (west.runtime_ns, west.bound)
    rows = r_sweep(cases=[RSweepCase(
        graph=g, problem="wcc", accelerator="accugraph",
        config=spec.make_config(edge_pipelines=ep)) for ep in (8, 16, 32)],
        sweeper=sweeper)
    for row, want in zip(got["pipelines"], rows):
        _same_report(row.report, want.report)
    session = RSimSession(g)
    for name, memory in (("ddr4", None), ("hbm2-interleaved", "hbm2")):
        _same_report(got["memories"][name],
                     session.run("wcc", "accugraph", edge_pipelines=64,
                                 memory=memory))
    for cache in (None, "vertex-64k", "vertex-256k", "vertex-1m",
                  "default"):
        _same_report(got["caches"][cache or "no-cache"],
                     session.run("wcc", "accugraph", cache=cache))


@functools.lru_cache(maxsize=None)
def smoke_weights():
    """``repro``'s qwen3-0.6b SMOKE weights (key 0) as NumPy."""
    cfg = j_config("qwen3_0_6b", smoke=True)
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def test_serve_lm_equals_repro():
    serve = example("torch_serve_lm")
    assert serve.main(["--device", "cpu"]).shape == (3, 16)
    jc = j_config("qwen3_0_6b", smoke=True)
    tc = get_config("qwen3_0_6b", smoke=True)
    tree = smoke_weights()
    got = serve.serve(interop.lm_params(tree, tc, "cpu"), tc, "cpu",
                      out=lambda line: None)
    reqs = [JE.Request(r.prompt, max_new_tokens=r.max_new_tokens)
            for r in serve.requests_for(tc)]
    want = JE.generate(jax.tree.map(jnp.asarray, tree), jc, reqs)
    assert got.shape == (3, 16) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_train_lm_equals_repro(tmp_path):
    train = example("torch_train_lm")
    steps, seq, batch = 3, 16, 2
    losses = train.main(["--smoke", "--device", "cpu", "--steps", str(steps),
                         "--seq-len", str(seq), "--batch", str(batch),
                         "--ckpt-dir", str(tmp_path / "own")])
    assert len(losses) == steps and all(np.isfinite(losses))
    tc = train.config(smoke=True)
    tree = smoke_weights()
    got = train.train(tc, steps, str(tmp_path / "carried"), seq, batch,
                      device="cpu",
                      init=lambda: interop.lm_params(tree, tc, "cpu"),
                      out=lambda line: None)
    jc = j_config("qwen3_0_6b", smoke=True)
    hp = JO.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    step = jax.jit(j_make_train_step(jc, hp, 1, jit=False))
    params = jax.tree.map(jnp.asarray, tree)
    state = JO.init(params)
    dc = JD.DataConfig(seq_len=seq, global_batch=batch)
    want = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in JD.make_batch(jc, dc, i).items()}
        loss, params, state = step(params, state, b)
        want.append(float(loss))
    # the SMOKE config computes in bf16: test_torch_lm_train.py's bf16
    # loss tolerance
    assert tc.dtype == jc.dtype == "bfloat16"
    np.testing.assert_allclose(got, want, rtol=2e-2)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_a_card(name, tmp_path, monkeypatch):
    """No fallback: with no CUDA device and no ``--device cpu`` the
    example raises before it runs anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt-dir", str(tmp_path)] if name == "torch_train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main(argv)
