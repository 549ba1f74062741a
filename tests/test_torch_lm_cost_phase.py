"""``chip_smoke.py``'s phase 17 (the LM cost tooling and the LM on a mesh)
on the CPU: ``tools/lm_cost_pins.py``'s calls through both packages, the
port against the committed pins (``tools/lm_cost_pins.json``) exactly,
the traces part at 4,096 lines, and the ``lm_sharded`` parts on a
one-rank gloo group's ``(1, 1)`` mesh at smoke size (qwen3-smoke in
place of the published qwen3-0.6b; the pinned part held to ``repro``'s
loss and grad norm computed here)."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as smoke  # noqa: E402
import lm_cost_pins  # noqa: E402
from test_torch_lm_train import one_thread  # noqa: E402,F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pins():
    return smoke.lm_cost_load_pins()


def test_port_meets_the_committed_cost_pins(pins):
    runs = smoke.lm_cost_runs(smoke.lm_cost_port_api(CPU))
    got = smoke.lm_cost_check(runs, pins)
    assert got["rows"] == len(pins["rows"]) == 32
    assert pins["fractions"].keys() == {"stream", "gather", "kv_page",
                                        "alltoall"}


def test_repro_runs_meet_the_committed_pins(pins):
    """``tools/lm_cost_pins.py``'s calls through ``repro`` give the
    committed pins (stale pins would fail here)."""
    fresh = smoke.lm_cost_runs(lm_cost_pins.repro_api())
    assert json.loads(json.dumps(fresh)) == pins


def test_cost_check_refuses_a_changed_row(pins):
    runs = json.loads(json.dumps(pins))
    runs["rows"][3]["compute_s"] *= 1 + 1e-15
    with pytest.raises(AssertionError):
        smoke.lm_cost_check(runs, pins)


def test_traces_part_on_the_cpu(monkeypatch):
    """The traces part at 4,096 lines: every field equal to the host
    oracle's on the CPU route, and the kernel timing's calls (its CUDA
    events replaced by a plain call)."""
    out = smoke.lm_cost_traces(CPU, n_lines=4096)
    assert set(out) == {"stream", "gather", "kv_page", "alltoall"}
    for t in out.values():
        assert t["requests"] == 4096 and t["shape"][0] == 16
        assert t["bound_ms"] > 0
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps: (fn(), 0.0)[1])
    assert set(smoke.lm_cost_kernel_ms(CPU, n_lines=4096)) == set(out)


def repro_pinned(arch, batch):
    """``repro``'s loss and global grad norm of ``arch``'s smoke config in
    float32 on the phase's NumPy weights and ``batch``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_config
    from repro.train import optimizer as JO
    from repro.train import step as JS
    jcfg = dataclasses.replace(j_config(arch, smoke=True), dtype="float32")
    tree = smoke.lm_numpy_params(jcfg, np.random.default_rng(smoke.LM_SEED))
    loss, grads = jax.jit(jax.value_and_grad(JS.lm_loss), static_argnums=2)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    return float(loss), float(JO.global_norm(grads))


def test_sharded_parts_rehearsed_on_the_cpu():
    from repro_torch.train import data as D
    full = get_config("qwen3_0_6b", smoke=True)
    pinned_cfg = dataclasses.replace(full, dtype="float32")
    b = D.make_batch(pinned_cfg, D.DataConfig(
        **smoke.LM_TRAIN_PINNED_DATA), 0)
    batch = {k: np.asarray(b[k], np.int32) for k in ("tokens", "labels")}
    loss, norm = repro_pinned("qwen3_0_6b", batch)
    lines = []
    out = smoke.lm_sharded_parts(
        CPU, full, pinned_cfg, {"batch": batch, "loss": loss,
                                "grad_norm": norm}, get_config,
        lambda part, **kw: lines.append((part, kw)))
    assert [p for p, _ in lines] == ["step", "pinned", "serve", "ep"]
    assert out["step"]["loss_rel"] <= smoke.LM_SHARDED_LOSS_TOL
    assert out["step"]["grad_leaf_rel"] <= smoke.LM_SHARDED_GRAD_TOL
    assert lines[0][1]["mesh"] == {"data": 1, "model": 1}
    assert out["pinned"]["loss_rel_to_pin"] < smoke.LM_TRAIN_LOSS_TOL[0]
    assert out["serve"]["tokens_equal"]
    assert len(out["serve"]["tokens"][0]) == smoke.LM_SHARDED_NEW
    assert set(out["ep"]["max_abs"]) == {"a2a", "psum"}
    import torch.distributed as dist
    assert not dist.is_initialized()
