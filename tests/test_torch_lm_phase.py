"""``chip_smoke.py``'s phase 15 (the LM serve path) on the CPU, at cut
size: ``tools/lm_pins.py``'s calls through both packages, the NumPy
weights against ``repro``'s tree, the port against the committed pins
(``tools/lm_pins.json``), and the serve part's control flow with the
card's calls stubbed."""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import model as JM

from repro_torch import interop
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm_engine as TE
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as smoke  # noqa: E402
import lm_pins  # noqa: E402


def port_params(tree, cfg):
    return interop.lm_params(tree, cfg, "cpu")


def shapes(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype))}


@pytest.fixture(scope="module")
def pins():
    return smoke.lm_load_pins()


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_params_are_repro_s_tree(arch):
    """``lm_numpy_params`` makes ``init_params``'s names, shapes and
    dtypes (``jax.eval_shape``), and draws ``repro``'s scales."""
    cfg = j_config(arch, smoke=True)
    want = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                          jax.random.PRNGKey(0))
    got = smoke.lm_numpy_params(cfg, np.random.default_rng(0))
    assert shapes(got) == shapes(want)
    assert abs(float(got["embed"].std()) - 0.02) < 2e-3
    again = smoke.lm_numpy_params(cfg, np.random.default_rng(0))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(again)))


def test_pinned_config_is_qwen3_at_full_width():
    cfg = smoke.lm_pinned_config(get_config)
    published = get_config(smoke.LM_ARCH)
    assert dataclasses.replace(cfg, n_layers=published.n_layers,
                               dtype=published.dtype) == published
    assert (cfg.d_model, cfg.vocab, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (
        1024, 151936, 16, 8, 128)
    assert (cfg.n_layers, cfg.dtype) == (smoke.LM_PINNED_LAYERS, "float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        smoke.lm_pinned_config(j_config))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_meets_the_committed_family_pins(arch, pins):
    """What the phase holds the card to, run on the CPU."""
    runs = smoke.lm_family_runs(TM, TE, get_config, port_params, arch,
                                device="cpu")
    got = smoke.lm_check_family(arch, runs, pins["families"][arch])
    assert got["max_abs_err"] < smoke.LM_FAMILY_TOL
    assert got["tokens_held"] >= len(smoke.LM_FAMILY_PROMPTS)
    assert ("long" in runs) == (arch in smoke.LM_LONG)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "xlstm_1_3b", "hymba_1_5b"])
def test_repro_runs_meet_the_committed_pins(arch, pins):
    """``tools/lm_pins.py``'s calls through ``repro`` give the committed
    pins (stale pins would fail here), and the port's runs equal
    ``repro``'s."""
    M, E, j_get, _, to_params = lm_pins.repro_api()
    runs = smoke.lm_family_runs(M, E, j_get, to_params, arch)
    fresh = smoke.lm_family_pin(runs)
    smoke.lm_check_family(arch, runs, pins["families"][arch])
    assert fresh["tokens"] == pins["families"][arch]["tokens"]
    port = smoke.lm_family_runs(TM, TE, get_config, port_params, arch,
                                device="cpu")
    smoke.lm_check_family(arch, port, fresh)


def test_pinned_runs_through_both_packages_at_cut_size():
    """The pinned part's calls on qwen3-smoke (float32) through both
    packages, held as the phase holds the full-width run."""
    M, E, j_get, _, to_params = lm_pins.repro_api()
    j_cfg = dataclasses.replace(j_get("qwen3_0_6b", smoke=True),
                                dtype="float32")
    t_cfg = dataclasses.replace(get_config("qwen3_0_6b", smoke=True),
                                dtype="float32")
    want = smoke.lm_pinned_pin(smoke.lm_pinned_runs(M, E, j_cfg, to_params))
    got = smoke.lm_pinned_runs(TM, TE, t_cfg, port_params, device="cpu")
    assert smoke.lm_value_err(got["prefill_last"], want["prefill_top"],
                              smoke.LM_PINNED_TOL) < 1e-5
    held = smoke.lm_tokens_held(got["tokens"], want["tokens"],
                                want["margins"], smoke.LM_MARGIN_FLOOR)
    assert 2 <= held <= got["tokens"].size
    assert np.shape(want["prefill_top"]["ids"]) == (
        len(smoke.LM_PINNED_PROMPTS), smoke.LM_PINNED_TOP)


def test_committed_pins_have_the_phase_s_shapes(pins):
    p = pins["pinned"]
    n = len(smoke.LM_PINNED_PROMPTS)
    assert np.shape(p["prefill_top"]["ids"]) == (n, smoke.LM_PINNED_TOP)
    assert np.shape(p["tokens"]) == np.shape(p["margins"]) == (
        n, smoke.LM_PINNED_NEW)
    assert set(pins["families"]) == set(ARCHS)
    B, S = smoke.LM_FAMILY_SHAPE
    for arch, f in pins["families"].items():
        assert np.shape(f["forward"]["ids"]) == (B, S, smoke.LM_FAMILY_TOP)
        assert np.shape(f["decode"]["ids"]) == (
            smoke.LM_FAMILY_DECODE + 1, B, 1, smoke.LM_FAMILY_TOP)
        assert np.shape(f["tokens"]) == (len(smoke.LM_FAMILY_PROMPTS),
                                         smoke.LM_FAMILY_NEW)


def test_tokens_are_held_up_to_the_first_close_step():
    pinned = [[1, 2, 3, 4], [5, 6, 7, 8]]
    margins = [[1.0, 1e-3, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]]
    got = np.array([[1, 2, 9, 9], [5, 6, 7, 8]])
    assert smoke.lm_tokens_held(got, pinned, margins, 1e-2) == 2 + 4
    with pytest.raises(AssertionError):
        smoke.lm_tokens_held(np.array([[1, 9, 9, 9], [5, 6, 7, 8]]), pinned,
                             margins, 1e-2)


def test_serve_part_rehearsed_on_the_cpu(monkeypatch, capsys):
    """``lm_serve``'s calls and checks at qwen3-smoke's size on the CPU:
    the card's synchronise and memory counters stubbed, the on-card
    check counting tensors only, 2 requests, a 256-token long prefill."""
    small = dataclasses.replace(get_config("qwen3_0_6b", smoke=True),
                                name="qwen3-0.6b")
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda arch, smoke=False: small)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "lm_on_card", lambda *objs: sum(
        1 for o in objs for _ in smoke.lm_tensors(o)))
    monkeypatch.setattr(smoke, "LM_SERVE_PROMPTS", (16, 24))
    monkeypatch.setattr(smoke, "LM_SERVE_NEW", 6)
    monkeypatch.setattr(smoke, "LM_LONG_PREFILL", 256)
    line = smoke.lm_serve("cpu card", torch.device("cpu"))
    assert line["chunked_route_calls"] == small.n_layers
    assert line["requests"] == 2 and line["new_tokens"] == 6
    assert line["decode_vs_forward_max_abs"] < smoke.LM_SERVE_TOL
    assert '"phase": "lm_serve"' in capsys.readouterr().out
