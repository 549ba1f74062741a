"""``chip_smoke.py``'s phase 16 (LM training) on the CPU, at cut size:
``tools/lm_train_pins.py``'s calls through both packages, the port
against the committed pins (``tools/lm_train_pins.json``), the checks'
own logic, and the full and resume parts' control flow with the card's
calls stubbed."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke as smoke  # noqa: E402
import lm_train_pins  # noqa: E402
from test_torch_lm_train import one_thread  # noqa: E402,F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pins():
    return smoke.lm_train_load_pins()


@pytest.fixture(scope="module")
def repro_api():
    return lm_train_pins.repro_api(smoke)


def port_api():
    return smoke.lm_train_port_api(CPU)


def family_runs(api, get, arch):
    return smoke.lm_train_runs(api, smoke.lm_train_family_config(get, arch),
                               smoke.LM_TRAIN_FAMILY_DATA,
                               smoke.LM_TRAIN_FAMILY_STEPS,
                               smoke.lm_train_family_accums(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_meets_the_committed_family_pins(arch, pins):
    """What the phase holds the card to, run on the CPU; the port's
    batches are the pins' (``repro``'s, on the same NumPy)."""
    runs = family_runs(port_api(), get_config, arch)
    got = smoke.lm_train_check(runs, pins["families"][arch])
    assert got["loss_max_rel"] < smoke.LM_TRAIN_LOSS_TOL[1]
    assert got["accums"] == list(smoke.lm_train_family_accums(arch))
    assert got["noise_leaves"] == (
        ["blocks/moe/router"] if arch == "llama4_scout_17b_a16e" else [])


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "llama4_scout_17b_a16e",
                                  "xlstm_1_3b"])
def test_repro_runs_meet_the_committed_pins(arch, pins, repro_api):
    """``tools/lm_train_pins.py``'s calls through ``repro`` give the
    committed pins (stale pins would fail here)."""
    from repro.configs import get_config as j_config
    fresh = smoke.lm_train_pin(family_runs(repro_api, j_config, arch))
    assert fresh == pins["families"][arch]


def test_pinned_runs_through_both_packages_at_cut_size(repro_api):
    """The pinned part's calls (3 steps, and 3 with ``grad_accum=2``, on
    2 x 64 tokens) on qwen3-smoke in float32 through both packages, held
    as the phase holds the full-width run."""
    from repro.configs import get_config as j_config
    small = lambda get: dataclasses.replace(get("qwen3_0_6b", smoke=True),
                                            dtype="float32")
    want = smoke.lm_train_pin(smoke.lm_train_runs(
        repro_api, small(j_config), smoke.LM_TRAIN_PINNED_DATA,
        smoke.LM_TRAIN_PINNED_STEPS, (1, 2)))
    got = smoke.lm_train_runs(port_api(), small(get_config),
                              smoke.LM_TRAIN_PINNED_DATA,
                              smoke.LM_TRAIN_PINNED_STEPS, (1, 2))
    out = smoke.lm_train_check(got, want)
    assert out["accums"] == [1, 2] and out["sample_over_tol"] == 0


def test_committed_pins_have_the_phase_s_shapes(pins):
    assert set(pins["families"]) == set(ARCHS)
    p = pins["pinned"]
    assert set(p) == {"loss", "grad_norm", "leaf_norms", "lr", "batches",
                      "accum_1", "accum_2"}
    assert len(p["lr"]) == smoke.LM_TRAIN_PINNED_STEPS
    data = smoke.LM_TRAIN_PINNED_DATA
    assert [np.shape(b["tokens"]) for b in p["batches"]] == [
        (data["global_batch"], data["seq_len"])] * len(p["lr"])
    for ga in (1, 2):
        assert len(p[f"accum_{ga}"]["losses"]) == smoke.LM_TRAIN_PINNED_STEPS
    # qwen3-0.6b at full width: the embedding alone is 151,936 x 1,024
    assert set(p["leaf_norms"]) >= {"embed", "final_norm", "blocks/attn/wq"}
    # the leading elements and the spaced ones share element 0
    n = smoke.LM_TRAIN_SAMPLE
    assert len(p["accum_1"]["sample"]["embed"]) == 2 * n - 1
    for arch, f in pins["families"].items():
        accums = smoke.lm_train_family_accums(arch)
        assert sorted(k for k in f if k.startswith("accum_")) == [
            f"accum_{ga}" for ga in accums]
        assert f["loss"] == f["accum_1"]["losses"][0]


def _pin():
    return {"loss": 2.0, "grad_norm": 1.0,
            "leaf_norms": {"a": 0.5, "z": 1e-9}, "lr": [1e-3],
            "accum_1": {"losses": [2.0],
                        "sample": {"a": [0.0] * 2000, "z": [0.0] * 10}}}


def _runs(pin, **change):
    runs = {**pin, "grads_finite": True, "batches": [],
            "accum_1": {"losses": pin["accum_1"]["losses"],
                        "sample": {k: list(v) for k, v in
                                   pin["accum_1"]["sample"].items()}}}
    for k, v in change.items():
        runs[k] = v
    return runs


def test_check_holds_losses_norms_and_samples():
    pin = _pin()
    smoke.lm_train_check(_runs(pin), pin)
    with pytest.raises(AssertionError):
        smoke.lm_train_check(_runs(pin, loss=2.0 * (1 + 2e-5)), pin)
    with pytest.raises(AssertionError):
        smoke.lm_train_check(_runs(pin, grad_norm=1.0 + 2e-4), pin)
    with pytest.raises(AssertionError):
        smoke.lm_train_check(_runs(pin, grads_finite=False), pin)
    with pytest.raises(AssertionError):
        smoke.lm_train_check(_runs(pin, lr=[1.1e-3]), pin)


def test_check_allows_a_few_sign_flips_and_noise_leaves():
    """Two of 2,000 held elements may move by 2 lr (0.1 %), three may
    not; a noise leaf ("z", gradient norm 1e-9 of the global) is held to
    3 lr only; nothing may pass 3 lr."""
    pin = _pin()
    runs = _runs(pin)
    runs["accum_1"]["sample"]["a"][:2] = [2e-3, -2e-3]
    runs["accum_1"]["sample"]["z"][:] = [2e-3] * 10
    out = smoke.lm_train_check(runs, pin)
    assert (out["sample_over_tol"], out["sample_elements"]) == (2, 2000)
    assert out["noise_leaves"] == ["z"]
    runs["accum_1"]["sample"]["a"][2] = 2e-3
    with pytest.raises(AssertionError):
        smoke.lm_train_check(runs, pin)
    runs = _runs(pin)
    runs["accum_1"]["sample"]["z"][0] = 3.1e-3
    with pytest.raises(AssertionError):
        smoke.lm_train_check(runs, pin)


def test_sample_takes_leading_and_spaced_elements():
    n = smoke.LM_TRAIN_SAMPLE
    out = smoke.lm_train_sample({"w": np.arange(1000, dtype=np.float32),
                                 "b": np.arange(5, dtype=np.float32)})
    assert out["b"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert out["w"][:n] == list(range(n)) and out["w"][-1] == 999.0
    assert len(out["w"]) == len(set(out["w"])) <= 2 * n


@pytest.fixture
def cpu_card(monkeypatch):
    """The card's calls stubbed, qwen3-smoke standing in for qwen3-0.6b."""
    small = dataclasses.replace(get_config("qwen3_0_6b", smoke=True),
                                name="qwen3-0.6b")
    monkeypatch.setattr("repro_torch.configs.get_config",
                        lambda arch, smoke=False: small)
    monkeypatch.setattr("repro_torch.launch.train.get_config",
                        lambda arch, smoke=False: small)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "lm_on_card", lambda *objs: sum(
        1 for o in objs for _ in smoke.lm_tensors(o)))
    monkeypatch.setattr(smoke, "device_busy", lambda fn: (fn(), None, 0))
    monkeypatch.setattr(smoke, "device_top", lambda fn: fn() and [])
    monkeypatch.setattr(smoke, "LM_TRAIN_FULL_DATA",
                        {"seq_len": 32, "global_batch": 4})
    monkeypatch.setattr(smoke, "LM_TRAIN_FULL_STEPS", 6)
    monkeypatch.setattr(smoke, "LM_TRAIN_ACCUM_STEPS", 3)
    monkeypatch.setattr(smoke, "LM_TRAIN_MIN_DROP", 0.2)
    monkeypatch.setattr(smoke, "LM_TRAIN_RESUME_DATA",
                        {"seq_len": 16, "global_batch": 2, "seed": 0})
    return small


def test_full_part_rehearsed_on_the_cpu(cpu_card, capsys):
    """``train_full``'s calls through ``launch.train.main`` at
    qwen3-smoke's size: the steps timed, the losses falling, no
    checkpoint left behind, the remat-off step."""
    line = smoke.lm_train_full("cpu card", CPU)
    assert len(line["full_losses"]) == 6 and len(line["accum_losses"]) == 3
    assert len(line["full_step_ms_all"]) == 6
    assert line["loss_drop"] >= 0.2
    assert line["loss_first"] == line["accum_losses"][0]
    assert abs(line["no_remat_loss"] - line["loss_first"]) < 1e-5
    assert line["tokens_per_step"] == 128 and line["layers"] == 2
    assert '"part": "train_full"' in capsys.readouterr().out


def test_resume_part_rehearsed_on_the_cpu(cpu_card):
    line = smoke.lm_train_resume("cpu card", CPU)
    assert line["loss_max_abs"] == 0.0 and line["state_max_abs"] == 0.0
    assert len(line["losses_whole"]) == 4 and len(line["losses_resumed"]) == 2
    assert line["checkpoint_bytes"] > 0 and line["layers"] == 2


def test_phase_wiring_rehearsed_on_the_cpu(cpu_card, monkeypatch, pins,
                                           capsys):
    """``run_lm_train_phase`` end to end on the CPU: the pinned part on
    qwen3-smoke against its own pins, the committed family pins, the full
    and resume parts at cut size, no kernel launched."""
    small = dataclasses.replace(cpu_card, dtype="float32")
    own = smoke.lm_train_pin(smoke.lm_train_runs(
        port_api(), small, smoke.LM_TRAIN_PINNED_DATA,
        smoke.LM_TRAIN_PINNED_STEPS, (1, 2)))
    monkeypatch.setattr(smoke, "lm_pinned_config", lambda get: small)
    monkeypatch.setattr(smoke, "lm_train_load_pins", lambda: {
        "pinned": own, "families": pins["families"]})
    monkeypatch.setattr(smoke, "lm_train_family_config",
                        lambda get, arch: dataclasses.replace(
                            get_config(arch, smoke=True), dtype="float32"))
    out = smoke.run_lm_train_phase("cpu card", CPU)
    assert out["seconds"] > 0
    parts = [line for line in capsys.readouterr().out.splitlines()
             if '"phase": "lm_train"' in line]
    assert [p.split('"part": "')[1].split('"')[0] for p in parts] == [
        "device", "train_pinned", "train_families", "train_full",
        "train_resume", "train_total"]
