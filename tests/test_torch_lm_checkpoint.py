"""Checkpoints, the elastic trainer and the training CLI
(``repro_torch.distributed.checkpoint``, ``fault_tolerance``,
``repro_torch.launch.train``) against ``repro``'s on the CPU:
``tests/test_distributed.py``'s ``TestCheckpoint`` and
``TestStragglerMonitor`` cases through the port, checkpoints crossing
between the packages both ways and continuing the same run, and the CLI
running and resuming from its own checkpoint."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as JC
from repro.train import optimizer as JO

from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault_tolerance import (ElasticTrainer,
                                                     StragglerEvent,
                                                     StragglerMonitor)
from repro_torch.launch import train as launch_train
from repro_torch.models import model as TM
from repro_torch.serve import chaos
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train.step import make_train_step

from test_torch_lm_train import (HP, assert_params_close, configs, flat,
                                 j_params, j_step, one_thread,  # noqa: F401
                                 t_params)


def run(step_fn, params, opt_state, cfg, start, n, dc):
    losses = []
    for i in range(start, start + n):
        loss, params, opt_state = step_fn(params, opt_state,
                                          TD.make_batch(cfg, dc, i))
        losses.append(float(loss))
    return params, opt_state, losses


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": np.arange(6).reshape(2, 3).astype(np.float32),
                "b": {"c": np.ones(4), "d": (np.zeros(2), np.ones(1))}}
        path = ckpt.save(str(tmp_path / "x.npz"), tree, step=7)
        out, step = ckpt.restore(path, tree)
        assert step == 7
        np.testing.assert_array_equal(out["a"], tree["a"])
        np.testing.assert_array_equal(out["b"]["d"][1], tree["b"]["d"][1])

    def test_manager_retention_and_latest(self, tmp_path):
        mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
        tree = {"w": np.ones(3)}
        for s in (10, 20, 30):
            mgr.save(tree, s)
        assert mgr.all_steps() == [20, 30]
        out, step = mgr.restore_latest(tree)
        assert step == 30

    def test_atomic_commit_leaves_no_tmp(self, tmp_path):
        tree = {"w": np.ones(3)}
        ckpt.save(str(tmp_path / "c.npz"), tree, 1)
        assert all(not f.endswith(".tmp") for f in os.listdir(tmp_path))

    def test_elastic_restore_resharding(self, tmp_path):
        """Restore onto a device: one for every leaf, or a tree of them."""
        tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
                "s": np.asarray(3, np.int32)}
        path = ckpt.save(str(tmp_path / "e.npz"), tree, 3)
        for shardings in (torch.device("cpu"), "cpu",
                          {"w": torch.device("cpu"), "s": "cpu"}):
            out, step = ckpt.restore(path, tree, shardings)
            assert isinstance(out["w"], torch.Tensor)
            np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
            assert out["s"].shape == () and out["s"].dtype == torch.int32
        with pytest.raises(TypeError, match="NamedSharding"):
            ckpt.restore(path, tree, {"w": object(), "s": "cpu"})

    def test_train_resume_equivalence(self, tmp_path):
        """Stop/restore mid-training reproduces the uninterrupted run
        exactly (deterministic data + saved opt state)."""
        cfg = get_config("qwen3_0_6b", smoke=True)
        hp = TO.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        dc = TD.DataConfig(seq_len=16, global_batch=2, seed=1)
        step_fn = make_train_step(cfg, hp, jit=True, device="cpu")

        def fresh():
            p = TM.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu").tree()
            return p, TO.init(p)

        pa, oa, _ = run(step_fn, *fresh(), cfg, 0, 4, dc)
        pb, ob, _ = run(step_fn, *fresh(), cfg, 0, 2, dc)
        path = ckpt.save(str(tmp_path / "mid.npz"), (pb, ob), 2)
        (pb2, ob2), s = ckpt.restore(path, (pb, ob), "cpu")
        pc, oc, _ = run(step_fn, pb2, ob2, cfg, s, 2, dc)
        diffs = [float((a - c).abs().max().detach()) for a, c in zip(
            TM.leaves((pa, oa)), TM.leaves((pc, oc)))]
        assert max(diffs) < 1e-6


class TestStragglerMonitor:
    def test_detects_outliers(self):
        mon = StragglerMonitor(threshold=2.0)
        for i in range(10):
            assert not mon.observe(i, 1.0)
        assert mon.observe(10, 5.0)
        assert len(mon.events) == 1
        # EWMA not poisoned by the outlier
        assert abs(mon.ewma - 1.0) < 1e-6

    def test_reexported_from_chaos(self):
        assert StragglerMonitor is chaos.StragglerMonitor
        assert StragglerEvent is chaos.StragglerEvent


# ---------------------------------------------------------------------------
# the file format, across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_0_6b", "whisper_tiny",
                                  "xlstm_1_3b"])
def test_file_keys_and_shapes_are_repro_s(arch, tmp_path):
    """An LM train state written by the port has ``repro``'s keys and
    stacked shapes (``[n_layers, ...]``, ``[n_groups, g - 1, ...]``)."""
    jc, tc = configs(arch)
    jp = j_params(arch)
    JC.save(str(tmp_path / "j.npz"), (jp, JO.init(jp)), 0)
    tp = t_params(arch, tc)
    ckpt.save(str(tmp_path / "t.npz"), (tp, TO.init(tp)), 0)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "hymba_1_5b",
                                  "xlstm_1_3b"])
def test_repro_checkpoint_continues_in_the_port(arch, tmp_path):
    """``repro`` trains 2 steps and saves; the port restores and trains
    steps 2-3, matching ``repro``'s uninterrupted 4-step run."""
    jc, tc = configs(arch)
    dc = TD.DataConfig(seq_len=16, global_batch=2, seed=1)
    j_fn = j_step(arch, "float32", 1)

    def j_run(p, s, start, n):
        losses = []
        for i in range(start, start + n):
            b = {k: jnp.asarray(v) for k, v in
                 TD.make_batch(tc, dc, i).items()}
            loss, p, s = j_fn(p, s, b)
            losses.append(float(loss))
        return p, s, losses

    pa, sa, la = j_run(j_params(arch), JO.init(j_params(arch)), 0, 4)
    pb, sb, _ = j_run(j_params(arch), JO.init(j_params(arch)), 0, 2)
    path = JC.save(str(tmp_path / "mid.npz"), (pb, sb), 2)
    tp = t_params(arch, tc)
    (tp, ts), step = ckpt.restore(path, (tp, TO.init(tp)), "cpu")
    assert step == 2 and int(ts["step"]) == 2
    t_fn = make_train_step(tc, TO.AdamWConfig(**HP), device="cpu")
    tp, ts, lt = run(t_fn, tp, ts, tc, 2, 2, dc)
    np.testing.assert_allclose(lt, la[2:], rtol=1e-4)
    assert_params_close(tp, pa, 4)


def test_port_checkpoint_restores_in_repro(tmp_path):
    """The port trains 2 steps and saves; ``repro`` restores the file
    into its own tree and trains steps 2-3, matching the port's
    uninterrupted 4-step run."""
    arch = "gemma_2b"
    jc, tc = configs(arch)
    dc = TD.DataConfig(seq_len=16, global_batch=2, seed=1)
    t_fn = make_train_step(tc, TO.AdamWConfig(**HP), device="cpu")
    tp = t_params(arch, tc)
    pa, sa, la = run(t_fn, tp, TO.init(tp), tc, 0, 4, dc)
    tp = t_params(arch, tc)
    pb, sb, _ = run(t_fn, tp, TO.init(tp), tc, 0, 2, dc)
    path = ckpt.save(str(tmp_path / "mid.npz"), (pb, sb), 2)
    jp = j_params(arch)
    (jp, js), step = JC.restore(path, (jp, JO.init(jp)))
    assert step == 2
    np.testing.assert_array_equal(np.asarray(js["step"]), 2)
    for k, v in flat(pb).items():
        np.testing.assert_array_equal(flat(jp)[k], v, err_msg=k)
    jp, js = jax.tree.map(jnp.asarray, (jp, js))
    j_fn = j_step(arch, "float32", 1)
    losses = []
    for i in (2, 3):
        b = {k: jnp.asarray(v) for k, v in TD.make_batch(tc, dc, i).items()}
        loss, jp, js = j_fn(jp, js, b)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, la[2:], rtol=1e-4)
    assert_params_close(jp, pa, 4)


# ---------------------------------------------------------------------------
# the elastic trainer and the CLI
# ---------------------------------------------------------------------------

def trainer_for(cfg, directory, save_every, keep=3):
    hp = TO.AdamWConfig(**HP)

    def build_state(_mesh):
        p = TM.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu").tree()
        return p, TO.init(p)

    return ElasticTrainer(str(directory), build_state,
                          lambda: make_train_step(cfg, hp, device="cpu"),
                          mesh_builder=lambda: None, save_every=save_every,
                          keep=keep)


def test_elastic_trainer_saves_and_resumes(tmp_path):
    cfg = get_config("qwen3_0_6b", smoke=True)
    dc = TD.DataConfig(seq_len=16, global_batch=2, seed=0)
    logs = []
    tr = trainer_for(cfg, tmp_path / "a", save_every=100)
    _, p, o, start = tr.resume_or_init()
    assert start == 0
    _, _, whole = tr.run(p, o, TD.batches(cfg, dc), 4, log=logs.append)
    assert len(logs) == 1 and logs[0].startswith("step 0: loss=")
    assert tr.monitor.ewma is not None

    tr = trainer_for(cfg, tmp_path / "b", save_every=2, keep=1)
    _, p, o, _ = tr.resume_or_init()
    tr.run(p, o, TD.batches(cfg, dc), 2, log=logs.append)
    assert tr.manager.all_steps() == [2]
    fresh = trainer_for(cfg, tmp_path / "b", save_every=2, keep=1)
    _, p, o, start = fresh.resume_or_init()
    assert start == 2 and int(o["step"]) == 2
    assert all(isinstance(t, torch.Tensor) for t in TM.leaves((p, o)))
    _, _, rest = fresh.run(p, o, TD.batches(cfg, dc, start_step=2), 2,
                           start_step=2, log=logs.append)
    assert rest == whole[2:]
    assert fresh.manager.all_steps() == [4]


def test_elastic_trainer_never_hides_a_failed_step(tmp_path):
    cfg = get_config("qwen3_0_6b", smoke=True)
    tr = trainer_for(cfg, tmp_path, save_every=1)
    _, p, o, _ = tr.resume_or_init()

    def bad():
        yield {"tokens": np.zeros((2, 4), np.int32)}    # no labels

    with pytest.raises(KeyError):
        tr.run(p, o, bad(), 1)
    assert tr.manager.all_steps() == []


ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--seq-len", "16",
        "--global-batch", "2", "--device", "cpu"]


def test_cli_runs_and_resumes(tmp_path, capsys):
    d = str(tmp_path / "ck")
    whole = launch_train.main(ARGS + ["--steps", "4", "--ckpt-dir",
                                      str(tmp_path / "w"),
                                      "--save-every", "100"])
    first = launch_train.main(ARGS + ["--steps", "2", "--ckpt-dir", d,
                                      "--save-every", "2"])
    assert first == whole[:2] and all(np.isfinite(whole))
    assert ckpt.CheckpointManager(d).all_steps() == [2]
    out = capsys.readouterr().out
    assert "arch=qwen3-smoke" in out and "device cpu" in out
    more = launch_train.main(ARGS + ["--steps", "2", "--ckpt-dir", d,
                                     "--save-every", "2"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert len(more) == 2 and all(np.isfinite(more))
    assert ckpt.CheckpointManager(d).all_steps() == [2, 4]
    accum = launch_train.main(ARGS + ["--steps", "1", "--grad-accum", "2",
                                      "--ckpt-dir", str(tmp_path / "g")])
    assert len(accum) == 1 and np.isfinite(accum[0])


def test_cli_refuses_a_mesh(tmp_path, monkeypatch):
    """The production mesh needs a world of 256 ranks: on one process
    (no group, or torchrun's environment absent) the CLI refuses it,
    naming the world size, as ``jax.make_mesh`` refuses the device count;
    on the card the same without ``--device``."""
    for k in launch_train.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 1"):
        launch_train.main(ARGS + ["--production-mesh", "--ckpt-dir",
                                  str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 1"):
        launch_train.main(["--smoke", "--production-mesh", "--ckpt-dir",
                           str(tmp_path)])


def test_entry_points_run_on_the_card_or_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3_0_6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, TO.AdamWConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--smoke", "--ckpt-dir", str(tmp_path)])
