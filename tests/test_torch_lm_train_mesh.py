"""Training on a mesh (``repro_torch.launch.train``'s mesh paths,
``distributed.checkpoint``'s sharded save and ``restore(shardings=)``,
``ElasticTrainer``'s elastic resume) on gloo worlds of CPU ranks, each a
process of its own (rendezvous through a ``FileStore`` in a temporary
directory).

``launch.train.main`` takes the mesh path when a process group is
initialized as it starts: 8 ranks give ``make_host_mesh``'s ``(4, 2)``
mesh, 4 ranks ``(2, 2)``.  qwen3-smoke trains in bf16 (``main`` has no
dtype switch), 4 steps of 8 x 16 tokens, saving every 2.  Where the
reduction order changes (sharded against unsharded, 8 ranks against 4)
the losses are held at the repo's bf16 tolerance, 2e-2 relative; float32
parity on a mesh is held step by step in ``test_torch_lm_mesh.py``.

``repro``'s ``launch.train.main`` runs in a subprocess on 8 XLA host
devices, its ``make_host_mesh`` replaced by an ``Auto``-axis ``(4, 2)``
mesh (``jax.make_mesh``'s default ``Explicit`` axes make its ``constrain``
raise under JAX 0.9.0); its losses are read from ``ElasticTrainer.run``'s
return, and its step-2 checkpoint is continued by the port's 8 ranks.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch import train as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
BF16_RTOL = 2e-2
CKPT2 = "ckpt_00000002.npz"
#: the runs' arguments; the continuation of repro's checkpoint takes
#: repro's own ``--steps 3`` (the schedule's length)
ARGV = ["--smoke", "--seq-len", "16", "--global-batch", "8",
        "--save-every", "2", "--device", "cpu"]
STEPS = ["--steps", "4"]
REPRO_STEPS = ["--steps", "3"]

#: one rank of a gloo world; prints a JSON object on its last line.
#: ``full``: the uninterrupted run (dir a), its resume from step 2 (dir
#: b), ``restore(shardings=)`` of a's step-2 checkpoint, and the
#: continuation of repro's (dir r, once repro's subprocess is done);
#: ``resume``: a resume from step 2 (dir given).
RANK_SCRIPT = r"""
import datetime, json, os, shutil, sys, time
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as CK
from repro_torch.distributed import sharding as SH
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves

rank, world, store, base, stage, argv, steps, repro_steps, repro_dir = (
    sys.argv[1:10])
rank, world = int(rank), int(world)
argv, steps, repro_steps = (json.loads(a) for a in (argv, steps,
                                                    repro_steps))
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=300))


def run(d, n=steps):
    return T.main(argv + n + ["--ckpt-dir", d])


def seed(src, d):
    # rank 0 lays the checkpoint in a fresh directory, the others wait
    if rank == 0:
        os.makedirs(d)
        shutil.copy(src, d)
    dist.barrier()


res = {"world": world}
try:
    if stage == "full":
        res["uninterrupted"] = run(f"{base}/a")
        res["files"] = sorted(os.listdir(f"{base}/a"))
        seed(f"{base}/a/ckpt_00000002.npz", f"{base}/b")
        res["resumed"] = run(f"{base}/b")
        # restore(shardings=): DTensors laid out by the specs, equal to
        # the file's full arrays
        cfg = get_config("qwen3-0.6b", smoke=True)
        params = M.init_params(cfg, device="meta").tree()
        like = (params, opt.init(params))
        mesh = make_host_mesh(2, device="cpu")
        shard = SH.tree_shardings(like, mesh, False)
        tree, step = CK.restore(f"{base}/a/ckpt_00000002.npz", like,
                                shardings=shard)
        with np.load(f"{base}/a/ckpt_00000002.npz") as z:
            saved = {k: z[k] for k in z.files}
        flat = CK._flatten(tree)
        res["restore"] = {
            "step": step,
            "dtensors": all(isinstance(x, DTensor) for x in leaves(tree)),
            "placed": all(tuple(x.placements) == s.placements(x.ndim)
                          for x, s in zip(leaves(tree), leaves(shard))),
            "sharded": sum(any(not p.is_replicate() for p in x.placements)
                           for x in leaves(tree)),
            "equal": sorted(flat) == sorted(k for k in saved
                                            if k != "__step__")
                     and all(np.array_equal(flat[k], saved[k])
                             for k in flat)}
        done = os.path.join(repro_dir, "done.json")
        t0 = time.time()
        while not os.path.exists(done) and time.time() - t0 < 300:
            time.sleep(0.5)
        seed(os.path.join(repro_dir, "ck", "ckpt_00000002.npz"),
             f"{base}/r")
        res["continued"] = run(f"{base}/r", repro_steps)
    else:
        res["resumed"] = run(stage)
    print(json.dumps(res))
finally:
    dist.destroy_process_group()
"""

#: ``repro``'s ``launch.train.main`` on an ``Auto``-axis (4, 2) mesh of 8
#: host devices; writes ``done.json`` with its losses
REPRO_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from jax.sharding import AxisType
import repro.launch.train as RT
from repro.distributed.fault_tolerance import ElasticTrainer

out, argv = sys.argv[1], json.loads(sys.argv[2])
RT.make_host_mesh = lambda model=2: jax.make_mesh(
    (4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
losses = []
run = ElasticTrainer.run


def recorded(self, *a, **k):
    got = run(self, *a, **k)
    losses.extend(got[2])
    return got


ElasticTrainer.run = recorded
sys.argv = ["train"] + argv + ["--ckpt-dir", os.path.join(out, "ck")]
RT.main()
with open(os.path.join(out, "done.tmp"), "w") as f:
    json.dump({"losses": losses, "devices": len(jax.devices())}, f)
os.replace(os.path.join(out, "done.tmp"), os.path.join(out, "done.json"))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _spawn(world, base, stage, repro_dir):
    store = base / f"store_{stage.replace('/', '_')}_{world}"
    return [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(r), str(world), str(store),
         str(base), stage, json.dumps(ARGV), json.dumps(STEPS),
         json.dumps(REPRO_STEPS), str(repro_dir)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def _collect(procs):
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [json.loads(out.splitlines()[-1]) for out, _ in outs]


def _seed(base, name):
    d = base / name
    d.mkdir()
    shutil.copy(base / "a" / CKPT2, d)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: repro's and the 8 ranks' at once, the
    unsharded one meanwhile here; then the resumes on 4 ranks and here on
    one process with no group."""
    base = tmp_path_factory.mktemp("lm_train_mesh")
    repro_dir = base / "repro"
    repro_dir.mkdir()
    jenv = dict(_env(), JAX_PLATFORMS="cpu")
    repro = subprocess.Popen(
        [sys.executable, "-c", REPRO_SCRIPT, str(repro_dir),
         json.dumps(["--smoke", "--seq-len", "16", "--global-batch", "8",
                     "--save-every", "2"] + REPRO_STEPS)],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    eight = _spawn(8, base, "full", repro_dir)
    try:
        single = T.main(ARGV + STEPS + ["--ckpt-dir", str(base / "u")])
        ranks8 = _collect(eight)
        _, err = repro.communicate(timeout=TIMEOUT_S)
    finally:
        for p in eight + [repro]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert repro.returncode == 0, err[-4000:]
    with open(repro_dir / "done.json") as f:
        repro_run = json.load(f)
    four = _spawn(4, base, str(_seed(base, "c4")), repro_dir)
    resumed1 = T.main(ARGV + STEPS + ["--ckpt-dir",
                                      str(_seed(base, "c1"))])
    ranks4 = _collect(four)
    return {"single": single, "ranks8": ranks8, "ranks4": ranks4,
            "resumed1": resumed1, "repro": repro_run}


def _within(got, want, rtol=BF16_RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)


def test_mesh_run_matches_unsharded_step_by_step(runs):
    """8 ranks as ``(4, 2)``: every step's loss within 2e-2 of the
    unsharded ``main`` with the same arguments, the same on every rank;
    checkpoints at steps 2 and 4."""
    first = runs["ranks8"][0]
    assert len(first["uninterrupted"]) == 4
    _within(first["uninterrupted"], runs["single"])
    for r in runs["ranks8"]:
        assert r["uninterrupted"] == first["uninterrupted"]
    assert first["files"] == ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    assert runs["single"][-1] < runs["single"][0]


def test_resume_on_the_same_mesh_is_exact(runs):
    """Resumed from the step-2 checkpoint on the same 8 ranks, steps 3-4
    equal the uninterrupted run's exactly."""
    for r in runs["ranks8"]:
        assert r["resumed"][:2] == r["uninterrupted"][2:4]


@pytest.mark.parametrize("where", ["ranks4", "resumed1"])
def test_elastic_resume_on_fewer_ranks(runs, where):
    """The checkpoint of 8 ranks resumed on 4 (``(2, 2)``) and on one
    process with no group: steps 3-4 within 2e-2 of the 8 ranks'."""
    want = runs["ranks8"][0]["uninterrupted"][2:4]
    got = (runs["ranks4"][0]["resumed"] if where == "ranks4"
           else runs["resumed1"])
    _within(got[:2], want)
    if where == "ranks4":
        assert all(r["world"] == 4 for r in runs["ranks4"])
        assert all(r["resumed"] == got for r in runs["ranks4"])


def test_repro_checkpoint_continues_on_the_port_mesh(runs):
    """``repro``'s step-2 checkpoint (8 XLA devices, ``Auto`` (4, 2)),
    restored onto the port's ``(4, 2)`` mesh and continued: the port's
    first loss within 2e-2 of ``repro``'s own loss for that step."""
    rep = runs["repro"]
    assert rep["devices"] == 8 and len(rep["losses"]) == 3
    assert rep["losses"][-1] < rep["losses"][0]
    for r in runs["ranks8"]:
        _within(r["continued"][0], rep["losses"][2])


def test_restore_with_named_shardings_gives_dtensors(runs):
    """``restore(path, like, shardings=)`` with ``tree_shardings``'
    ``NamedSharding``s: every leaf a ``DTensor`` with the spec's
    placements, some sharded, each equal to the file's array."""
    for r in runs["ranks8"]:
        got = r["restore"]
        assert got["step"] == 2
        assert got["dtensors"] and got["placed"] and got["equal"], got
        assert got["sharded"] > 0, got


def test_production_mesh_refuses_a_world_of_one():
    """``--production-mesh`` on a world of 1 raises ``ValueError`` naming
    the world size, as ``jax.make_mesh`` refuses the device count."""
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 1"):
        T.main(["--production-mesh", "--smoke", "--steps", "1",
                "--device", "cpu"])
