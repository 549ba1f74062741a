"""The dry run and the HLO parser (``repro_torch.launch.dryrun``,
``repro_torch.launch.hlo_parse``) against ``repro``'s.

* The parser's string functions and ``collective_bytes_from_hlo`` on the
  unit strings of ``tests/test_dryrun_small.py`` and on HLO that
  ``repro``'s JAX compiles in a subprocess (8 host devices, a
  ``shard_map`` with a ``psum`` and an ``all_gather`` inside a
  ``lax.scan`` of 5 steps, so the trip count multiplies): equal.
* ``test_dryrun_small.py``'s ``SCRIPT`` configuration on a fake world of
  8 ranks as ``(4, 2)``: the argument bytes equal ``repro``'s leaf by
  leaf (``tools/lm_dryrun_pins.json``, made by ``tools/
  lm_dryrun_pins.py``), and ``train_4k``'s output bytes equal ``repro``'s
  but for XLA's 8-byte tuple entry an output leaf.  Temp and collective
  bytes are recorded in the pins, not asserted (GSPMD picks its own
  collectives and XLA its own buffers); as ``repro``'s test asserts,
  ``train_4k`` has temp and collective bytes, and FSDP's all-gathers
  and reductions run over ``data``.
* The published qwen3-0.6b's widths, cut to 2 layers (the head layout
  that failed depends on widths, not depth), on fake ``16x16`` and
  ``2x16x16`` worlds, one subprocess a mesh: every admitted cell ``ok``.
* ``main`` writes ``--out`` with ``CellReport``'s fields.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_parse as JH
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import hlo_parse as TH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models import ssm as TS

ROOT = Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tools" / "lm_dryrun_pins.json").read_text())
TIMEOUT_S = 300
#: XLA's output size adds one 8-byte tuple entry an output leaf
TUPLE_ENTRY = 8
PRODUCTION_LAYERS = 2

#: the unit strings of ``test_dryrun_small.py::test_hlo_parser_units``
LINE = ("%all-gather.1 = bf16[16,1024]{1,0} all-gather(%p), "
        "dimensions={0}")
COMP = ("comp_a (x: f32[2]) -> f32[2] {\n"
        "  %y = f32[2]{0} all-reduce(%x), to_apply=%add\n"
        "}\n")

#: ``repro`` compiles a scanned ``shard_map`` and reads it with its own
#: parser; prints one JSON object
HLO_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import AxisType, PartitionSpec as P

mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Explicit,) * 2)


def body(x):
    def step(c, _):
        y = lax.psum(c, "model")
        z = lax.all_gather(y, "data", tiled=True)
        return c + z[: c.shape[0]] * 0.5, None
    out, _ = lax.scan(step, x, None, length=5)
    return out


f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                          out_specs=P("data", "model")))
hlo = f.lower(jnp.ones((16, 8), jnp.float32)).compile().as_text()
from repro.launch.dryrun import collective_bytes_from_hlo
from repro.launch.hlo_parse import analyze_collectives
texts = [hlo] + json.loads(sys.argv[1])
print(json.dumps({"hlo": hlo, "analyze": [analyze_collectives(t)
                                          for t in texts],
                  "flat": [collective_bytes_from_hlo(t) for t in texts]}))
"""

#: the port's cells of one production mesh at cut depth; prints a JSON
#: list of ``CellReport``s
CELLS_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.specs import SHAPES

multi_pod, layers = sys.argv[1] == "1", int(sys.argv[2])
cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=layers)
print(json.dumps([DR.run_cell("qwen3_0_6b", s, multi_pod, verbose=False,
                              device="cpu", cfg=cfg).to_json()
                  for s in SHAPES]))
"""


#: the recurrences' cells for the counted loops: a cut depth at published
#: widths and a prefill length whose every iteration is quick to dispatch
#: (xlstm: one mLSTM block of 4 chunks and one sLSTM block of 1,024 steps;
#: hymba: one layer, 8 mamba chunks)
LOOP_CELLS = {"xlstm_1_3b": ({"n_layers": 2, "xlstm_group": 2}, 1024),
              "hymba_1_5b": ({"n_layers": 1}, 2048)}

#: one cell's prefill on a fake ``16x16`` world, its recurrences counted
#: (``counted``) or every iteration dispatched (``dispatched``); prints the
#: measured fields, the collectives by axis and the iterations counted
#: without being dispatched
LOOPS_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.distributed import context as dctx
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh

arch, cut, seq, mode = (sys.argv[1], json.loads(sys.argv[2]),
                        int(sys.argv[3]), sys.argv[4])
SP.SHAPE_SPECS["prefill_32k"] = SP.ShapeSpec("prefill_32k", "prefill", seq,
                                             32)
if mode == "dispatched":
    dctx.loop_counter = lambda: None
cfg = dataclasses.replace(get_config(arch), **cut)
detail = {}
with DR.fake_world(256):
    mesh = make_production_mesh(device="cpu")
    got = DR.measure(cfg, "prefill_32k", mesh, False, "cpu", detail)
print(json.dumps({**got, "by_axis": detail["by_axis"],
                  "repeated": detail["repeated"]}))
"""

#: xlstm-1.3b's published widths on the fake ``2x16x16`` world, cut to one
#: mLSTM and one sLSTM block (``xlstm_group`` 2) and a train step of 256
#: x 256 tokens: prints the ``CellReport``
MLSTM_MP_SCRIPT = r"""
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP

SP.SHAPE_SPECS["train_4k"] = SP.ShapeSpec("train_4k", "train", 256, 256)
cfg = dataclasses.replace(get_config("xlstm_1_3b"), n_layers=2,
                          xlstm_group=2)
print(json.dumps(DR.run_cell("xlstm_1_3b", "train_4k", True, verbose=False,
                             device="cpu", cfg=cfg).to_json()))
"""

#: the pins' LEAF_CELLS on the fake ``16x16`` world: the port's argument
#: and output bytes leaf by leaf
LEAVES_SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh

out = {}
for arch, shape in json.loads(sys.argv[1]):
    detail = {}
    with DR.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        got = DR.measure(get_config(arch), shape, mesh, False, "cpu", detail)
    out[f"{arch}/{shape}/16x16"] = {
        "arg_bytes_by_leaf": DR.local_bytes_by_leaf(tuple(detail["args"])),
        "output_bytes_by_leaf": DR.local_bytes_by_leaf(tuple(detail["out"])),
        "arg_bytes_per_device": got["arg_bytes_per_device"],
        "output_bytes_per_device": got["output_bytes_per_device"]}
print(json.dumps(out))
"""


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


@pytest.fixture(scope="module")
def started():
    """The subprocesses, started before the in-process tests run: the
    HLO compile and one production mesh each."""
    procs = {"hlo": subprocess.Popen(
        [sys.executable, "-c", HLO_SCRIPT, json.dumps([COMP, LINE])],
        env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    for mp in (0, 1):
        procs[mp] = subprocess.Popen(
            [sys.executable, "-c", CELLS_SCRIPT, str(mp),
             str(PRODUCTION_LAYERS)], env=_env(OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for arch, (cut, seq) in LOOP_CELLS.items():
        for mode in ("counted", "dispatched"):
            procs[arch, mode] = subprocess.Popen(
                [sys.executable, "-c", LOOPS_SCRIPT, arch, json.dumps(cut),
                 str(seq), mode], env=_env(OMP_NUM_THREADS="1"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["mlstm_mp"] = subprocess.Popen(
        [sys.executable, "-c", MLSTM_MP_SCRIPT], env=_env(OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["leaves"] = subprocess.Popen(
        [sys.executable, "-c", LEAVES_SCRIPT,
         json.dumps(PINS["leaves"]["cells"])], env=_env(OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results = {}
    yield procs, results
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _result(started, key):
    procs, results = started
    if key not in results:
        out, err = procs[key].communicate(timeout=TIMEOUT_S)
        assert procs[key].returncode == 0, err[-4000:]
        results[key] = json.loads(out.strip().splitlines()[-1])
    return results[key]


def test_hlo_parser_units_equal_repro():
    assert TH._result_bytes(LINE) == JH._result_bytes(LINE) == 16 * 1024 * 2
    assert TH.split_computations(COMP) == JH.split_computations(COMP)
    assert "comp_a" in TH.split_computations(COMP)
    assert TH.analyze_collectives(COMP) == JH.analyze_collectives(COMP)


def test_scanned_hlo_equals_repro(started):
    """On ``repro``-compiled HLO with a 5-step scan (and on the unit
    strings) both ``analyze_collectives`` and
    ``collective_bytes_from_hlo`` equal ``repro``'s; the scan's body is
    counted 5 times."""
    got = _result(started, "hlo")
    texts = [got["hlo"], COMP, LINE]
    for text, want_a, want_f in zip(texts, got["analyze"], got["flat"]):
        assert list(TH.analyze_collectives(text)) == want_a
        assert DR.collective_bytes_from_hlo(text) == want_f
    bytes_by, counts = TH.analyze_collectives(got["hlo"])
    flat = DR.collective_bytes_from_hlo(got["hlo"])
    assert bytes_by["all-reduce"] == 5 * flat["all-reduce"] > 0
    assert counts["all-reduce"] % 5 == 0


@pytest.fixture(scope="module")
def script_cells(monkeypatch_module):
    """``test_dryrun_small.py``'s ``SCRIPT`` on a fake world of 8 ranks."""
    conf = PINS["script"]["config"]
    cfg = dataclasses.replace(get_config(conf["arch"], smoke=conf["smoke"]),
                              n_layers=conf["n_layers"], vocab=conf["vocab"])
    for name, (kind, seq, batch) in conf["shapes"].items():
        monkeypatch_module.setitem(SP.SHAPE_SPECS, name,
                                   SP.ShapeSpec(name, kind, seq, batch))
    out = {}
    for shape in conf["shapes"]:
        detail = {}
        with DR.fake_world(conf["mesh"][0] * conf["mesh"][1]):
            mesh = make_host_mesh(conf["mesh"][1], device="cpu")
            got = DR.measure(cfg, shape, mesh, False, "cpu", detail)
        by_leaf = {}
        for i, a in enumerate(detail["args"]):
            by_leaf.update(DR.local_bytes_by_leaf(a, f"{i}/"))
        out[shape] = {"got": got, "by_leaf": by_leaf,
                      "by_axis": detail["by_axis"]}
    return cfg, out


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_script_argument_bytes_equal_repro(script_cells, shape):
    """Every argument leaf's local-shard bytes equal ``repro``'s (a
    per-layer list summed as ``repro`` stacks it), and so their sum:
    551,940 (``train_4k``) and 495,124 (``decode_32k``)."""
    _, out = script_cells
    want = PINS["script"]["repro"][shape]
    got = out[shape]
    assert got["by_leaf"] == want["arg_bytes_by_leaf"]
    assert (got["got"]["arg_bytes_per_device"]
            == want["arg_bytes_per_device"]
            == {"train_4k": 551940, "decode_32k": 495124}[shape])


def test_script_train_output_bytes_equal_repro(script_cells):
    """``train_4k``'s outputs (loss, parameters, optimizer state, whose
    shardings ``repro`` fixes): the port's local-shard bytes plus XLA's
    8-byte tuple entry for each of ``repro``'s output leaves equal
    ``repro``'s 550,224."""
    cfg, out = script_cells
    want = PINS["script"]["repro"]["train_4k"]
    n_params = len(DR.local_bytes_by_leaf(
        M.init_params(cfg, device="meta").tree()))
    leaves = 1 + 3 * n_params + 1          # loss, params, m, v, step
    assert leaves == want["output_leaves"]
    assert (out["train_4k"]["got"]["output_bytes_per_device"]
            + TUPLE_ENTRY * leaves == want["output_bytes_per_device"]
            == 550224)


def test_script_train_has_temp_and_fsdp_collectives(script_cells):
    """As ``repro``'s test asserts: ``train_4k`` has temp and collective
    bytes; and the step all-gathers the parameters over ``data`` and
    reduces their gradients over it (FSDP)."""
    _, out = script_cells
    got, by_axis = out["train_4k"]["got"], out["train_4k"]["by_axis"]
    assert got["temp_bytes_per_device"] > 0
    assert sum(got["collective_bytes"].values()) > 0
    assert by_axis.get("all-gather@data", 0) > 0, by_axis
    assert (by_axis.get("reduce-scatter@data", 0)
            + by_axis.get("all-reduce@data", 0)) > 0, by_axis
    assert out["decode_32k"]["got"]["temp_bytes_per_device"] >= 0


@pytest.mark.parametrize("multi_pod", [0, 1], ids=["16x16", "2x16x16"])
def test_published_widths_every_admitted_cell_ok(started, multi_pod):
    """qwen3-0.6b's published widths (8 key/value heads on a ``model``
    axis of 16) at 2 layers: every cell ``shape_supported`` admits ends
    ``ok`` on the fake production world with collectives counted, and
    ``long_500k`` is skipped."""
    cells = _result(started, multi_pod)
    cfg = get_config("qwen3-0.6b")
    for c in cells:
        ok, _ = SP.shape_supported(cfg, c["shape"])
        assert c["status"] == ("ok" if ok else "skipped"), c
        assert c["mesh"] == ("2x16x16" if multi_pod else "16x16")
        if ok:
            assert c["arg_bytes_per_device"] > 0
            assert sum(c["collective_bytes"].values()) > 0, c
            assert c["roofline"]["shape"] == c["shape"]


def test_main_writes_cell_reports(tmp_path):
    """``main`` on a small architecture and shape writes ``--out``: a list
    of ``CellReport``s with every field, and returns 0."""
    out = tmp_path / "cells.json"
    assert DR.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                    "--device", "cpu", "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert len(cells) == 1
    fields = {f.name for f in dataclasses.fields(DR.CellReport)}
    assert set(cells[0]) == fields
    assert cells[0]["status"] == "ok", cells[0]
    assert cells[0]["arch"] == "whisper-tiny"


def test_main_skips_what_the_shape_rules_exclude(tmp_path):
    """A full-attention architecture at ``long_500k`` is skipped, with
    the reason, and is no failure."""
    out = tmp_path / "cells.json"
    assert DR.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                    "--both-meshes", "--device", "cpu",
                    "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert [c["status"] for c in cells] == ["skipped", "skipped"]
    assert all("sub-quadratic" in c["reason"] for c in cells)


def test_fake_world_refuses_a_process_with_a_group():
    """The fake world never stands in for a real group."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no process group"):
            with DR.fake_world(8):
                pass
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_skips_hidden_chunks_exactly(window):
    """``_sdpa_chunked`` skips the KV chunks the mask hides wholly; the
    result is bit for bit that of visiting every chunk as ``repro``'s
    scan does (a copy of that loop here), in bf16 and float32."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              attn_chunk=16)
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((2, 80, h, 8), generator=g).to(dtype)
                   for h in (4, 2, 2))
        got = TL._sdpa_chunked(q, k, v, cfg, window=window)
        assert torch.equal(got, _every_chunk(q, k, v, 16, window))


def _every_chunk(q, k, v, c, window):
    """The online softmax over every KV chunk, masked, as before the
    skip."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G, nq = H // Hkv, S // c
    qg = q.reshape(B, nq, c, Hkv, G, Dh)
    kc = k.reshape(B, nq, c, Hkv, Dh)
    vc = v.reshape(B, nq, c, Hkv, Dh)
    ar = torch.arange(c)
    outs = []
    for qi in range(nq):
        m = torch.full((B, Hkv, G, c), TL.NEG, dtype=torch.float32)
        l = torch.zeros((B, Hkv, G, c), dtype=torch.float32)
        acc = torch.zeros((B, c, Hkv, G, Dh), dtype=torch.float32)
        for ki in range(nq):
            s = torch.einsum("bskgd,btkd->bkgst", qg[:, qi], kc[:, ki])
            s = s.float() * TL.weak(1.0 / np.sqrt(Dh), s)
            qpos, kpos = qi * c + ar[:, None], ki * c + ar[None, :]
            msk = qpos >= kpos
            if window:
                msk &= kpos > qpos - window
            s = torch.where(msk, s, TL.NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
                   + torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype),
                                  vc[:, ki]))
            m = m_new
        out = acc / l.permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, c, H * Dh).to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H * Dh)


@pytest.mark.parametrize("arch", list(LOOP_CELLS))
def test_counted_recurrences_equal_dispatched_ones(started, arch):
    """The prefill of xlstm-1.3b (mLSTM chunks, sLSTM steps) and of
    hymba-1.5b (mamba chunks) at published widths, cut in depth and
    length, on a fake ``16x16`` world: with the recurrences counted by a
    few iterations and scaled (``ssm.scan`` under the dry run's counter)
    every measured field (FLOPs, bytes, collectives by kind and by axis,
    argument, output and temp bytes) equals the fully dispatched loop's
    exactly; the counted run left iterations undispatched, the other
    none.  Each run is a process of its own (a process's first cell
    counts a few bytes of one-off scalars)."""
    counted = dict(_result(started, (arch, "counted")))
    dispatched = dict(_result(started, (arch, "dispatched")))
    assert counted.pop("repeated") > 0
    assert dispatched.pop("repeated") == 0
    assert counted == dispatched
    assert counted["temp_bytes_per_device"] > 0 and counted["flops"] > 0


def test_mlstm_train_on_the_multi_pod_mesh(started):
    """xlstm-1.3b's published widths (4 heads of 512 on a ``model`` axis
    of 16, ``act_ssm_heads`` cutting the head dim) in a train step on the
    fake ``2x16x16`` world, cut to one mLSTM and one sLSTM block and 256
    x 256 tokens: ``ok`` with collectives (it raised ``ValueError:
    Cannot view a tensor ...`` in ``ssm.mlstm``'s chunk loop before the
    loop ran on local shards)."""
    c = _result(started, "mlstm_mp")
    assert c["status"] == "ok", c["reason"]
    assert c["mesh"] == "2x16x16"
    assert c["arg_bytes_per_device"] > 0 and c["temp_bytes_per_device"] > 0
    assert sum(c["collective_bytes"].values()) > 0, c


def _leaf_cells():
    return [f"{a}/{s}/{m}" for a, s in PINS["leaves"]["cells"]
            for m in ("16x16", "2x16x16")]


#: the argument leaves ``jax.jit`` drops as unused from ``repro``'s steps
#: (``keep_unused=False``), which XLA's argument size then leaves out: the
#: image adapter in a decode step, whisper's encoder and cross-attention
#: key/value projections in one (their keys and values come from the
#: cache)
UNUSED = {"phi_3_vision_4_2b/decode_32k": lambda k: k == "0/img_adapter",
          "whisper_tiny/decode_32k": lambda k: k.startswith((
              "0/enc_blocks/", "0/enc_norm", "0/blocks/cross/wk",
              "0/blocks/cross/wv"))}
#: output leaves whose layout DTensor cannot express: XLA splits
#: whisper-tiny's 6 cross-attention key/value heads two ways over a
#: ``model`` axis of 16; the port holds them whole on every ``model`` rank
WHOLE_OVER_MODEL = {"whisper_tiny/prefill_32k": (
    "1/layers/cross_kv/0", "1/layers/cross_kv/1")}


def _held_leaf_by_leaf(cell, port, repro):
    """The port's bytes against ``repro``'s, leaf by leaf, and
    ``repro``'s totals from its leaves (XLA's: the unused arguments left
    out, an 8-byte tuple entry an output leaf)."""
    name = cell.rsplit("/", 1)[0]
    unused = UNUSED.get(name, lambda k: False)
    assert port["arg_bytes_by_leaf"] == repro["arg_bytes_by_leaf"], cell
    assert port["arg_bytes_per_device"] == sum(
        port["arg_bytes_by_leaf"].values())
    assert sorted(repro["unused_args"]) == sorted(
        k for k in repro["arg_bytes_by_leaf"] if unused(k)), cell
    assert repro["arg_bytes_per_device"] == sum(
        v for k, v in repro["arg_bytes_by_leaf"].items() if not unused(k))
    whole = WHOLE_OVER_MODEL.get(name, ())
    want = {k: 2 * v if k in whole else v
            for k, v in repro["output_bytes_by_leaf"].items()}
    assert port["output_bytes_by_leaf"] == want, cell
    assert repro["output_bytes_per_device"] == sum(
        repro["output_bytes_by_leaf"].values()) + TUPLE_ENTRY * len(want)


@pytest.mark.parametrize("cell", [c for c in _leaf_cells()
                                  if c.endswith("/16x16")])
def test_leaf_bytes_equal_repro(started, cell):
    """The cells whose bytes differed from ``repro``'s (phi-3-vision's and
    whisper-tiny's ``decode_32k`` arguments, whisper-tiny's
    ``prefill_32k`` and hymba-1.5b's ``long_500k`` outputs), on the fake
    ``16x16`` world at full size: every argument leaf's bytes equal
    ``repro``'s, and ``repro``'s argument size is their sum less the
    leaves ``jax.jit`` drops as unused; every output leaf's bytes equal
    ``repro``'s (the logits laid out by the batch alone where the
    ``model`` axis does not divide the vocabulary, ``model._served``) but
    whisper's cross-attention keys and values, whole over ``model`` where
    XLA splits their heads two ways."""
    port = _result(started, "leaves")[cell]
    _held_leaf_by_leaf(cell, port, PINS["leaves"]["repro"][cell])


@pytest.mark.parametrize("cell", _leaf_cells())
def test_pinned_leaf_bytes_equal_repro(cell):
    """The same on both meshes for the port's side as
    ``tools/lm_dryrun_pins.py`` pinned it."""
    _held_leaf_by_leaf(cell, PINS["leaves"]["port"][cell],
                       PINS["leaves"]["repro"][cell])


# ---------------------------------------------------------------------------
# ``ssm.scan`` on real tensors: the plain loops it replaced, bit for bit
# ---------------------------------------------------------------------------

def _plain_selective_scan(u, dt, B_t, C_t, a_log, h0, c):
    A = -torch.exp(a_log.float())
    h, ys = h0.float(), []
    for i in range(0, u.shape[1], c):
        uc, dtc = u[:, i:i + c], dt[:, i:i + c]
        bc, cc = B_t[:, i:i + c], C_t[:, i:i + c]
        dec = torch.exp(dtc[..., None].float() * A)
        xin = (dtc * uc)[..., None].float() * bc[:, :, None, :].float()
        a_scan, b_scan = TS._inclusive_scan(dec, xin)
        hs = a_scan * h[:, None] + b_scan
        y = torch.einsum("bcdn,bcn->bcd", hs, cc.float())
        h = hs[:, -1]
        ys.append(y.to(u.dtype))
    return torch.cat(ys, dim=1).to(u.dtype), h


def _plain_mlstm(x, p, cfg, state, c):
    B, S, D = x.shape
    H = cfg.n_heads
    di = D * max(cfg.ssm_expand, 1)
    dh = di // H
    u, z = torch.split(x @ p["in_proj"], di, dim=-1)
    q = TL.split_heads(u @ p["wq"], H, dh)
    q = q / TL.weak(math.sqrt(dh), q)
    k = TL.split_heads(u @ p["wk"], H, dh)
    v = TL.split_heads(u @ p["wv"], H, dh)
    gates = u @ p["w_if"]
    i_gate = gates[..., :H]
    f_gate = torch.nn.functional.logsigmoid(gates[..., H:].float())
    if state is None:
        C_st = torch.zeros((B, H, dh, dh), dtype=torch.float32)
        n_st = torch.zeros((B, H, dh), dtype=torch.float32)
    else:
        C_st, n_st = state["C"], state["n"]
    mask = (torch.arange(c)[:, None] >= torch.arange(c)[None, :])[
        None, :, :, None]
    hs = []
    for i in range(0, S, c):
        qb, kb, vb = q[:, i:i + c], k[:, i:i + c], v[:, i:i + c]
        ib, fb = i_gate[:, i:i + c], f_gate[:, i:i + c]
        fcum = TS._prefix_sum(fb)
        dec_in = torch.exp(fcum)
        logw = (fcum[:, :, None, :] - fcum[:, None, :, :]
                + ib[:, None, :, :])
        w = torch.exp(torch.where(mask, logw, -math.inf))
        qf, kf, vf = qb.float(), kb.float(), vb.float()
        scores = torch.einsum("bthd,bshd->bths", qf, kf) * w.permute(
            0, 1, 3, 2)
        intra = torch.einsum("bths,bshd->bthd", scores, vf)
        norm_intra = torch.einsum(
            "bths,bshd->bthd", scores, torch.ones_like(vf[..., :1]))[..., 0]
        inter = torch.einsum("bthd,bhde->bthe", qf, C_st) * dec_in[..., None]
        norm_inter = torch.einsum("bthd,bhd->bth", qf, n_st) * dec_in
        denom = torch.clamp(torch.abs(norm_intra + norm_inter), min=1.0)
        h = (intra + inter) / denom[..., None]
        dec_all = torch.exp(fcum[:, -1, None, :] - fcum)
        wk = dec_all * torch.exp(ib.float())
        kv = torch.einsum("bshd,bshe,bsh->bhde", kf, vf, wk)
        C_st = C_st * torch.exp(fcum[:, -1])[:, :, None, None] + kv
        n_st = n_st * torch.exp(fcum[:, -1])[:, :, None] + torch.einsum(
            "bshd,bsh->bhd", kf, wk)
        hs.append(h.to(x.dtype))
    h = torch.cat(hs, dim=1).reshape(B, S, di)
    out = (h * TL.silu(z)) @ p["out_proj"]
    return out, ({"C": C_st, "n": n_st} if state is not None else None)


def _plain_slstm(x, p, state):
    B, S, D = x.shape
    pre = x @ p["w_in"]
    if state is None:
        h = torch.zeros((B, D), dtype=torch.float32)
        c, n, m = torch.zeros_like(h), torch.ones_like(h), torch.zeros_like(h)
    else:
        h, c, n, m = (state[k] for k in "hcnm")
    r_rec = p["r_rec"].float()
    hs = []
    for t in range(S):
        g = pre[:, t].float() + h @ r_rec
        zi, ii, fi, oi = torch.split(g, D, dim=-1)
        z, o = torch.tanh(zi), torch.sigmoid(oi)
        log_f = torch.nn.functional.logsigmoid(fi)
        m_new = torch.maximum(log_f + m, ii)
        i_e = torch.exp(ii - m_new)
        f_e = torch.exp(log_f + m - m_new)
        c = f_e * c + i_e * z
        n = f_e * n + i_e
        h = o * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h.to(x.dtype))
    out = torch.stack(hs, dim=1) @ p["out_proj"]
    return out, ({"h": h, "c": c, "n": n, "m": m}
                 if state is not None else None)


def _same(a, b):
    assert (a is None) == (b is None)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    elif a is not None:
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_scan_equals_the_plain_loop_bit_for_bit(monkeypatch, block, stateful,
                                                dtype):
    """On real tensors ``ssm.scan`` runs every iteration: mamba's chunked
    selective scan, mLSTM and sLSTM (outputs and, given a state, the new
    state) equal copies of the plain Python loops they replaced, bit for
    bit, over 4 chunks (``CHUNK`` 4, 16 positions) of the SMOKE
    configs' widths, with inputs from NumPy seed 0."""
    monkeypatch.setattr(TS, "CHUNK", 4)
    rng = np.random.default_rng(0)

    def rand(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32).to(dtype)

    B, S = 2, 16
    if block == "mamba":
        cfg = get_config("hymba_1_5b", smoke=True)
        di, n = cfg.d_inner, cfg.ssm_state
        u, dt = rand(B, S, di), rand(B, S, di, scale=0.1).abs()
        bt, ct = rand(B, S, n), rand(B, S, n)
        a_log, h0 = rand(di, n), rand(B, di, n).float()
        got = TS._selective_scan_chunked(u, dt, bt, ct, a_log, h0)
        want = _plain_selective_scan(u, dt, bt, ct, a_log, h0, 4)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    cfg = get_config("xlstm_1_3b", smoke=True)
    D = cfg.d_model
    gen = torch.Generator().manual_seed(0)
    x = rand(B, S, D, scale=0.5)
    if block == "mlstm":
        p = TS.init_mlstm(gen, cfg, dtype, "cpu")
        st = TS.init_mlstm_state(cfg, B, "cpu") if stateful else None
        if st:
            st = {k: rand(*v.shape, scale=0.1).float() for k, v in st.items()}
        got = TS.mlstm(x, p, cfg, state=st)
        want = _plain_mlstm(x, p, cfg, st, 4)
    else:
        p = TS.init_slstm(gen, cfg, dtype, "cpu")
        st = TS.init_slstm_state(cfg, B, "cpu") if stateful else None
        if st:
            st = {k: rand(*v.shape, scale=0.1).float() for k, v in st.items()}
        got = TS.slstm(x, p, cfg, state=st)
        want = _plain_slstm(x, p, st)
    _same(got[0], want[0])
    _same(got[1], want[1])
