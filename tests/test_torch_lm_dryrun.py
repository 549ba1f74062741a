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
