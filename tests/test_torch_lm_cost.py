"""The LM cost tooling (``repro_torch.core.hbm_adapter``,
``repro_torch.launch.{specs,costmodel,roofline}``) against ``repro``'s on
the CPU:

* ``pattern_fractions()`` and ``effective_bandwidth_fraction`` of every
  family (and decode), exactly; the four traces through the device route's
  plain version (``simulate_trace_device`` on the CPU) equal to the host
  oracle field by field;
* ``cell_cost`` field by field for the ten architectures x ``SHAPES`` x 256
  and 512 chips, ``analyze_cell(...).to_json()`` and ``render_table``,
  exactly (the same float operations in the same order);
* ``input_specs`` and ``params_specs``, the shape and dtype of every leaf,
  for the ten architectures x their supported shapes (``jax.eval_shape``
  on ``repro``'s side, ``meta`` tensors on the port's: nothing is
  allocated);
* ``repro``'s ``test_costmodel_sanity`` and ``test_roofline_rows``
  (``tests/test_dryrun_small.py``) through the port.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core import hbm_adapter as JH
from repro.launch import costmodel as JC
from repro.launch import roofline as JR
from repro.launch import specs as JS

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import hbm_adapter as TH
from repro_torch.core.trace import Trace, bulk_issue
from repro_torch.core.vectorized import simulate_trace_device
from repro_torch.launch import costmodel as TC
from repro_torch.launch import roofline as TR
from repro_torch.launch import specs as TS
from repro_torch.tree import STACKED

CPU = "cpu"
FAMILIES = ("dense", "moe", "hybrid", "vlm", "audio", "ssm")
CELLS = [(a, s) for a in ARCHS for s in TS.SHAPES
         if TS.shape_supported(get_config(a), s)[0]]


def test_pattern_fractions_equal_repro():
    got = TH.pattern_fractions(device=CPU)
    assert got == JH.pattern_fractions()
    assert list(got) == ["stream", "gather", "kv_page", "alltoall"]
    assert 0 < got["gather"] < got["stream"] <= 1


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_effective_bandwidth_fraction_equals_repro(family, decode):
    assert (TH.effective_bandwidth_fraction(family, decode, device=CPU)
            == JH.effective_bandwidth_fraction(family, decode))


def test_tpu_hbm_config_equals_repro():
    t, j = TH.tpu_hbm_config(), JH.tpu_hbm_config()
    assert (t.name, t.channels, t.capacity_bytes, t.peak_gbps) == (
        j.name, j.channels, j.capacity_bytes, j.peak_gbps)
    assert TH.ARCH_PATTERN_MIX == JH.ARCH_PATTERN_MIX


def test_pattern_fractions_need_a_device_or_cpu():
    """The entry point runs on the card unless the caller asks for the
    CPU; the cache is keyed by device type."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TH.pattern_fractions()


@pytest.mark.parametrize("name", ["stream", "gather", "kv_page", "alltoall"])
def test_device_route_plain_version_equals_host(name):
    """The card's route (``simulate_trace_device``, its plain version on
    the CPU) against the host oracle on each pattern's trace, field by
    field."""
    lines = TH.pattern_traces(4096)[name]
    cfg = TH.tpu_hbm_config()
    tr = Trace(lines, np.zeros(len(lines), bool), bulk_issue(len(lines), 0))
    got = simulate_trace_device(tr, cfg, device=CPU)
    want = TH.serve_trace(lines, cfg, torch.device(CPU))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape", TS.SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_repro(arch, shape, chips):
    got = TC.cell_cost(get_config(arch), shape, chips)
    want = JC.cell_cost(j_config(arch), shape, chips)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.useful_fraction == want.useful_fraction


def test_costmodel_tables_equal_repro():
    assert TC.TPU_V5E == JC.TPU_V5E
    assert TS.SHAPE_SPECS.keys() == JS.SHAPE_SPECS.keys()
    for k, v in TS.SHAPE_SPECS.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(JS.SHAPE_SPECS[k])
    for arch in ARCHS:
        for active in (True, False):
            assert (TC.matmul_params(get_config(arch), active)
                    == JC.matmul_params(j_config(arch), active))
        assert (TC.attention_flops_fwd(get_config(arch), 2, 64, 128)
                == JC.attention_flops_fwd(j_config(arch), 2, 64, 128))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analyze_cell_equals_repro(arch, shape):
    rows = []
    for chips, coll, pod in ((256, 5e9, 0.0), (512, 3.5e8, 0.25)):
        got = TR.analyze_cell(get_config(arch), shape, "m", chips, coll,
                              pod, device=CPU)
        want = JR.analyze_cell(j_config(arch), shape, "m", chips, coll, pod)
        assert got.to_json() == want.to_json()
        assert TR.what_would_help(got) == JR.what_would_help(want)
        rows.append((got, want))
    assert (TR.render_table([g for g, _ in rows])
            == JR.render_table([w for _, w in rows]))


def test_render_table_of_every_cell_equals_repro():
    got = [TR.analyze_cell(get_config(a), s, "16x16", 256, 5e9, device=CPU)
           for a, s in CELLS]
    want = [JR.analyze_cell(j_config(a), s, "16x16", 256, 5e9)
            for a, s in CELLS]
    assert TR.render_table(got) == JR.render_table(want)


def test_shape_supported_equals_repro():
    for arch in ARCHS:
        for shape in TS.SHAPES:
            assert (TS.shape_supported(get_config(arch), shape)
                    == JS.shape_supported(j_config(arch), shape))


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _leaves(tree, path=()):
    """``(path, leaf)`` of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


#: the stacked keys of ``repro``'s decode caches (``layers`` per layer,
#: the xLSTM states per group and block)
CACHE_STACKED = {"layers": 1, "m": 2, "s": 1}


def _stacked(tree, stacked=STACKED):
    """The port's tree as ``repro``'s: each per-layer list's leaves as one
    ``(shape, dtype)`` with the list's lengths in front (every layer's
    leaf checked to share it)."""
    def stack(items, axes):
        if axes == 0:
            return {"/".join(p): (tuple(x.shape), _dtype(x))
                    for p, x in _leaves(items)}
        parts = [stack(x, axes - 1) for x in items]
        assert all(p == parts[0] for p in parts), "layers differ"
        return {k: ((len(parts),) + s, d) for k, (s, d) in parts[0].items()}

    out = {}
    for k, v in tree.items():
        if k in stacked and isinstance(v, list):
            out.update({f"{k}/{p}": sd
                        for p, sd in stack(v, stacked[k]).items()})
        else:
            out.update({"/".join((k,) + p): (tuple(x.shape), _dtype(x))
                        for p, x in _leaves(v)})
    return out


def _j_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_equal_repro(arch):
    got = TS.params_specs(get_config(arch))
    assert all(x.device.type == "meta" for _, x in _leaves(got))
    assert _stacked(got) == _j_flat(JS.params_specs(j_config(arch)))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_repro(arch, shape):
    got = TS.input_specs(get_config(arch), shape)
    want = JS.input_specs(j_config(arch), shape)
    assert all(x.device.type == "meta" for _, x in _leaves(got))
    if "cache" in got:
        cache = got.pop("cache")
        jcache = want.pop("cache")
        assert _stacked(cache, CACHE_STACKED) == _j_flat(jcache)
    assert {k: (tuple(v.shape), _dtype(v)) for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


def test_costmodel_sanity():
    """``tests/test_dryrun_small.py::test_costmodel_sanity`` through the
    port."""
    cfg = get_config("qwen3_0_6b")
    train = TC.cell_cost(cfg, "train_4k", 256)
    # 6ND for 0.6B params x 1.05M tokens ~ 3.75e15
    assert 1e15 < train.model_flops < 1e16
    assert train.total_flops >= train.model_flops
    dec = TC.cell_cost(cfg, "decode_32k", 256)
    assert dec.total_flops < train.total_flops
    assert dec.hbm_bytes_per_chip > 0


def test_roofline_rows():
    """``tests/test_dryrun_small.py::test_roofline_rows`` through the
    port."""
    cfg = get_config("command_r_35b")
    row = TR.analyze_cell(cfg, "train_4k", "16x16", 256, 5e9, device=CPU)
    assert row.dominant in ("compute", "memory", "collective")
    assert 0 < row.roofline_fraction <= 1.0
    table = TR.render_table([row])
    assert "command-r-35b" in table
