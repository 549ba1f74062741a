"""The dry run's live bytes do not depend on Python's collector.

``launch.dryrun._Counter`` counts a storage as live until its finalizer
runs.  An op with no DTensor strategy (an ``einsum`` under inference
mode) raises ``NotImplementedError`` from a frame that keeps the failure
it chains in a local: a reference cycle that held the caller's frames,
and a recurrence chunk's tensors, until the collector ran
(``_propagation_unseen`` now clears that frame).  Each run here is a
process of its own under ``gc.disable()`` or ``gc.set_threshold(1)``:

* the prefills of ``test_torch_lm_dryrun.py``'s
  ``test_counted_recurrences_equal_dispatched_ones`` (hymba-1.5b and
  xlstm-1.3b at published widths, cut in depth and length, on a fake
  ``16x16`` world), counted and dispatched: all four runs of an
  architecture give the same ``temp_bytes_per_device`` (and every other
  measured field), and the two counted runs dispatch the same iterations;
* the pinned cells themselves (``prefill_32k`` at full depth on 16x16,
  recurrences counted): argument, output and temp bytes equal to
  ``tools/lm_dryrun_pins.json`` under both settings.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_lm_dryrun import LOOP_CELLS, LOOPS_SCRIPT

ROOT = Path(__file__).resolve().parents[1]
PINS = json.loads((ROOT / "tools" / "lm_dryrun_pins.json").read_text())
TIMEOUT_S = 900
SETTINGS = {"disabled": "gc.disable()", "threshold_1": "gc.set_threshold(1)"}

#: a pinned cell on the fake 16x16 world; prints the measured fields
PINNED_SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_production_mesh

arch, shape = sys.argv[1], sys.argv[2]
with DR.fake_world(256):
    mesh = make_production_mesh(device="cpu")
    got = DR.measure(get_config(arch), shape, mesh, False, "cpu")
print(json.dumps(got))
"""


def _under(setting: str, script: str) -> str:
    return f"import gc\n{SETTINGS[setting]}\n{script}"


@pytest.fixture(scope="module")
def runs():
    """Every run, started at once; ``get(key)`` waits for one and parses
    its last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for setting in SETTINGS:
        for arch, (cut, seq) in LOOP_CELLS.items():
            for mode in ("counted", "dispatched"):
                procs[arch, mode, setting] = subprocess.Popen(
                    [sys.executable, "-c", _under(setting, LOOPS_SCRIPT),
                     arch, json.dumps(cut), str(seq), mode], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
            procs[arch, "pinned", setting] = subprocess.Popen(
                [sys.executable, "-c", _under(setting, PINNED_SCRIPT), arch,
                 "prefill_32k"], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    results = {}

    def get(key):
        if key not in results:
            out, err = procs[key].communicate(timeout=TIMEOUT_S)
            assert procs[key].returncode == 0, err[-4000:]
            results[key] = json.loads(out.strip().splitlines()[-1])
        return results[key]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("arch", list(LOOP_CELLS))
def test_counted_and_dispatched_live_bytes_ignore_the_collector(runs, arch):
    got = {(mode, setting): dict(runs((arch, mode, setting)))
           for mode in ("counted", "dispatched") for setting in SETTINGS}
    temps = {k: v["temp_bytes_per_device"] for k, v in got.items()}
    assert len(set(temps.values())) == 1, temps
    assert next(iter(temps.values())) > 0
    repeated = {k: v.pop("repeated") for k, v in got.items()}
    assert repeated["counted", "disabled"] == \
        repeated["counted", "threshold_1"] > 0, repeated
    assert repeated["dispatched", "disabled"] == \
        repeated["dispatched", "threshold_1"] == 0, repeated
    first = got["counted", "disabled"]
    for key, fields in got.items():
        assert fields == first, key


@pytest.mark.parametrize("arch", list(LOOP_CELLS))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_pinned_prefill_equals_the_pins_under_either_setting(runs, arch,
                                                            setting):
    pin = next(c for c in PINS["port"] if (c["arch"], c["shape"], c["mesh"])
               == (arch, "prefill_32k", "16x16"))
    got = runs((arch, "pinned", setting))
    for field in ("arg_bytes_per_device", "output_bytes_per_device",
                  "temp_bytes_per_device"):
        assert got[field] == pin[field], (field, got[field], pin[field])
