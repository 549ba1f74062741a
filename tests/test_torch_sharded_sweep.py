"""Device-count invariance of the port's sharded sweep, on the CPU.

``Sweeper(devices=N)`` shards each batched serve's cases over a 1-D case
mesh (``repro_torch.launch.mesh.make_sweep_mesh``).  The contract, as in
the JAX package's ``test_sharded_sweep.py``: sweep rows are bit-identical
for any (workers, devices), clean and under a chaos fault plan retried by
the service.  The host's device count is mocked to 4 with
``REPRO_TORCH_HOST_DEVICES`` (the port's counterpart of JAX's
``--xla_force_host_platform_device_count``), set with ``monkeypatch``;
each mesh entry then serves its shard with the plain version.  Rows are
held to the JAX package's ``devices=1`` rows (its own test holds its
``devices=4`` rows to those).  Also: both sharded serves called directly
(M = 3 cases over meshes of 1 to 4 entries, so padded), validation, the
façade conflict and mesh oversubscription.
"""

import numpy as np
import pytest
import torch

from repro.core import vectorized as r_vec
from repro.core.accel import pack_program as r_pack_program
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.sim.memory import timing_variants as r_timing_variants
from repro.sim.sweep import SweepCase as RSweepCase
from repro.sim.sweep import Sweeper as RSweeper
from repro.sim.sweep import sweep as r_sweep

from repro_torch import interop
from repro_torch.core import vectorized as vec
from repro_torch.distributed.sharding import (
    sharded_fused_scan_batch, sharded_fused_scan_batch_shared)
from repro_torch.launch.mesh import HOST_DEVICES_ENV, make_sweep_mesh
from repro_torch.serve import chaos
from repro_torch.serve.engine import BreakerConfig, RetryPolicy, SimService
from repro_torch.sim.memory import timing_variants
from repro_torch.sim.sweep import SweepCase, Sweeper, sweep

CPU = torch.device("cpu")

# four same-geometry timing points -> ONE signature group of 4 cases a
# problem, so devices=4 shards one case a device
KINDS = ("ddr3-1066", "ddr3-1333", "ddr3-1866", "ddr4-2133")
MEMS = timing_variants("ddr3", kinds=KINDS)
R_MEMS = r_timing_variants("ddr3", kinds=KINDS)
KW = dict(graphs=["karate"], problems=["wcc", "pr"],
          accelerators=["hitgraph"], batch_memories=True)
PLACEMENTS = (("d1", 1, 1), ("d2w2", 2, 2), ("d4", 4, 1))


def chaos_config():
    return chaos.ChaosConfig(seed=7, sites={
        "sweep.prepare": chaos.SiteConfig(rate=0.7, max_attempts=2),
        "dram.serve": chaos.SiteConfig(rate=0.5, max_attempts=1)})


def digest(rows):
    out = []
    for r in rows:
        d = r.as_dict()
        d.pop("wall_s")
        out.append(d)
    return out


@pytest.fixture(scope="module")
def jax_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_GRAPH_CACHE", "0")
        rows = r_sweep(**KW, memories=R_MEMS,
                       sweeper=RSweeper(batch_memories=True))
    return rows


@pytest.fixture(scope="module")
def forced4():
    """Every placement's clean rows and sweeper, and the service's rows
    under the chaos plan at 1 and 4 devices, on a host mocked to 4."""
    out = {"clean": {}, "sweepers": {}, "chaos": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_GRAPH_CACHE", "0")
        mp.setenv(HOST_DEVICES_ENV, "4")
        mp.delenv("REPRO_CHAOS_SEED", raising=False)
        mp.delenv("REPRO_CHAOS_SITES", raising=False)
        for name, dev, wrk in PLACEMENTS:
            sw = Sweeper(batch_memories=True, workers=wrk, devices=dev,
                         device=CPU)
            out["clean"][name] = sweep(**KW, memories=MEMS, sweeper=sw)
            out["sweepers"][name] = sw
        cases = [SweepCase("karate", p, accelerator="hitgraph", memory=m)
                 for p in ("wcc", "pr") for m in MEMS]
        fast = RetryPolicy(retries=6, backoff_base_s=0.001,
                           backoff_cap_s=0.01)
        for name, dev in (("d1", 1), ("d4", 4)):
            with chaos.scope(chaos_config()):
                with SimService(batch_memories=True, devices=dev,
                                retry=fast,
                                breaker=BreakerConfig(threshold=10_000),
                                device=CPU) as svc:
                    out["chaos"][name] = svc.result(
                        svc.submit(list(cases)), timeout=240)
                    out["chaos_stats", name] = svc._sweeper.stats
    return out


class TestDeviceCountInvariance:
    @pytest.mark.parametrize("name", ["d1", "d2w2", "d4"])
    def test_rows_bit_identical_across_devices(self, forced4, jax_rows,
                                               name):
        rows = forced4["clean"][name]
        assert digest(rows) == digest(jax_rows)
        for row, r_row in zip(rows, jax_rows):
            assert row.report == interop.sim_report(r_row.report)

    def test_multi_device_runs_actually_sharded(self, forced4):
        stats = {n: sw.stats for n, sw in forced4["sweepers"].items()}
        assert stats["d1"].sharded_dispatches == 0
        assert stats["d4"].sharded_dispatches > 0
        assert stats["d2w2"].sharded_dispatches > 0
        # the grid's one batched group (8 cases, the WCC and PR packs
        # stacked) is sharded
        for name in ("d4", "d2w2"):
            assert (stats[name].sharded_dispatches
                    == stats[name].batch_dispatches == 1)
        assert [stats[n].devices for n in ("d1", "d2w2", "d4")] == [1, 2, 4]
        assert len(forced4["sweepers"]["d4"]._sweep_mesh()) == 4

    def test_concurrent_shared_groups(self, monkeypatch):
        """Two signature groups (DDR3 and HBM2 geometry), each one pack
        shared by its timing cases, served concurrently (``workers=2``) and each sharded over 2
        devices: rows equal to the JAX package's ``devices=1`` rows."""
        monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
        monkeypatch.setenv(HOST_DEVICES_ENV, "2")
        kw = dict(graphs=["karate"], problems=["wcc"],
                  accelerators=["hitgraph"], batch_memories=True)
        sw = Sweeper(batch_memories=True, workers=2, devices=2, device=CPU)
        rows = sweep(**kw, memories=MEMS + timing_variants(
            "hbm2", kinds=KINDS[:2]), sweeper=sw)
        r_rows = r_sweep(**kw, memories=R_MEMS + r_timing_variants(
            "hbm2", kinds=KINDS[:2]))
        assert digest(rows) == digest(r_rows)
        assert sw.stats.sharded_dispatches == sw.stats.batch_dispatches == 2

    def test_chaos_rows_bit_identical_across_devices(self, forced4):
        """Fault plans + retries: surviving rows equal for any device
        count, and equal to the clean rows."""
        assert digest(forced4["chaos"]["d4"]) == digest(
            forced4["chaos"]["d1"])
        assert digest(forced4["chaos"]["d1"]) == digest(
            forced4["clean"]["d1"])
        assert forced4["chaos_stats", "d4"].sharded_dispatches > 0
        assert forced4["chaos_stats", "d1"].sharded_dispatches == 0


class TestShardedSweepSurface:
    def test_devices_validation(self):
        with pytest.raises(ValueError, match="devices"):
            Sweeper(devices=0, device=CPU)
        with pytest.raises(ValueError, match="devices"):
            SimService(devices=0, device=CPU)

    def test_facade_conflict_with_provided_sweeper(self):
        sw = Sweeper(devices=1, device=CPU)
        with pytest.raises(ValueError, match="devices"):
            sweep(graphs=["karate"], problems=["wcc"], devices=2,
                  sweeper=sw)
        # the sweeper's own count is no conflict
        sw2 = Sweeper(devices=2, device=CPU)
        assert sweep(cases=[], devices=2, sweeper=sw2) == []

    def test_mesh_rejects_oversubscription(self, monkeypatch):
        monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
        with pytest.raises(ValueError, match="devices=2 exceeds the 1 "
                                             f".*{HOST_DEVICES_ENV}"):
            make_sweep_mesh(2, CPU)
        assert make_sweep_mesh(1, CPU) == [CPU]
        monkeypatch.setenv(HOST_DEVICES_ENV, "3")
        assert make_sweep_mesh(3, "cpu") == [CPU] * 3
        with pytest.raises(ValueError, match="devices=4"):
            make_sweep_mesh(4, CPU)
        with pytest.raises(ValueError, match="devices must be >= 1"):
            make_sweep_mesh(0, CPU)
        monkeypatch.setenv(HOST_DEVICES_ENV, "zero")
        with pytest.raises(ValueError, match=HOST_DEVICES_ENV):
            make_sweep_mesh(1, CPU)

    def test_one_device_host_raises_only_at_a_sharded_serve(
            self, monkeypatch):
        """``Sweeper(devices=2)`` on a one-device host constructs and runs
        what it does not shard; its first sharded serve raises, naming the
        visible count."""
        monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
        monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
        sw = Sweeper(batch_memories=True, devices=2, device=CPU)
        one = sw.run([SweepCase("karate", "wcc", accelerator="hitgraph")])
        assert sw.stats.sharded_dispatches == 0 and len(one) == 1
        with pytest.raises(ValueError, match="exceeds the 1 visible"):
            sw.run([SweepCase("karate", "wcc", accelerator="hitgraph",
                              memory=m) for m in MEMS[:2]])


def _program(seed, n_phases):
    rng = np.random.default_rng(seed)
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, 300))
        lines = rng.integers(0, 1 << 16, n)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return RSegmentedTrace.from_phases(phases)


def _timings(M, seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 40, size=(M, 7)).astype(np.int32)
    t[:, 4] = rng.integers(1, 5, size=M)
    return t


@pytest.mark.parametrize("entries", [1, 2, 3, 4])
@pytest.mark.parametrize("shared", [True, False])
def test_sharded_serves_equal_unsharded(entries, shared):
    """M = 3 cases over ``entries`` mesh entries (padded with replicas of
    case 0 where 3 does not divide): finishes and carries equal the
    unsharded port serve and the JAX package's, exactly."""
    cfg = R_PRESETS["hitgraph"]()
    B, bpr = cfg.banks_per_channel, cfg.org.banks
    timing = _timings(3, seed=entries)
    mesh = [CPU] * entries
    if shared:
        p = r_pack_program(_program(11, 4), cfg)
        streams = (p.issue, p.meta, p.boundary)
        want_f, want_c = r_vec.fused_scan_batch_shared(*streams, timing,
                                                       B, bpr)
        got_f, got_c = sharded_fused_scan_batch_shared(
            *streams, timing, B, bpr, mesh, CPU)
    else:
        packs = [r_pack_program(_program(11, 4), cfg)]
        seed = 12
        while len(packs) < 3:
            q = r_pack_program(_program(seed, 4), cfg)
            if q.issue.shape == packs[0].issue.shape:
                packs.append(q)
            seed += 1
        streams = [np.stack([getattr(q, f) for q in packs])
                   for f in ("issue", "meta", "boundary")]
        want_f, want_c = r_vec.fused_scan_batch(*streams, timing, B, bpr)
        got_f, got_c = sharded_fused_scan_batch(*streams, timing, B, bpr,
                                                mesh, CPU)
    plain_f, plain_c = vec.fused_scan_batch(*streams, timing, B, bpr, CPU)
    assert got_f.shape == (3,) + tuple(np.shape(streams[0])[-3:])
    assert torch.equal(got_f, plain_f)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert len(got_c) == len(want_c) == 5
    for a, b, c in zip(got_c, plain_c, want_c):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_sharded_serve_launches_one_batch_a_shard(monkeypatch):
    """Each shard is one ``fused_scan_batch`` (one ``dram_serve_batch``
    call) on its entry, the shared program copied once a distinct device,
    the pad cases replicas of case 0."""
    cfg = R_PRESETS["accugraph"]()
    B, bpr = cfg.banks_per_channel, cfg.org.banks
    p = r_pack_program(_program(3, 3), cfg)
    calls = []
    real = vec.fused_scan_batch

    def spy(issue, meta, boundary, timing, *rest):
        calls.append((issue, timing.clone()))
        return real(issue, meta, boundary, timing, *rest)
    monkeypatch.setattr(vec, "fused_scan_batch", spy)
    timing = _timings(5, seed=1)
    sharded_fused_scan_batch_shared(p.issue, p.meta, p.boundary, timing, B,
                                    bpr, [CPU] * 3, CPU)
    assert len(calls) == 3
    assert all(issue is calls[0][0] for issue, _ in calls)
    got = torch.cat([t for _, t in calls])
    want = np.concatenate([timing, timing[:1]])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pad", [0, 1, 3])
def test_pad_cases_equal_jax(pad):
    """The pad rows are replicas of case 0, as the JAX package pads, for
    arrays and tensors."""
    from repro.distributed.sharding import _pad_cases as r_pad_cases
    from repro_torch.distributed.sharding import _pad_cases, _shard_rows
    arr = np.arange(24, dtype=np.int32).reshape(3, 4, 2)
    want = np.asarray(r_pad_cases(arr, pad))
    np.testing.assert_array_equal(_pad_cases(arr, pad), want)
    np.testing.assert_array_equal(
        _pad_cases(torch.from_numpy(arr), pad).numpy(), want)
    # every shard of a 2-, 3- and 4-entry mesh is its slice of the pad
    for D in (2, 3, 4):
        per = -(-3 // D)
        padded = np.asarray(r_pad_cases(arr, per * D - 3))
        for k in range(D):
            np.testing.assert_array_equal(
                _shard_rows(arr, k * per, (k + 1) * per, 3),
                padded[k * per:(k + 1) * per])
