"""``chip_smoke.py``'s phase 12 (the service and the tuner) on the CPU.

The phase's calls live in one function, ``chip_smoke.service_runs``, that
``tools/service_pins.py`` runs through the JAX package to make the pins
and the phase runs through the port on the card.  Here: its workload is
``benchmarks/service_load.py``'s (the same case keys and configs); the
same calls through both packages, at cut sizes and the port on the CPU,
give equal pins (rows, chaos plans, epochs, fronts, exhaustive vectors,
sweeper counters), the faulted service's surviving rows equal the clean
ones, and the tuner's batched serves are one call a dispatch (what the
phase asserts of the card's launches); and the pinned chaos plans are
what both packages' ``chaos.plan`` give for the pinned keys.  Every
compared value is an integer or a float computed from integers, so all
comparisons are exact (no float ``values``; their tolerance would be the
rtol 1e-5 of ``test_torch_sweep_engine.py``).  The disk store is off.
"""

import sys
from pathlib import Path

import pytest

from repro.serve import chaos as r_chaos

from repro_torch.kernels.dram_timing import ops
from repro_torch.serve import chaos as t_chaos

ROOT = Path(__file__).resolve().parents[1]
SCALE, PRESET_SCALE = 0.0001, 0.002


@pytest.fixture(autouse=True)
def _no_disk_store(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    monkeypatch.delenv(r_chaos.ENV_SITES, raising=False)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        from benchmarks import service_load
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke, service_load


def _config(c):
    d = c.config
    return (d.n_pes, d.pipelines, d.partition_elements, d.dram.name,
            d.dram.order, d.dram.channels)


def test_workload_is_the_benchmarks(smoke, monkeypatch):
    chip_smoke, service_load = smoke
    from repro.sim.sweep import case_chaos_key as r_key
    from repro_torch.sim.sweep import case_chaos_key
    want = service_load._workload(SCALE)
    mine = chip_smoke.service_workload("repro_torch", SCALE)
    theirs = chip_smoke.service_workload("repro", SCALE)
    assert len(mine) == len(want) == chip_smoke.SERVICE_CLIENTS * \
        chip_smoke.SERVICE_JOBS_PER_CLIENT
    assert [[case_chaos_key(c) for c in b] for b in mine] == \
        [[r_key(c) for c in b] for b in want] == \
        [[r_key(c) for c in b] for b in theirs]
    assert [[_config(c) for c in b] for b in mine] == \
        [[_config(c) for c in b] for b in want]
    mix = {site: (c.rate, c.max_attempts, c.crash)
           for site, c in service_load.DEFAULT_FAULT_MIX.items()}
    assert mix == chip_smoke.SERVICE_FAULT_MIX
    assert (service_load.CLIENTS, service_load.JOBS_PER_CLIENT,
            service_load.WORKERS) == (chip_smoke.SERVICE_CLIENTS,
                                      chip_smoke.SERVICE_JOBS_PER_CLIENT,
                                      chip_smoke.SERVICE_WORKERS)


def test_pinned_plans_are_both_packages(smoke):
    """The pinned chaos plans, recomputed from the pinned keys by each
    package's ``chaos.plan`` (a pure function of seed, site and key)."""
    chip_smoke, _ = smoke
    for chaos in (r_chaos, t_chaos):
        cfg = chaos.ChaosConfig(seed=chip_smoke.SERVICE_FAULT_SEED, sites={
            site: chaos.SiteConfig(rate=r, max_attempts=a, crash=c)
            for site, (r, a, c) in chip_smoke.SERVICE_FAULT_MIX.items()})
        plans = {k: tuple(chaos.plan(site, k, cfg)
                          for site in chip_smoke.SERVICE_FAULT_MIX)
                 for k in chip_smoke.SERVICE_PINS}
        assert plans == chip_smoke.SERVICE_PLANS
    # the faulted part faults: some case has a plan at some site
    assert any(any(p) for p in chip_smoke.SERVICE_PLANS.values())


def test_service_runs_equal_jax_at_small_scale(smoke, monkeypatch):
    """The phase's calls through both packages at cut sizes (lj 484
    vertices, powerlaw-social 131), the port on the CPU.  The port's
    batched serves are counted as calls of the plain version the CPU runs
    in the kernel's place: one a batched sweeper's dispatch, which is
    what the phase asserts of the card's ``dram_serve_batch`` launches;
    and the resident graph's serves and delta rewrites, counted apart
    from its reference run, one serve an epoch and one ``dram_timing`` an
    update, as the phase asserts of the card's."""
    chip_smoke, _ = smoke
    calls, by_part = {}, {}
    for name in ("dram_serve_batch_ref", "dram_serve_ref",
                 "dram_timing_ref"):
        def counting(*args, _plain=getattr(ops, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args, **kw)

        monkeypatch.setattr(ops, name, counting)

    def on_part(name):
        by_part[name] = dict(calls)
        calls.clear()

    got = chip_smoke.service_runs("repro_torch", scale=SCALE,
                                  preset_scale=PRESET_SCALE,
                                  on_part=on_part, device="cpu")
    want = chip_smoke.service_runs("repro", scale=SCALE,
                                   preset_scale=PRESET_SCALE,
                                   parts=("clean", "resident", "tuner"))
    mine = chip_smoke.service_pin_values(got)
    theirs = chip_smoke.service_pin_values(want)
    assert set(mine) == set(theirs) == {
        "SERVICE_GRAPHS", "SERVICE_PLANS", "SERVICE_PINS",
        "SERVICE_EPOCH_PINS", "TUNE_SEARCH", "TUNE_EXHAUSTIVE",
        "TUNE_SWEEP_STATS"}
    for name in theirs:
        assert mine[name] == theirs[name], name
    n_jobs = chip_smoke.SERVICE_CLIENTS * chip_smoke.SERVICE_JOBS_PER_CLIENT
    clean, faulted = got["clean"], got["faulted"]
    assert clean["done"] == n_jobs and clean["stats"]["retries"] == 0
    assert faulted["injected"]
    assert faulted["jobs"] + faulted["shed"] == n_jobs
    assert (faulted["done"], faulted["shed"], len(faulted["rows"])) == (
        n_jobs, 0, n_jobs)
    assert faulted["stats"]["quarantined"] == 0
    assert sorted(faulted["injected"]) == \
        chip_smoke.service_injections(got["plans"])
    for k, row in faulted["rows"].items():
        assert row.report == clean["rows"][k].report
    for name, search in got["tuner"]["searches"].items():
        assert chip_smoke.search_pin(search)["front"] == \
            mine["TUNE_SEARCH"]["front"], name
    local = got["resident"]["run_dynamic"].epochs
    assert got["resident"]["epochs"][1:] == local[1:3]
    updates = chip_smoke.SERVICE_UPDATES
    assert by_part["resident"] == {"dram_serve_ref": updates + 1,
                                   "dram_timing_ref": updates}
    assert by_part["resident_reference"]["dram_serve_ref"] == len(local)
    stats = got["tuner"]["stats"]
    batched = by_part["tuner"].get("dram_serve_batch_ref", 0)
    assert batched == sum(s["batch_dispatches"] for s in stats.values())
    assert batched > 0
