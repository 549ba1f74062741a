"""Carry inputs across from the JAX package.

Each function turns an object of the JAX package (``repro``) into the
port's equivalent by reading its fields by name.  Nothing here imports
``repro``: any object with the right fields converts, so the tests can
feed both packages identical graphs, configs, programs, runs and update
batches, scenarios and corpus presets, and compare their reports and
dynamic results; :func:`lm_params` carries an LM's weights across.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.algorithms.common import IterStats, RunResult
from repro_torch.core.accel import (DevicePackedProgram, PackedProgram,
                                    PhaseStats, SimReport)
from repro_torch.core.accugraph import AccuGraphConfig
from repro_torch.core.cache import CacheConfig, CacheState
from repro_torch.core.dram import DRAMConfig, DRAMOrganization, DRAMTiming
from repro_torch.core.hitgraph import HitGraphConfig
from repro_torch.core.timing import TraceResult
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.graphs.corpus import GraphPreset
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.updates import UpdateBatch, UpdateStream
from repro_torch.sim.dynamic import DynamicResult, EpochReport
from repro_torch.sim.policy import PartitionPolicy
from repro_torch.sim.reference_model import ReferenceConfig
from repro_torch.sim.scenario import ScenarioSpec
from repro_torch.tree import STACKED, map_tree, unstack


def _fields(obj, cls, **converted):
    """``cls(**{field: obj.field})`` over ``cls``'s dataclass fields, with
    ``converted`` overriding individual fields."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if f.name not in converted}
    return cls(**kw, **converted)


def graph(g) -> Graph:
    return Graph(g.n, np.asarray(g.src), np.asarray(g.dst),
                 None if g.weights is None else np.asarray(g.weights),
                 directed=g.directed, name=g.name)


def cache_config(c):
    return None if c is None else _fields(c, CacheConfig)


def dram_config(d) -> DRAMConfig:
    return _fields(d, DRAMConfig, timing=_fields(d.timing, DRAMTiming),
                   org=_fields(d.org, DRAMOrganization),
                   order=tuple(d.order), cache=cache_config(d.cache))


def _accel_config(cfg, cls):
    return _fields(cfg, cls, dram=(None if cfg.dram is None
                                   else dram_config(cfg.dram)))


def hitgraph_config(cfg) -> HitGraphConfig:
    return _accel_config(cfg, HitGraphConfig)


def accugraph_config(cfg) -> AccuGraphConfig:
    return _accel_config(cfg, AccuGraphConfig)


def reference_config(cfg) -> ReferenceConfig:
    return _accel_config(cfg, ReferenceConfig)


def trace_result(r) -> TraceResult:
    return _fields(r, TraceResult,
                   per_channel_cycles=dict(r.per_channel_cycles),
                   finish=None if r.finish is None else np.asarray(r.finish))


def segmented_trace(t) -> SegmentedTrace:
    return SegmentedTrace(np.asarray(t.line_addr), np.asarray(t.is_write),
                          np.asarray(t.issue), np.asarray(t.offsets),
                          list(t.names))


def trace(t) -> Trace:
    return Trace(np.asarray(t.line_addr), np.asarray(t.is_write),
                 np.asarray(t.issue))


def packed_program(p) -> PackedProgram:
    return _fields(p, PackedProgram, names=list(p.names))


def device_packed_program(p) -> DevicePackedProgram:
    """A device-packed program's arrays as CPU tensors (the block width
    ``K`` read off ``issue``'s shape)."""
    def t(a):
        return torch.from_numpy(np.array(a))

    return _fields(p, DevicePackedProgram, names=list(p.names),
                   issue=t(p.issue), meta=t(p.meta), boundary=t(p.boundary),
                   kind=t(p.kind), L_p=t(p.L_p), hits_p=t(p.hits_p),
                   confl_p=t(p.confl_p), open_row_final=t(p.open_row_final),
                   K=int(np.shape(p.issue)[2]))


def cache_state(s) -> CacheState:
    """A cache state's tags and ages as CPU int64 tensors (copies)."""
    return CacheState(
        tags=torch.from_numpy(np.array(s.tags, dtype=np.int64)),
        age=torch.from_numpy(np.array(s.age, dtype=np.int64)))


def run_result(r) -> RunResult:
    per_iter = [
        IterStats(np.asarray(s.active_before), np.asarray(s.changed),
                  None if s.changed_per_block is None
                  else [None if c is None else np.asarray(c)
                        for c in s.changed_per_block])
        for s in r.per_iter]
    return RunResult(np.asarray(r.values), r.iterations, per_iter)


def update_batch(b) -> UpdateBatch:
    return _fields(b, UpdateBatch)


def update_stream(s) -> UpdateStream:
    return _fields(s, UpdateStream)


def sim_report(r) -> SimReport:
    return _fields(r, SimReport,
                   phases=[_fields(p, PhaseStats) for p in r.phases],
                   stage_seconds={}, kernel_launches={})


def epoch_report(e) -> EpochReport:
    return _fields(e, EpochReport, report=sim_report(e.report))


def dynamic_result(r) -> DynamicResult:
    return DynamicResult(
        epochs=[epoch_report(e) for e in r.epochs],
        report=sim_report(r.report),
        final_values=np.asarray(r.final_values),
        final_graph=graph(r.final_graph),
        checkpoint=(None if r.checkpoint is None
                    else np.asarray(r.checkpoint)))


def graph_preset(p) -> GraphPreset:
    return _fields(p, GraphPreset, params=tuple(p.params))


def scenario_spec(s) -> ScenarioSpec:
    """A scenario by field: names, numbers and ``None`` as they are, each
    object through the converter for its class, a ``Problem`` as its
    string value."""
    convert = {"Graph": graph, "UpdateStream": update_stream,
               "DRAMConfig": dram_config, "CacheConfig": cache_config,
               "HitGraphConfig": hitgraph_config,
               "AccuGraphConfig": accugraph_config,
               "ReferenceConfig": reference_config,
               "PartitionPolicy": lambda p: _fields(p, PartitionPolicy)}

    def axis(v):
        if v is None or isinstance(v, (str, int, float)):
            return v
        return convert[type(v).__name__](v)

    return _fields(s, ScenarioSpec,
                   problem=getattr(s.problem, "value", s.problem),
                   **{f: axis(getattr(s, f)) for f in (
                       "graph", "updates", "memory", "cache", "config",
                       "policy")})


def lm_params(params, cfg, device) -> dict:
    """``repro``'s LM parameter tree (nested dicts of NumPy arrays:
    ``jax.tree.map(np.asarray, params)``) as the port's: the per-layer
    stacks unstacked into lists, every array a tensor of
    ``cfg.param_dtype`` on ``device``.  Every entry point of
    ``repro_torch.models`` takes the result (or ``LM(cfg, result)``)."""
    dtype = getattr(torch, cfg.param_dtype)

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    out = {k: unstack(v, STACKED[k]) if k in STACKED else v
           for k, v in params.items()}
    if "blocks" in out and len(out["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(out['blocks'])} stacked layers, "
                         f"{cfg.name} has {cfg.n_layers}")
    return map_tree(tensor, out)


def lm_opt_state(state, cfg, device) -> dict:
    """``repro``'s AdamW state ``{"m", "v", "step"}`` (NumPy, as
    :func:`lm_params` takes the parameters) as the port's: the moments
    unstacked as the parameters are, ``step`` a 0-d int32 tensor, all on
    ``device``."""
    return {"m": lm_params(state["m"], cfg, device),
            "v": lm_params(state["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
