"""HBM access-pattern adapter: the paper's technique applied to the LM
training/serving framework (a port of ``repro.core.hbm_adapter``).

The paper's insight — performance of memory-bound workloads is predictable
from the off-chip request stream alone — applied to the roofline
(``launch/roofline.py``): the memory term uses *peak* HBM bandwidth; this
adapter refines it to an *achievable* bandwidth per dominant access
pattern by generating the pattern's line trace and serving it through the
same DRAM model used for the graph accelerators.

Patterns modelled:

* ``stream``   — sequential weight/activation streaming (dense matmuls);
* ``gather``   — embedding-row gathers (rows of ``d_model * bytes``,
  random row order);
* ``kv_page``  — paged KV-cache reads during decode (page-sized runs at
  random page addresses);
* ``alltoall`` — MoE expert dispatch write bursts (expert-strided).

The traces are drawn with NumPy's ``default_rng(seed)`` exactly as
``repro`` draws them.  On the card each is served by
:func:`repro_torch.core.vectorized.simulate_trace_device`, one
``dram_timing`` launch a trace; with ``device="cpu"`` by the host's
element oracle :func:`repro_torch.core.timing.simulate_trace`.  Both give
``repro``'s fractions exactly.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig, hbm2e
from repro_torch.core.timing import TraceResult, simulate_trace
from repro_torch.core.trace import Trace, bulk_issue
from repro_torch.device import resolve_device


def tpu_hbm_config() -> DRAMConfig:
    """``repro``'s model of one v5e-class TPU chip's HBM neighbourhood,
    copied for parity: 16 HBM2E pseudo-channels, channel-interleaved
    addressing (the controller stripes consecutive lines across channels),
    819 GB/s peak at cache-line granularity.  A model constant of the TPU
    side, not a measured number and not the H100's HBM3."""
    return hbm2e(channels=16)      # default (channel-first) interleave


def serve_trace(lines: np.ndarray, cfg: DRAMConfig, device) -> TraceResult:
    """``lines`` issued all at cycle 0, served on ``device``'s route."""
    tr = Trace(lines, np.zeros(len(lines), bool), bulk_issue(len(lines), 0))
    if device.type == "cpu":
        return simulate_trace(tr.line_addr, tr.issue, cfg)
    from repro_torch.core.vectorized import simulate_trace_device
    return simulate_trace_device(tr, cfg, device=device)


def _run(lines: np.ndarray, cfg: DRAMConfig, device) -> float:
    return serve_trace(lines, cfg, device).bandwidth_fraction


def pattern_traces(n_lines: int = 16384, seed: int = 0) -> Dict[str,
                                                                 np.ndarray]:
    """The four patterns' line traces, drawn as ``repro`` draws them."""
    cfg = tpu_hbm_config()
    rng = np.random.default_rng(seed)
    total_lines = cfg.capacity_bytes // CACHE_LINE_BYTES
    out: Dict[str, np.ndarray] = {}

    # sequential streaming
    out["stream"] = np.arange(n_lines, dtype=np.int64)

    # embedding gather: random rows of 32 lines (2 KiB ~ d_model=1k bf16;
    # larger d_model streams even better, this is the conservative case)
    rows = rng.integers(0, total_lines // 32, n_lines // 32)
    emb = (rows[:, None] * 32
           + np.arange(32, dtype=np.int64)[None, :]).ravel()
    out["gather"] = emb.astype(np.int64)

    # paged KV reads: 2 KiB pages (32 lines) at random page addresses
    pages = rng.integers(0, total_lines // 32, n_lines // 32)
    kv = (pages[:, None] * 32
          + np.arange(32, dtype=np.int64)[None, :]).ravel()
    out["kv_page"] = kv.astype(np.int64)

    # MoE dispatch: expert-strided bursts of 64 lines (4 KiB chunks —
    # one token's d_model slab per expert buffer)
    experts = rng.integers(0, 64, max(n_lines // 64, 1))
    base = experts * (total_lines // 64)
    offs = rng.integers(0, total_lines // 64 - 64, len(experts))
    moe = ((base + offs)[:, None]
           + np.arange(64, dtype=np.int64)[None, :]).ravel()
    out["alltoall"] = moe.astype(np.int64)
    return out


def pattern_fractions(n_lines: int = 16384, seed: int = 0,
                      device=None) -> Dict[str, float]:
    """Achievable-bandwidth fraction per access pattern, on ``device``
    (default the card), cached by device type."""
    return dict(_fractions(n_lines, seed, resolve_device(device).type))


@functools.lru_cache(maxsize=None)
def _fractions(n_lines: int, seed: int, device_type: str):
    cfg = tpu_hbm_config()
    dev = resolve_device(device_type)
    return tuple((name, _run(lines, cfg, dev)) for name, lines in
                 pattern_traces(n_lines, seed).items())


# Which pattern dominates the HLO bytes of each architecture family, used
# by the roofline report.  Mixes are (pattern -> weight) summing to 1.
ARCH_PATTERN_MIX: Dict[str, Dict[str, float]] = {
    "dense": {"stream": 0.92, "gather": 0.08},
    "moe": {"stream": 0.75, "alltoall": 0.20, "gather": 0.05},
    "hybrid": {"stream": 0.90, "gather": 0.10},
    "vlm": {"stream": 0.92, "gather": 0.08},
    "audio": {"stream": 0.95, "gather": 0.05},
    "ssm": {"stream": 0.95, "gather": 0.05},
    "decode": {"kv_page": 0.70, "stream": 0.30},
}


def effective_bandwidth_fraction(family: str, decode: bool = False,
                                 device=None) -> float:
    """Weighted achievable-bandwidth fraction for an arch family."""
    mix = ARCH_PATTERN_MIX["decode" if decode else family]
    fr = pattern_fractions(device=device)
    return float(sum(w * fr[p] for p, w in mix.items()))
