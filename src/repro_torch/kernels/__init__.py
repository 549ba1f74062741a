"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each with a
plain PyTorch version beside it and a launch counter on its wrapper."""

from typing import Callable, Dict

from repro_torch.analysis import locks

#: the counters are bumped from several threads at once (the sweep's
#: workers, the service's, a caller's own): ``+=`` on an attribute is not
#: atomic, so every count and reset holds this lock
_count_lock = locks.make_lock("kernel-launches")


def count_launch(fn: Callable) -> None:
    """Add one to ``fn.launches``: each wrapper calls this where it
    launches its kernel, and nowhere else."""
    with _count_lock:
        fn.launches += 1


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper, by kernel name; each counts its launches in
    ``<wrapper>.launches``.  ``sweep_min_rounds`` is the round sweep and
    ``sweep_min`` the serial one (the two routes of ``sweep_min_block``);
    ``dram_serve`` is the serve over the records that
    ``serve_prepass`` writes (one launch of each a serve), and
    ``dram_serve_batch`` / ``serve_prepass_batch`` the same for M cases at
    once (a batched sweep's serve);
    ``dram_timing`` is the chunked scan and ``dram_timing_serial`` its
    one-lane counterpart, which no path calls; ``cache_lookup`` is the
    on-chip cache filter's LRU lookup."""
    from repro_torch.kernels.cache_lookup.ops import cache_lookup
    from repro_torch.kernels.dram_timing.ops import (dram_serve,
                                                     dram_serve_batch,
                                                     dram_timing,
                                                     dram_timing_serial,
                                                     serve_prepass,
                                                     serve_prepass_batch)
    from repro_torch.kernels.edge_scatter.ops import edge_scatter
    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    from repro_torch.kernels.spmv_ell.ops import spmv_ell
    from repro_torch.kernels.sweep_min.ops import sweep_min, sweep_min_rounds
    return {"dram_serve": dram_serve, "serve_prepass": serve_prepass,
            "dram_serve_batch": dram_serve_batch,
            "serve_prepass_batch": serve_prepass_batch,
            "dram_timing": dram_timing,
            "dram_timing_serial": dram_timing_serial,
            "sweep_min_rounds": sweep_min_rounds,
            "sweep_min": sweep_min,
            "segment_reduce": segment_reduce, "edge_scatter": edge_scatter,
            "spmv_ell": spmv_ell, "cache_lookup": cache_lookup}


def launch_counts() -> Dict[str, int]:
    """The launch counter of every kernel wrapper, by kernel name."""
    fns = wrappers()
    with _count_lock:
        return {name: fn.launches for name, fn in fns.items()}


def zero_launch_counts() -> None:
    """Set every wrapper's launch counter to 0."""
    fns = wrappers()
    with _count_lock:
        for fn in fns.values():
            fn.launches = 0
