"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), each with a
plain PyTorch version beside it and a launch counter on its wrapper."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """The launch counter of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.dram_timing.ops import dram_serve, dram_timing
    from repro_torch.kernels.sweep_min.ops import sweep_min
    return {"dram_serve": dram_serve.launches,
            "dram_timing": dram_timing.launches,
            "sweep_min": sweep_min.launches}
