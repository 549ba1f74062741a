"""repro_torch.tune — accelerator design-space search over the sweep
engine.

Declare a :class:`DesignSpace` (or take an accelerator's default via
``get_accelerator(name).design_space()``), hand it to a
:class:`SearchDriver` with a :class:`HalvingBudget`, and get back a
seed-deterministic Pareto front (cycles vs DRAM requests vs BRAM bytes)
per graph scenario, equal to the JAX package's for the same seed.  The
driver evaluates on the card unless ``device=`` says otherwise.
"""

from repro_torch.tune.halving import (HalvingBudget, RungReport,
                                      SearchDriver, SearchResult,
                                      SearchStats)
from repro_torch.tune.pareto import (OBJECTIVES, FrontEntry, bram_bytes_of,
                                     dominates, front_of_rows,
                                     objectives_of, pareto_front)
from repro_torch.tune.sampler import (SampleStats, crossover, make_rng,
                                      mutate, sample)
from repro_torch.tune.space import (CASE_DIMS, Constraint, DesignPoint,
                                    DesignSpace, Dimension, InvalidPoint,
                                    value_label)

__all__ = [
    "CASE_DIMS", "Constraint", "DesignPoint", "DesignSpace",
    "Dimension", "FrontEntry", "HalvingBudget", "InvalidPoint",
    "OBJECTIVES", "RungReport", "SampleStats", "SearchDriver",
    "SearchResult", "SearchStats", "bram_bytes_of", "crossover",
    "dominates", "front_of_rows", "make_rng", "mutate",
    "objectives_of", "pareto_front", "sample", "value_label",
]
