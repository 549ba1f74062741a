"""Dataset registry mirroring the paper's Tab. 1.

True statistics of the benchmark graphs are recorded; ``instantiate``
produces seeded synthetic stand-ins at a configurable ``scale`` fraction
(n and m scaled together, degree structure preserved by family):

* social / web graphs -> ``degree_matched`` with skew fit from the
  published avg-degree / SCC profile,
* rmat-24-16 / rmat-21-86 -> faithful R-MAT regeneration,
* roadnet-ca -> 2-D grid (high diameter, constant degree).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.graphs import generators as gen
from repro_torch.graphs.formats import Graph


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    abbr: str
    vertices: int
    edges: int
    directed: bool
    avg_degree: float
    diameter: int
    scc_ratio: float
    family: str                      # social | rmat | road
    rmat_scale: Optional[int] = None
    rmat_degree: Optional[int] = None
    skew: float = 0.9


TABLE1: Dict[str, DatasetSpec] = {
    s.abbr: s
    for s in [
        DatasetSpec("live-journal", "lj", 4_847_571, 68_993_773, True,
                    14.23, 16, 0.790, "social", skew=0.85),
        DatasetSpec("wiki-talk", "wt", 2_394_385, 5_021_410, True,
                    2.10, 11, 0.047, "social", skew=1.15),
        DatasetSpec("twitter", "tw", 41_652_230, 1_468_364_884, True,
                    35.25, 75, 0.804, "social", skew=0.95),
        DatasetSpec("rmat-24-16", "r24", 16_777_216, 268_435_456, True,
                    16.0, 19, 0.023, "rmat", rmat_scale=24, rmat_degree=16),
        DatasetSpec("rmat-21-86", "r21", 2_097_152, 180_355_072, True,
                    86.0, 14, 0.103, "rmat", rmat_scale=21, rmat_degree=86),
        DatasetSpec("roadnet-ca", "rd", 1_971_281, 2_766_607, False,
                    2.81, 849, 0.993, "road"),
        DatasetSpec("berk-stan", "bk", 685_231, 7_600_595, True,
                    11.09, 514, 0.489, "social", skew=0.8),
        DatasetSpec("orkut", "or", 3_072_627, 117_185_083, False,
                    76.28, 9, 1.000, "social", skew=0.6),
        DatasetSpec("youtube", "yt", 1_157_828, 2_987_624, False,
                    5.16, 20, 0.980, "social", skew=0.9),
        DatasetSpec("dblp", "db", 425_957, 1_049_866, False,
                    4.93, 21, 0.744, "social", skew=0.7),
        DatasetSpec("slashdot", "sd", 82_168, 948_464, True,
                    11.54, 13, 0.868, "social", skew=0.8),
    ]
}


def instantiate(abbr: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """Build the (scaled) stand-in for Tab. 1 dataset ``abbr``.

    ``scale`` multiplies n; m scales with it so avg degree is preserved.
    """
    spec = TABLE1[abbr]
    n = max(int(spec.vertices * scale), 64)
    m = max(int(spec.edges * scale), 128)
    if spec.family == "rmat":
        log_n = max(int(round(math.log2(n))), 6)
        g = gen.rmat(log_n, spec.rmat_degree, seed=seed, name=spec.name)
    elif spec.family == "road":
        side = max(int(math.sqrt(n)), 8)
        g = gen.grid_road(side, seed=seed, name=spec.name)
    else:
        g = gen.degree_matched(n, m, skew=spec.skew, seed=seed,
                               name=spec.name)
    if not spec.directed:
        g = dataclasses.replace(g, directed=False)
    return g
