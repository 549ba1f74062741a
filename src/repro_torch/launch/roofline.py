"""Three-term roofline per (architecture x shape x mesh) (a port of
``repro.launch.roofline``: the same float operations in the same order, so
every row equals ``repro``'s).

  compute    = total_flops / (chips * peak_flops)
  memory     = hbm_bytes_per_chip / hbm_bw        [+ effective variant
               refined by the paper-technique HBM adapter]
  collective = collective_bytes_per_chip / link_bw

FLOPs and HBM bytes come from the analytic model
(``launch/costmodel.py``); collective bytes are the caller's.  The
dominant term is the bottleneck; the roofline fraction = compute /
dominant.  The peaks are ``repro``'s TPU v5e model (``TPU_V5E``), so a row
is a TPU-side estimate, never a number of the card.
"""

from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.hbm_adapter import effective_bandwidth_fraction
from repro_torch.launch.costmodel import TPU_V5E, cell_cost
from repro_torch.launch.specs import SHAPE_SPECS
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    memory_eff_s: float
    collective_s: float
    dominant: str
    model_flops: float
    total_flops: float
    useful_fraction: float
    roofline_fraction: float
    note: str = ""

    def to_json(self):
        return dataclasses.asdict(self)


def analyze_cell(cfg: ModelConfig, shape: str, mesh_name: str,
                 chips: int, collective_bytes_per_chip: float,
                 pod_collective_frac: float = 0.0,
                 device=None) -> RooflineRow:
    """The row of one cell; the HBM fractions are served on ``device``
    (default the card; ``pattern_fractions`` caches them)."""
    cost = cell_cost(cfg, shape, chips)
    hw = TPU_V5E
    compute = cost.total_flops / (chips * hw["peak_flops"])
    memory = cost.hbm_bytes_per_chip / hw["hbm_gbps"]
    decode = SHAPE_SPECS[shape].kind == "decode"
    frac = effective_bandwidth_fraction(cfg.family, decode=decode,
                                        device=device)
    memory_eff = memory / max(frac, 1e-3)
    # pod-axis traffic crosses DCI; the rest rides ICI
    coll = (collective_bytes_per_chip * (1 - pod_collective_frac)
            / hw["ici_gbps"]
            + collective_bytes_per_chip * pod_collective_frac
            / hw["dci_gbps"])
    terms = {"compute": compute, "memory": memory_eff, "collective": coll}
    dominant = max(terms, key=terms.get)
    rf = compute / max(max(terms.values()), 1e-12)
    return RooflineRow(
        arch=cfg.name, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=compute, memory_s=memory, memory_eff_s=memory_eff,
        collective_s=coll, dominant=dominant,
        model_flops=cost.model_flops, total_flops=cost.total_flops,
        useful_fraction=cost.useful_fraction,
        roofline_fraction=rf,
    )


def what_would_help(row: RooflineRow) -> str:
    if row.dominant == "compute":
        return ("compute-bound: reduce remat recompute or attention "
                "waste (already near the right regime)")
    if row.dominant == "memory":
        return ("memory-bound: cut optimizer/activation traffic "
                "(grad-accum, factored optimizer states, fused CE) or "
                "raise achieved HBM fraction (larger sequential reads)")
    return ("collective-bound: re-shard to remove per-layer gathers, "
            "overlap collectives with compute, or compress gradients")


def render_table(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute (s) | memory (s) | "
           "collective (s) | dominant | MODEL/total | roofline frac |")
    sep = "|" + "---|" * 9
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_eff_s:.3e} | {r.collective_s:.3e} | "
            f"{r.dominant} | {r.useful_fraction:.2f} | "
            f"{r.roofline_fraction:.2f} |")
    return "\n".join(out)
