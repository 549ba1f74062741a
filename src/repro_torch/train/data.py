"""Deterministic synthetic LM data pipeline (a copy of
``repro.train.data``: NumPy only, so both packages make the same batches).

Design goals for the 1000+-node posture:

* **determinism** — every (step, shard) batch is a pure function of
  (seed, step, shard), so an elastic restart or a replacement worker
  regenerates exactly the data it owes: no data loss, no duplication
  (the checkpoint only needs the step counter).
* **shardability** — ``global_batch`` rows are owned ``data``-axis-wise;
  each host materializes only its rows (``host_slice``).
* **structure** — a Zipf-distributed Markov stream, not uniform noise,
  so smoke-training shows a real decreasing loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


def _batch_rng(seed: int, step: int, row: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, row]))


def make_batch(cfg: ModelConfig, dc: DataConfig, step: int,
               rows: Optional[range] = None) -> Dict[str, np.ndarray]:
    """Batch for `step`; `rows` selects this host's slice of the batch."""
    rows = rows if rows is not None else range(dc.global_batch)
    S = dc.seq_len
    toks = np.zeros((len(rows), S + 1), dtype=np.int32)
    for i, r in enumerate(rows):
        rng = _batch_rng(dc.seed, step, r)
        # periodic pattern + zipf substitution noise: learnable structure
        # (bigram stats + induction) with a long-tail unigram distribution
        period = int(rng.integers(4, 17))
        pattern = (rng.zipf(dc.zipf_a, size=period) - 1) % cfg.vocab
        seq = np.tile(pattern, S // period + 2)[:S + 1]
        noise_at = rng.random(S + 1) < 0.05
        seq = np.where(noise_at,
                       (rng.zipf(dc.zipf_a, size=S + 1) - 1) % cfg.vocab,
                       seq)
        toks[i] = seq.astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        rng = _batch_rng(dc.seed, step, dc.global_batch + 1)
        batch["patches"] = rng.normal(
            size=(len(rows), cfg.img_tokens, cfg.d_model)
        ).astype(np.float32)
    if cfg.family == "audio":
        rng = _batch_rng(dc.seed, step, dc.global_batch + 2)
        batch["frames"] = rng.normal(
            size=(len(rows), cfg.enc_frames, cfg.d_model)
        ).astype(np.float32)
    return batch


def host_slice(dc: DataConfig, host_id: int, n_hosts: int) -> range:
    per = dc.global_batch // n_hosts
    return range(host_id * per, (host_id + 1) * per)


def batches(cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
            rows: Optional[range] = None) -> Iterator[Dict]:
    step = start_step
    while True:
        yield make_batch(cfg, dc, step, rows)
        step += 1
