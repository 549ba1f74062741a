"""Dynamic-graph update streams: seeded edge-insertion/deletion batches.

An :class:`UpdateStream` is a named, seeded generator of per-epoch
:class:`UpdateBatch` es against an *evolving* graph — the value of the
``updates=`` axis of :func:`repro_torch.sim.simulate` and
:func:`repro_torch.sim.run_dynamic`.

Three preset families (:data:`UPDATE_PRESETS`):

* ``pa-growth``      — preferential-attachment growth: inserts attach to
  high-in-degree vertices (rich get richer), no deletions — an evolving
  social graph.
* ``sliding-window`` — streaming window churn: fresh uniform inserts,
  the *oldest* surviving edges deleted — a fixed-size edge window
  sliding over an unbounded stream.
* ``uniform-churn``  — uniform inserts plus uniform random deletions —
  the unstructured-control arm.

Determinism: batch ``e`` is a pure function of ``(stream.seed, e)`` and
the graph the stream has evolved so far, drawn from NumPy's
``SeedSequence([seed, epoch, 0x5D])`` exactly as the JAX package draws
it, so both packages produce identical batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.errors import UnknownPresetError
from repro_torch.graphs.formats import Graph


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """One epoch's mutation: edges to insert plus indices (into the
    *current* edge arrays) to delete.  The vertex set is fixed — values,
    partitions, and BRAM intervals stay aligned across epochs."""

    epoch: int
    insert_src: np.ndarray                       # int64[a]
    insert_dst: np.ndarray                       # int64[a]
    delete_idx: np.ndarray                       # int64[d], unique
    insert_weights: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "insert_src",
                           np.asarray(self.insert_src, dtype=np.int64))
        object.__setattr__(self, "insert_dst",
                           np.asarray(self.insert_dst, dtype=np.int64))
        object.__setattr__(self, "delete_idx",
                           np.asarray(self.delete_idx, dtype=np.int64))
        if len(self.insert_src) != len(self.insert_dst):
            raise ValueError("insert_src/insert_dst length mismatch")
        if len(np.unique(self.delete_idx)) != len(self.delete_idx):
            raise ValueError("delete_idx must be unique")

    @property
    def n_inserted(self) -> int:
        return len(self.insert_src)

    @property
    def n_deleted(self) -> int:
        return len(self.delete_idx)


def apply_batch(g: Graph, batch: UpdateBatch) -> Graph:
    """The mutated graph: ``batch.delete_idx`` rows removed, inserted
    edges appended (surviving-edge order preserved, so partitioners see
    a stable stream).  The vertex count is unchanged."""
    if batch.n_deleted:
        lo, hi = batch.delete_idx.min(), batch.delete_idx.max()
        if lo < 0 or hi >= g.m:
            raise IndexError(
                f"delete_idx out of range [0, {g.m}): ({lo}, {hi})")
    if batch.n_inserted:
        ends = np.concatenate([batch.insert_src, batch.insert_dst])
        if ends.min() < 0 or ends.max() >= g.n:
            raise IndexError(
                f"inserted endpoint out of range [0, {g.n})")
    keep = np.ones(g.m, dtype=bool)
    keep[batch.delete_idx] = False
    src = np.concatenate([g.src[keep], batch.insert_src])
    dst = np.concatenate([g.dst[keep], batch.insert_dst])
    w = None
    if g.weights is not None:
        ins_w = batch.insert_weights
        if ins_w is None:
            ins_w = np.ones(batch.n_inserted, dtype=g.weights.dtype)
        w = np.concatenate([g.weights[keep],
                            np.asarray(ins_w, dtype=g.weights.dtype)])
    base = g.name.split("@e")[0]
    return Graph(g.n, src, dst, w, directed=g.directed,
                 name=f"{base}@e{batch.epoch}")


@dataclasses.dataclass(frozen=True)
class UpdateStream:
    """A named, seeded update-stream spec (see module docstring).

    ``rate`` sizes each batch as a fraction of the current edge count
    (at least one edge); ``delete_rate`` defaults per kind (0 for
    ``pa``, ``rate`` for ``window``/``churn``).
    """

    name: str
    kind: str                         # "pa" | "window" | "churn"
    epochs: int = 3
    rate: float = 0.02
    delete_rate: Optional[float] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("pa", "window", "churn"):
            raise ValueError(
                f"unknown update-stream kind {self.kind!r}; "
                "one of 'pa' | 'window' | 'churn'")
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        if not 0 < self.rate <= 1:
            raise ValueError(f"rate must be in (0, 1], got {self.rate}")

    def _rng(self, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 0x5D]))

    def batch(self, g: Graph, epoch: int) -> UpdateBatch:
        """Epoch ``epoch``'s batch against the current graph ``g``
        (epochs are 1-based: epoch 0 is the static prefix)."""
        rng = self._rng(epoch)
        a = max(1, int(round(g.m * self.rate)))
        d_rate = (self.delete_rate if self.delete_rate is not None
                  else (0.0 if self.kind == "pa" else self.rate))
        d = min(int(round(g.m * d_rate)), g.m - 1)
        if self.kind == "pa":
            # rich-get-richer: destinations ∝ in-degree + 1
            w = g.in_degrees().astype(np.float64) + 1.0
            dst = rng.choice(g.n, size=a, p=w / w.sum())
            src = rng.integers(0, g.n, size=a)
            delete = np.empty(0, dtype=np.int64)
        elif self.kind == "window":
            src = rng.integers(0, g.n, size=a)
            dst = rng.integers(0, g.n, size=a)
            delete = np.arange(d, dtype=np.int64)   # oldest edges
        else:                                        # churn
            src = rng.integers(0, g.n, size=a)
            dst = rng.integers(0, g.n, size=a)
            delete = rng.choice(g.m, size=d, replace=False)
        return UpdateBatch(epoch=epoch,
                           insert_src=np.asarray(src, dtype=np.int64),
                           insert_dst=np.asarray(dst, dtype=np.int64),
                           delete_idx=np.sort(
                               np.asarray(delete, dtype=np.int64)))

    def materialize(self, g: Graph
                    ) -> List[Tuple[UpdateBatch, Graph]]:
        """Replay the whole stream from ``g``: ``[(batch_e, graph
        after batch_e), ...]`` for epochs ``1..epochs``."""
        out: List[Tuple[UpdateBatch, Graph]] = []
        for e in range(1, self.epochs + 1):
            b = self.batch(g, e)
            g = apply_batch(g, b)
            out.append((b, g))
        return out


#: named update-stream scenarios — the ``updates=`` axis accepts these
#: names directly.
UPDATE_PRESETS: Dict[str, UpdateStream] = {
    "pa-growth": UpdateStream("pa-growth", "pa"),
    "sliding-window": UpdateStream("sliding-window", "window"),
    "uniform-churn": UpdateStream("uniform-churn", "churn"),
}

UpdatesLike = Union[None, str, UpdateStream]


def resolve_updates(updates: UpdatesLike) -> Optional[UpdateStream]:
    """Coerce an update-stream selector (``None`` = static workload)."""
    if updates is None:
        return None
    if isinstance(updates, UpdateStream):
        return updates
    if isinstance(updates, str):
        try:
            return UPDATE_PRESETS[updates]
        except KeyError:
            raise UnknownPresetError("updates", updates,
                                     UPDATE_PRESETS) from None
    raise TypeError(
        f"updates must be None, a preset name, or an UpdateStream; "
        f"got {type(updates).__name__}")


def updates_name(updates: UpdatesLike) -> str:
    """Stable display name for result rows."""
    if updates is None:
        return "static"
    if isinstance(updates, str):
        return updates
    return updates.name


def touched_partitions(batch: UpdateBatch, g_before: Graph,
                       q: int, n: int) -> np.ndarray:
    """Vertex-interval partitions structurally touched by a batch: the
    intervals of every endpoint of an inserted or deleted edge."""
    ends = [batch.insert_src, batch.insert_dst]
    if batch.n_deleted:
        ends.append(g_before.src[batch.delete_idx])
        ends.append(g_before.dst[batch.delete_idx])
    vs = np.concatenate(ends) if ends else np.empty(0, dtype=np.int64)
    if not len(vs):
        return np.empty(0, dtype=np.int64)
    q = max(int(q), 1)
    return np.unique(vs // q)
