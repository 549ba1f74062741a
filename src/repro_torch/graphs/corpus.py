"""Graph-corpus subsystem: named scenario presets, ordering transforms,
and a content-addressed on-disk binary store.

The paper's evaluation (and the follow-up study, arXiv:2104.07776) runs
on a *corpus* of real and synthetic graphs because access-pattern
conclusions shift with topology.  This module makes the corpus a
first-class sweep axis:

* :data:`GRAPH_PRESETS` — named scenarios (file-parsed real graphs,
  R-MAT / Kronecker / power-law / road generators, Tab. 1 stand-ins),
  the graph analogue of ``MEMORY_PRESETS`` / ``CACHE_PRESETS``.
* :func:`resolve_graph` / :func:`graph_variants` — coerce preset names
  (with optional ``:degree`` / ``:bfs`` / ``:shuffle`` ordering-
  transform suffixes) to :class:`Graph` instances, memoized so repeated
  resolution of one scenario yields the *same object* and the sweep
  engine's per-graph caches are shared.
* :func:`degree_sort` / :func:`bfs_reorder` / :func:`shuffle` — vertex
  relabelings preserving the edge multiset (property-tested), the
  locality knobs whose direction the corpus benchmark asserts.
* :class:`GraphStore` — a content-addressed binary CSR store with a
  versioned header and atomic writes; keys are derived from the full
  generator/preset parameter set (or the source file's content hash),
  so a parameter change can never serve a stale graph.

Everything here is host NumPy, as in the JAX package, and bit for bit
its counterpart: the same graphs, permutations, store keys and store
files (a file written by either package loads in the other).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import struct
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from repro_torch.analysis import locks
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs import generators as gen
from repro_torch.graphs.formats import (Graph, load_matrix_market,
                                        load_snap_edgelist)
from repro_torch.serve import chaos

# ---------------------------------------------------------------------------
# Ordering transforms (vertex relabelings).
# ---------------------------------------------------------------------------


def degree_perm(g: Graph, by: str = "total") -> np.ndarray:
    """Permutation mapping old id -> new id, new ids assigned by
    descending degree (ties broken by old id, so it is deterministic)."""
    if by == "out":
        deg = g.out_degrees()
    elif by == "in":
        deg = g.in_degrees()
    elif by == "total":
        deg = g.out_degrees() + g.in_degrees()
    else:
        raise ValueError(f"by must be 'out'|'in'|'total', got {by!r}")
    order = np.argsort(-deg, kind="stable")      # old ids, hot first
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    return perm


def bfs_perm(g: Graph, root: int = 0) -> np.ndarray:
    """Permutation assigning new ids in BFS discovery order from
    ``root`` (neighbors explored in ascending id; vertices unreachable
    from the root — including other components — keep their relative
    order after the reached set)."""
    csr_ptr = np.zeros(g.n + 1, dtype=np.int64)
    order = np.argsort(g.src, kind="stable")
    nbr = g.dst[order]
    np.cumsum(np.bincount(g.src, minlength=g.n), out=csr_ptr[1:])
    seen = np.zeros(g.n, dtype=bool)
    out = np.empty(g.n, dtype=np.int64)
    k = 0
    frontier = np.asarray([root], dtype=np.int64)
    seen[root] = True
    while frontier.size:
        out[k:k + frontier.size] = frontier
        k += frontier.size
        spans = [nbr[csr_ptr[v]:csr_ptr[v + 1]] for v in frontier]
        cand = (np.unique(np.concatenate(spans)) if spans
                else np.asarray([], dtype=np.int64))
        nxt = cand[~seen[cand]]
        seen[nxt] = True
        frontier = nxt
    rest = np.flatnonzero(~seen)
    out[k:] = rest
    perm = np.empty(g.n, dtype=np.int64)
    perm[out] = np.arange(g.n)
    return perm


def shuffle_perm(g: Graph, seed: int = 0) -> np.ndarray:
    """Uniformly random relabeling — the locality-destroying baseline
    the ordering transforms are measured against."""
    return np.random.default_rng(seed).permutation(g.n)


def degree_sort(g: Graph, by: str = "total") -> Graph:
    """Relabel vertices by descending degree (hubs get low ids): the
    classic locality transform — hot vertex values pack into few DRAM
    rows / cache lines, so row-hit and on-chip hit rates go *up* on
    skewed graphs (asserted by ``benchmarks/corpus_sweep.py``)."""
    return g.relabeled(degree_perm(g, by), name=g.name + "+degsort")


def bfs_reorder(g: Graph, root: int = 0) -> Graph:
    """Relabel vertices in BFS discovery order: neighbors get nearby
    ids, improving spatial locality on high-diameter graphs."""
    return g.relabeled(bfs_perm(g, root), name=g.name + "+bfsorder")


def shuffle(g: Graph, seed: int = 0) -> Graph:
    """Randomly relabel vertices (destroys any inherent ordering
    locality; the corpus benchmark's control arm)."""
    return g.relabeled(shuffle_perm(g, seed), name=g.name + "+shuffle")


TRANSFORMS: Dict[str, Callable[[Graph], Graph]] = {
    "degree": degree_sort,
    "bfs": bfs_reorder,
    "shuffle": shuffle,
}

# ---------------------------------------------------------------------------
# Content-addressed binary store.
# ---------------------------------------------------------------------------

#: bump to invalidate every on-disk entry (the version is baked into
#: both the file name and the header, so stale files are simply never
#: opened, and a truncated/foreign file never parses).  Bump it
#: whenever parser or generator *semantics* change: store keys carry
#: the input parameters (or source-file digest), not the code that
#: interprets them, so the version is what keeps old interpretations
#: from being served.
CORPUS_CACHE_VERSION = 3

_MAGIC = b"RGCC"
_F_DIRECTED = 1
_F_WEIGHTS = 2
_F_WEIGHTS_FLOAT = 4

#: disambiguates tmp files within one thread (itertools.count is
#: GIL-atomic, so the whole tmp suffix is unique per in-flight write)
_TMP_SEQ = itertools.count()


class CorpusCacheError(RuntimeError):
    """A corpus store file exists but cannot be used (bad magic, wrong
    version, truncated, or inconsistent CSR header)."""


def save_graph_binary(path: Union[str, Path], g: Graph,
                      descriptor: str = "") -> None:
    """Write ``g`` to ``path`` in the versioned binary CSR format,
    atomically (tmp file + ``os.replace``; readers never observe a
    partial file).

    Layout: ``RGCC`` magic, u32 version, u64 n, u64 m, u8 flags,
    u32-length-prefixed name and descriptor, CSR pointers
    (``int64[n+1]`` over the source-sorted view), then the raw edge
    list (``src``, ``dst`` as ``int64[m]``, weights if present) — the
    edge list is stored verbatim so a round trip is bit-identical
    (edge *order* is semantic: partitioners sort stably by it).
    """
    path = Path(path)
    flags = 0
    if g.directed:
        flags |= _F_DIRECTED
    w = g.weights
    if w is not None:
        flags |= _F_WEIGHTS
        if np.issubdtype(w.dtype, np.floating):
            w = np.ascontiguousarray(w, dtype=np.float64)
            flags |= _F_WEIGHTS_FLOAT
        else:
            w = np.ascontiguousarray(w, dtype=np.int64)
    name_b = g.name.encode("utf-8")
    desc_b = descriptor.encode("utf-8")
    pointers = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(g.src, minlength=g.n), out=pointers[1:])
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid + thread + counter: a pid-only suffix let two threads of one
    # process writing the same key clobber each other's tmp file
    tmp = path.with_name(
        path.name + f".tmp{os.getpid()}.{threading.get_ident()}"
        f".{next(_TMP_SEQ)}")
    try:
        with locks.witness_write(tmp), open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<IQQB", CORPUS_CACHE_VERSION, g.n,
                                g.m, flags))
            f.write(struct.pack("<I", len(name_b)) + name_b)
            f.write(struct.pack("<I", len(desc_b)) + desc_b)
            f.write(pointers.tobytes())
            f.write(np.ascontiguousarray(g.src, dtype=np.int64)
                    .tobytes())
            f.write(np.ascontiguousarray(g.dst, dtype=np.int64)
                    .tobytes())
            if w is not None:
                f.write(w.tobytes())
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def load_graph_binary(path: Union[str, Path]) -> Graph:
    """Load a graph written by :func:`save_graph_binary`.  Raises
    :class:`CorpusCacheError` on anything that is not a complete,
    current-version store file."""
    path = Path(path)
    data = path.read_bytes()

    def take(fmt, off):
        size = struct.calcsize(fmt)
        if off + size > len(data):
            raise CorpusCacheError(f"{path}: truncated header")
        return struct.unpack_from(fmt, data, off), off + size

    if data[:4] != _MAGIC:
        raise CorpusCacheError(
            f"{path}: bad magic {data[:4]!r} (not a corpus store file)")
    (version, n, m, flags), off = take("<IQQB", 4)
    if version != CORPUS_CACHE_VERSION:
        raise CorpusCacheError(
            f"{path}: store version {version} != current "
            f"{CORPUS_CACHE_VERSION} (stale entry)")
    (name_len,), off = take("<I", off)
    try:
        name = data[off:off + name_len].decode("utf-8")
    except UnicodeDecodeError:
        raise CorpusCacheError(
            f"{path}: corrupt name field") from None
    off += name_len
    (desc_len,), off = take("<I", off)
    off += desc_len                      # descriptor: debugging only
    counts = [n + 1, m, m]
    has_w = bool(flags & _F_WEIGHTS)
    if has_w:
        counts.append(m)
    need = off + 8 * sum(counts)
    if len(data) != need:
        raise CorpusCacheError(
            f"{path}: expected {need} bytes, found {len(data)} "
            "(truncated or corrupt)")
    pointers = np.frombuffer(data, dtype=np.int64, count=n + 1,
                             offset=off).copy()
    off += 8 * (n + 1)
    src = np.frombuffer(data, dtype=np.int64, count=m, offset=off).copy()
    off += 8 * m
    dst = np.frombuffer(data, dtype=np.int64, count=m, offset=off).copy()
    off += 8 * m
    w = None
    if has_w:
        dt = (np.float64 if flags & _F_WEIGHTS_FLOAT else np.int64)
        w = np.frombuffer(data, dtype=dt, count=m, offset=off).copy()
    if int(pointers[-1]) != m or int(pointers[0]) != 0:
        raise CorpusCacheError(
            f"{path}: CSR pointer header inconsistent with m={m}")
    return Graph(int(n), src, dst, w,
                 directed=bool(flags & _F_DIRECTED), name=name)


class GraphStore:
    """Content-addressed on-disk graph store.

    ``get(key, build)`` hashes the *descriptor* ``key`` (every
    generator/preset parameter, or a source file's content digest) into
    the file name; a parameter change produces a different address, and
    a :data:`CORPUS_CACHE_VERSION` bump orphans every old entry.
    Unreadable or stale entries are rebuilt, never trusted.  ``builds``
    and ``hits`` count what :meth:`get` did.
    """

    def __init__(self, root: Union[str, Path, None] = None):
        if root is None:
            root = os.environ.get("REPRO_GRAPH_CACHE_DIR",
                                  Path.home() / ".cache" / "repro-graphs")
        self.root = Path(root)
        self.builds = 0
        self.hits = 0

    def path_for(self, key: str) -> Path:
        digest = hashlib.sha256(key.encode("utf-8")).hexdigest()[:20]
        slug = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in key)[:48]
        return (self.root /
                f"{slug}-v{CORPUS_CACHE_VERSION}-{digest}.rgc")

    def load(self, key: str) -> Optional[Graph]:
        path = self.path_for(key)
        if not path.exists():
            return None
        try:
            # chaos site: an injected read fault is indistinguishable
            # from a truncated/corrupt entry and takes the same
            # rebuild-never-trust path below
            chaos.maybe_inject("graphstore.read", key)
            return load_graph_binary(path)
        except (CorpusCacheError, OSError, chaos.InjectedFault):
            return None

    def store(self, key: str, g: Graph) -> Optional[Path]:
        path = self.path_for(key)
        try:
            save_graph_binary(path, g, descriptor=key)
        except OSError:
            return None                  # read-only checkout: stay in-RAM
        return path

    def get(self, key: str, build: Callable[[], Graph]) -> Graph:
        g = self.load(key)
        if g is None:
            g = build()
            self.store(key, g)
            self.builds += 1
        else:
            self.hits += 1
        return g


# ---------------------------------------------------------------------------
# Named presets and resolution.
# ---------------------------------------------------------------------------

_DATA_DIR = Path(__file__).resolve().parent / "data"


@dataclasses.dataclass(frozen=True)
class GraphPreset:
    """One named corpus scenario.

    ``family`` selects the construction; ``params`` is the full,
    canonical parameter set (it is part of the store key, so presets
    are content-addressed by everything that shapes the graph).
    ``scale`` at build time multiplies vertex count for generator
    families (R-MAT/Kronecker scale is adjusted in log2); file-parsed
    graphs are fixed-size and ignore it.
    """

    name: str
    family: str                      # snap | mtx | rmat | kronecker |
    #                                  powerlaw | road | uniform | dataset
    params: tuple = ()               # canonical ((key, value), ...)
    description: str = ""

    #: fields that never shape the graph, so never enter the store key
    KEY_EXEMPT_FIELDS = {
        "description": "human-readable blurb; never shapes the graph",
    }

    def p(self) -> dict:
        return dict(self.params)

    def key(self, scale: float, seed: int) -> str:
        if self.family in ("snap", "mtx"):
            digest = hashlib.sha256(
                (_DATA_DIR / self.p()["path"]).read_bytes()
            ).hexdigest()[:16]
            return f"{self.name};file={digest}"
        return (f"{self.name};{self.family};"
                + ";".join(f"{k}={v}" for k, v in self.params)
                + f";scale={scale:g};seed={seed}")

    def build(self, scale: float = 1.0, seed: int = 0) -> Graph:
        p = self.p()
        if self.family == "snap":
            g = load_snap_edgelist(_DATA_DIR / p["path"],
                                   directed=p.get("directed", True),
                                   name=self.name)
            return g if g.directed else _symmetrized(g, self.name)
        if self.family == "mtx":
            # symmetric .mtx files come back already mirrored
            return load_matrix_market(_DATA_DIR / p["path"],
                                      name=self.name)
        if self.family == "rmat":
            return gen.rmat(_scaled_log2(p["scale"], scale),
                            p["avg_degree"], seed=seed, name=self.name)
        if self.family == "kronecker":
            return gen.kronecker(_scaled_log2(p["scale"], scale),
                                 p["avg_degree"],
                                 initiator=p.get("initiator"),
                                 noise=p.get("noise", 0.1),
                                 seed=seed, name=self.name)
        if self.family == "powerlaw":
            n = max(int(p["n"] * scale), 64)
            m = max(int(p["m"] * scale), 128)
            return gen.degree_matched(n, m, skew=p["skew"], seed=seed,
                                      name=self.name)
        if self.family == "road":
            side = max(int(p["side"] * scale ** 0.5), 8)
            return gen.grid_road(side, seed=seed, name=self.name)
        if self.family == "uniform":
            n = max(int(p["n"] * scale), 64)
            m = max(int(p["m"] * scale), 128)
            return gen.uniform_random(n, m, seed=seed, name=self.name)
        if self.family == "dataset":
            from repro_torch.graphs.datasets import instantiate
            g = instantiate(p["abbr"], scale=p["frac"] * scale,
                            seed=seed)
            # present under the preset name, like every other family
            return dataclasses.replace(g, name=self.name)
        raise ValueError(f"unknown preset family {self.family!r}")


def _symmetrized(g: Graph, name: str) -> Graph:
    und = g.undirected_view()
    return dataclasses.replace(und, name=name)


def _scaled_log2(base_scale: int, scale: float) -> int:
    adj = int(round(np.log2(scale))) if scale != 1.0 else 0
    return max(base_scale + adj, 6)


def _presets() -> Dict[str, GraphPreset]:
    entries = [
        # file-parsed real graph (shipped with the repo: Zachary's
        # karate club, the classic small real-world network)
        GraphPreset("karate", "snap",
                    (("path", "karate.txt"), ("directed", False)),
                    "Zachary karate club (34 v / 156 sym. edges), "
                    "SNAP edge-list file"),
        # synthetic families at paper-like topologies
        GraphPreset("rmat-16", "rmat",
                    (("scale", 16), ("avg_degree", 16)),
                    "Graph500 R-MAT, 65k vertices, skewed"),
        GraphPreset("kron-social", "kronecker",
                    (("scale", 16), ("avg_degree", 12),
                     ("noise", 0.1)),
                    "noisy stochastic-Kronecker social-like graph"),
        GraphPreset("powerlaw-social", "powerlaw",
                    (("n", 1 << 16), ("m", 1 << 20), ("skew", 0.85)),
                    "Zipf-degree social stand-in (live-journal-like "
                    "skew)"),
        GraphPreset("road-grid", "road", (("side", 256),),
                    "2-D road grid: high diameter, constant degree"),
        GraphPreset("uniform-sparse", "uniform",
                    (("n", 1 << 16), ("m", 1 << 19)),
                    "uniform random (Erdős–Rényi-like), degree 8"),
        # Tab. 1 stand-ins routed through the dataset registry
        GraphPreset("lj-sample", "dataset",
                    (("abbr", "lj"), ("frac", 0.005)),
                    "live-journal stand-in at 0.5% scale"),
        GraphPreset("wiki-talk-sample", "dataset",
                    (("abbr", "wt"), ("frac", 0.01)),
                    "wiki-talk stand-in at 1% scale"),
        GraphPreset("roadnet-sample", "dataset",
                    (("abbr", "rd"), ("frac", 0.01)),
                    "roadnet-ca stand-in at 1% scale"),
    ]
    return {p.name: p for p in entries}


#: the named corpus — ``sweep(graphs=[...])`` accepts these names
#: directly, optionally suffixed ``:degree`` / ``:bfs`` / ``:shuffle``
#: to apply an ordering transform.
GRAPH_PRESETS: Dict[str, GraphPreset] = _presets()

GraphLike = Union[Graph, str]

_resolve_lock = locks.make_lock("corpus-resolve")
_resolved: Dict[tuple, Graph] = \
    locks.make_dict("corpus._resolved", _resolve_lock)
_default_store: Optional[GraphStore] = None


def default_store() -> GraphStore:
    global _default_store
    with _resolve_lock:
        if _default_store is None:
            _default_store = GraphStore()
        return _default_store


def resolve_graph(graph: GraphLike, scale: float = 1.0, seed: int = 0,
                  store: Optional[GraphStore] = None) -> Graph:
    """Coerce a graph selector to a :class:`Graph`.

    ``Graph`` instances pass through.  Strings name a
    :data:`GRAPH_PRESETS` entry, optionally with an ordering-transform
    suffix (``"powerlaw-social:degree"``).  Resolution is memoized per
    ``(name, scale, seed)`` so every caller sees the *same object* —
    the sweep engine then shares one per-graph session (algorithm runs,
    models, packed programs) across everything sweeping that scenario.
    Disk-cache misses build the graph and store it content-addressed
    (set ``REPRO_GRAPH_CACHE=0`` to skip the disk entirely).
    """
    if isinstance(graph, Graph):
        return graph
    if not isinstance(graph, str):
        raise TypeError(
            f"graph must be a Graph or a preset name, got "
            f"{type(graph).__name__}")
    name, _, transform = graph.partition(":")
    if transform and transform not in TRANSFORMS:
        raise UnknownPresetError("graph transform", transform, TRANSFORMS)
    preset = GRAPH_PRESETS.get(name)
    if preset is None:
        raise UnknownPresetError("graph", name, GRAPH_PRESETS)
    memo_key = (name, transform, float(scale), int(seed))
    with _resolve_lock:
        g = _resolved.get(memo_key)
    if g is not None:
        return g
    use_disk = os.environ.get("REPRO_GRAPH_CACHE", "1") != "0"
    if store is None and use_disk:
        store = default_store()

    def build():
        return preset.build(scale=scale, seed=seed)

    # the key may hash a source data file — only derive it when a
    # store will actually use it
    g = (store.get(preset.key(scale, seed), build)
         if store is not None else build())
    if transform:
        g = TRANSFORMS[transform](g)
    with _resolve_lock:
        # first resolution wins so concurrent callers share one object
        g = _resolved.setdefault(memo_key, g)
    return g


def graph_variants(names: Iterable[str] = ("karate", "rmat-16",
                                           "powerlaw-social",
                                           "road-grid"),
                   scale: float = 1.0, seed: int = 0) -> List[Graph]:
    """Resolve a list of preset names (the corpus analogue of
    :func:`repro_torch.sim.memory.timing_variants`): one :class:`Graph`
    per name, ready to hand to ``sweep(graphs=...)``."""
    return [resolve_graph(n, scale=scale, seed=seed) for n in names]


def graph_name(graph: GraphLike) -> str:
    """Stable display name for sweep rows without forcing resolution."""
    return graph if isinstance(graph, str) else graph.name
