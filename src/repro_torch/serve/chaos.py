"""``repro_torch.serve.chaos`` — deterministic fault injection for the
simulation service.

The service's recovery paths (retry/backoff, worker supervision, case
quarantine, circuit breaking, GraphStore rebuild-on-corruption) are only
trustworthy if they are *exercised*; this layer injects faults into the
live pipeline at named **sites** so ``tests/test_torch_service_faults.py``
and ``chip_smoke.py``'s service phase can prove every path end to end.
The model is the JAX package's, kept as a copy (the port imports nothing
of it) with its own module state: a process that runs both packages arms
each with its own :func:`scope`.

Design constraints, in priority order:

1. **Determinism.**  Whether a given (site, key) evaluation faults is a
   pure function of ``(seed, site, key, attempt-ordinal)`` — never of
   wall clock, thread identity, or scheduling.  Affected keys fail a
   *prefix* of their attempts (attempts ``0..k-1`` for a hash-derived
   ``k``), or *every* attempt when permanently poisoned.  Prefix
   semantics make the final per-case outcome schedule-independent: extra
   speculative evaluations (a sweep worker that prepared a case before a
   sibling's failure aborted the run) only consume failing attempts
   *earlier*; they can never flip a surviving case into a failing one —
   provided the retry budget covers ``max_attempts`` (the service
   asserts this when chaos is active).  Same submissions + same seed
   -> bit-identical surviving rows for any worker count.
2. **Zero cost when off.**  ``maybe_inject`` is a dict lookup returning
   immediately when no config is active; nothing else in the repo
   imports anything heavier than ``hashlib`` from here (this module must
   stay import-light — it is called from ``repro_torch.sim.sweep`` and
   ``repro_torch.graphs.corpus``).

Activation: :func:`scope` (tests), :func:`activate`/:func:`deactivate`,
or the environment knobs read by :func:`config_from_env`::

    REPRO_CHAOS_SEED=7
    REPRO_CHAOS_SITES="sweep.prepare=0.3,dram.serve=0.2:3,graphstore.read=1.0,worker.crash=0.05:1:1.0"

Each site spec is ``name=rate[:max_attempts[:permanent_rate]]`` —
``rate`` is the probability a key is affected at all, ``max_attempts``
bounds the failing prefix of a transient key, and ``permanent_rate`` is
the conditional probability an affected key is permanently poisoned
(fails every attempt; the service quarantines it instead of retrying).

Known sites:

====================  ====================================================
``sweep.prepare``     case preparation in the sweep worker pool
                      (algorithm run / trace build / device pack)
``dram.serve``        the fused-scan DRAM serving step of one case
``graphstore.read``   a :class:`~repro_torch.graphs.corpus.GraphStore` disk
                      read (recovered by the rebuild-on-corruption path)
``worker.crash``      raises :class:`WorkerCrash` (a ``BaseException``)
                      through the sweep stack, killing the service's
                      worker thread — exercises supervisor replacement
====================  ====================================================

:class:`StragglerMonitor` (EWMA latency anomaly detection) lives here,
next to the failure model; the service uses its EWMA as the cost-rate
estimate behind admission-control retry-after hints.

One departure from the JAX package: a :class:`~repro_torch.errors.
KernelError` (a hand-written kernel that failed to build, load or launch)
is never transient, whatever it wraps (see :func:`is_transient`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Callable, Dict, List, Mapping, Optional

from repro_torch.errors import KernelError


class InjectedFault(RuntimeError):
    """A fault raised by the chaos layer at a named site.

    ``permanent`` distinguishes the two classes the service must treat
    differently: transient faults (the default) model OOMs, interrupted
    compiles, and I/O blips — retry with backoff; permanent faults model
    a poisoned case — quarantine, never retry.
    """

    def __init__(self, site: str, key: str, attempt: int,
                 permanent: bool = False):
        self.site = site
        self.key = key
        self.attempt = attempt
        self.permanent = permanent
        kind = "permanent" if permanent else "transient"
        super().__init__(
            f"injected {kind} fault at {site!r} (attempt {attempt}) "
            f"for {key!r}")


class WorkerCrash(BaseException):
    """An injected catastrophic failure: kills the thread it is raised
    on instead of surfacing as a job failure (``BaseException`` so the
    sweep/engine ``except Exception`` guards do NOT absorb it).  The
    service's supervisor catches it at the top of the worker thread and
    spawns a replacement; a *transient* crash only requeues the job (the
    crashing prefix is finite, so the case eventually succeeds), while a
    *permanent* crash — or a crash with no injection plan, i.e. a real
    one — quarantines the case named by ``key``.  The transient/
    permanent split matters for determinism: a crash raised by a
    speculative prep thread can be absorbed by an abandoned future when
    a sibling's failure stops the run first, so *which* crash events are
    observed is schedule-dependent — but with these semantics the final
    per-case outcome (row vs quarantine) is not.
    """

    def __init__(self, site: str, key: str, attempt: int,
                 permanent: bool = False):
        self.site = site
        self.key = key
        self.attempt = attempt
        self.permanent = permanent
        kind = "permanent" if permanent else "transient"
        super().__init__(
            f"injected {kind} worker crash at {site!r} for {key!r}")


@dataclasses.dataclass(frozen=True)
class SiteConfig:
    """Fault behavior of one injection site.

    ``rate``            probability (over keys) that a key faults at all;
    ``max_attempts``    an affected transient key fails its first
                        ``k`` attempts, ``1 <= k <= max_attempts``
                        (``k`` hash-derived per key);
    ``permanent_rate``  conditional probability that an affected key is
                        permanently poisoned (fails *every* attempt);
    ``crash``           raise :class:`WorkerCrash` instead of
                        :class:`InjectedFault`.
    """

    rate: float = 0.0
    max_attempts: int = 2
    permanent_rate: float = 0.0
    crash: bool = False


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """A seed plus the per-site fault model. Immutable; activate with
    :func:`activate` / :func:`scope`."""

    seed: int = 0
    sites: Mapping[str, SiteConfig] = dataclasses.field(
        default_factory=dict)

    def max_transient_attempts(self) -> int:
        """The retry budget a supervisor needs so that every transient
        key eventually succeeds (see the determinism note in the module
        docstring).  Summed over the non-crash sites because one key can
        fault at several of them (prepare *and* serve), and every such
        fault spends one retry; crash sites recover through supervisor
        requeue instead of the retry budget."""
        return sum(s.max_attempts for s in self.sites.values()
                   if s.rate > 0 and not s.crash)


#: env knobs (the JAX package's names, so one setting arms either)
ENV_SEED = "REPRO_CHAOS_SEED"
ENV_SITES = "REPRO_CHAOS_SITES"

_lock = threading.Lock()
_active: Optional[ChaosConfig] = None
#: evaluation ordinals per (site, key) — the ``attempt`` axis of the
#: deterministic fault function; reset on every (de)activation
_ordinals: Dict[tuple, int] = {}
_injected: List[tuple] = []      # (site, key, attempt, kind) log


def _u01(seed: int, *parts) -> float:
    """Deterministic uniform [0, 1) from a blake2b of the parts."""
    h = hashlib.blake2b("|".join(str(p) for p in (seed,) + parts)
                        .encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


def uniform01(*parts) -> float:
    """Public deterministic hash-uniform — e.g. the service's backoff
    jitter, which must replay identically across reruns."""
    return _u01(0, *parts)


def activate(config: Optional[ChaosConfig]) -> None:
    """Install ``config`` as the process-wide chaos model (``None``
    disables injection).  Resets attempt ordinals and the injection
    log."""
    global _active
    with _lock:
        _active = config
        _ordinals.clear()
        _injected.clear()


def deactivate() -> None:
    activate(None)


def active() -> Optional[ChaosConfig]:
    return _active


class scope:
    """``with chaos.scope(cfg): ...`` — activate for a block (tests)."""

    def __init__(self, config: ChaosConfig):
        self._config = config

    def __enter__(self) -> ChaosConfig:
        activate(self._config)
        return self._config

    def __exit__(self, *exc) -> None:
        deactivate()


def injected_log() -> List[tuple]:
    """Snapshot of (site, key, attempt, kind) injections so far."""
    with _lock:
        return list(_injected)


def plan(site: str, key: str,
         config: Optional[ChaosConfig] = None) -> Optional[tuple]:
    """The deterministic fault plan for (site, key): ``None`` when the
    key is unaffected, ``("permanent", None)``, or ``("transient", k)``
    (fails attempts ``0..k-1``).  Pure — does not consume an attempt."""
    config = config if config is not None else _active
    if config is None:
        return None
    sc = config.sites.get(site)
    if sc is None or sc.rate <= 0:
        return None
    if _u01(config.seed, site, key, "affected") >= sc.rate:
        return None
    if _u01(config.seed, site, key, "permanent") < sc.permanent_rate:
        return ("permanent", None)
    k = 1 + int(_u01(config.seed, site, key, "prefix")
                * sc.max_attempts)
    return ("transient", min(k, sc.max_attempts))


def maybe_inject(site: str, key: str) -> None:
    """Evaluate the fault model for one attempt of (site, key); raises
    :class:`InjectedFault` / :class:`WorkerCrash` when this attempt is
    scheduled to fail, else returns.  Thread-safe; each call consumes
    one attempt ordinal for the pair."""
    config = _active
    if config is None:
        return
    p = plan(site, key, config)
    if p is None:
        return
    with _lock:
        attempt = _ordinals.get((site, key), 0)
        _ordinals[(site, key)] = attempt + 1
    kind, k = p
    if kind == "transient" and attempt >= k:
        return
    sc = config.sites[site]
    with _lock:
        _injected.append((site, key, attempt, kind))
    if sc.crash:
        raise WorkerCrash(site, key, attempt,
                          permanent=(kind == "permanent"))
    raise InjectedFault(site, key, attempt, permanent=(kind == "permanent"))


def config_from_env(environ: Optional[Mapping[str, str]] = None
                    ) -> Optional[ChaosConfig]:
    """Parse ``REPRO_CHAOS_SEED`` / ``REPRO_CHAOS_SITES`` (see module
    docstring for the grammar); returns ``None`` when no sites are set.
    Malformed specs raise ``ValueError`` — a chaos run that silently
    injects nothing would "prove" recovery vacuously."""
    environ = environ if environ is not None else os.environ
    raw = environ.get(ENV_SITES, "").strip()
    if not raw:
        return None
    sites: Dict[str, SiteConfig] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"malformed {ENV_SITES} entry {part!r} "
                             "(want name=rate[:max_attempts[:perm_rate]])")
        name, spec = part.split("=", 1)
        fields = spec.split(":")
        if len(fields) > 3:
            raise ValueError(f"malformed {ENV_SITES} entry {part!r}")
        rate = float(fields[0])
        max_attempts = int(fields[1]) if len(fields) > 1 else 2
        perm = float(fields[2]) if len(fields) > 2 else 0.0
        sites[name.strip()] = SiteConfig(
            rate=rate, max_attempts=max_attempts, permanent_rate=perm,
            crash=(name.strip() == "worker.crash"))
    return ChaosConfig(seed=int(environ.get(ENV_SEED, "0")), sites=sites)


#: exception classes (matched by name so this module stays import-light)
#: and message fragments that classify a failure as transient — worth a
#: backoff-and-retry instead of quarantine
_TRANSIENT_TYPE_NAMES = ("CorpusCacheError", "TimeoutError")
_TRANSIENT_FRAGMENTS = ("resource_exhausted", "out of memory",
                        "interrupted", "temporarily unavailable")


def is_transient(exc: BaseException) -> bool:
    """Transient-failure classification for the service's retry policy:
    injected transient faults, I/O errors (``GraphStore`` reads), OOM /
    interrupted-compile shaped runtime errors — walking the ``__cause__``
    chain so a wrapped ``SweepError`` classifies by its root cause.  A
    :class:`~repro_torch.errors.KernelError` anywhere on the chain makes
    the failure permanent, whatever the messages around it say (a
    ``SweepError`` quotes its cause, "out of memory" included): a kernel
    that did not build, load or launch fails the same way on every retry,
    and retrying it would hide it behind a quarantine."""
    chain = []
    while exc is not None and len(chain) < 8:
        chain.append(exc)
        exc = exc.__cause__ or exc.__context__
    if any(isinstance(e, KernelError) for e in chain):
        return False
    for exc in chain:
        if isinstance(exc, InjectedFault):
            return not exc.permanent
        if isinstance(exc, (OSError, MemoryError)):
            return True
        if type(exc).__name__ in _TRANSIENT_TYPE_NAMES:
            return True
        msg = str(exc).lower()
        if any(f in msg for f in _TRANSIENT_FRAGMENTS):
            return True
    return False


# ---------------------------------------------------------------------------
# Latency anomaly detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float


class StragglerMonitor:
    """Per-step wall-time EWMA with a detect-and-mitigate hook: a step
    exceeding ``threshold x`` the EWMA is recorded and handed to the
    policy callback (log | re-dispatch | drop-node).  The service uses
    the EWMA as its cases-per-second estimate for admission-control
    retry-after hints; outliers deliberately do not poison it."""

    def __init__(self, threshold: float = 3.0, alpha: float = 0.1,
                 on_straggler: Optional[Callable[[StragglerEvent], None]]
                 = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self.on_straggler = on_straggler

    def observe(self, step: int, duration: float) -> bool:
        is_straggler = (self.ewma is not None
                        and duration > self.threshold * self.ewma)
        if is_straggler:
            ev = StragglerEvent(step, duration, self.ewma)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
            # do not poison the EWMA with the outlier
        else:
            self.ewma = (duration if self.ewma is None
                         else (1 - self.alpha) * self.ewma
                         + self.alpha * duration)
        return is_straggler
