"""Dynamic lock-order / race instrumentation (the runtime half of the
analysis suite).

The static rules cannot see *runtime* locking discipline, so the
concurrency-critical shared state in the simulation platform — the
``SimSession`` single-flight caches, the ``Sweeper`` session table, the
``SimService`` job tables, and the corpus resolver memo — is built
through two factories here:

- :func:`make_lock` returns a :class:`TrackedLock`: a plain mutex plus
  owner tracking, per-thread held-stack bookkeeping, and lock-order
  edge recording.
- :func:`make_dict` returns a :class:`GuardedDict`: a ``dict`` that
  records a finding whenever it is touched by a thread not holding its
  guard lock.

The wrappers are ALWAYS installed (so module-level locks created at
import time are covered), but every check is gated per-operation on the
``REPRO_ANALYSIS_LOCKS`` environment variable — when unset, the only
cost over a bare ``threading.Lock`` is owner bookkeeping.  Detected
hazards accumulate in a process-wide registry, deduplicated by
``(kind, detail)``:

``lock-order-inversion``  two roles acquired in both nesting orders —
                          a deadlock waiting for the right interleaving
``nested-same-role``      holding one lock of a role while taking
                          another of the same role (ABBA within a role)
``reacquire``             re-acquiring a held non-reentrant lock
                          (recorded just before the deadlock it causes)
``unguarded-access``      a :class:`GuardedDict` op without its guard
``concurrent-write``      two threads inside :func:`witness_write` for
                          the same path at once

``tests/test_torch_concurrency_stress.py`` hammers the instrumented
stack with ``REPRO_ANALYSIS_LOCKS=1`` and asserts :func:`findings` stays
empty while results stay bit-identical to serial execution.  The flag,
the finding kinds and their detail strings are those of the JAX
package's witness, so one setting instruments both packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

ENV_FLAG = "REPRO_ANALYSIS_LOCKS"


def enabled() -> bool:
    """Checked per operation, so setting the flag after import works."""
    return os.environ.get(ENV_FLAG, "") not in ("", "0")


@dataclasses.dataclass(frozen=True)
class LockFinding:
    kind: str
    detail: str

    def format(self) -> str:
        return f"{self.kind}: {self.detail}"


_registry_lock = threading.Lock()
_findings: Dict[Tuple[str, str], LockFinding] = {}
_order_edges: Dict[Tuple[str, str], bool] = {}    # (outer, inner) seen
_inflight_writes: Dict[str, int] = {}             # path -> thread ident
_made: Dict[str, int] = {}                        # role -> locks made
_tls = threading.local()


def _held() -> List["TrackedLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _record(kind: str, detail: str) -> None:
    with _registry_lock:
        _findings.setdefault((kind, detail), LockFinding(kind, detail))


def findings() -> List[LockFinding]:
    """Hazards recorded so far (deduplicated, deterministic order)."""
    with _registry_lock:
        return sorted(_findings.values(),
                      key=lambda f: (f.kind, f.detail))


def made() -> Dict[str, int]:
    """Locks made by :func:`make_lock` since the last :func:`reset`, by
    role (counted whether or not the flag is set)."""
    with _registry_lock:
        return dict(sorted(_made.items()))


def reset() -> None:
    """Clear recorded findings, order edges and the count of locks made
    (for test isolation)."""
    with _registry_lock:
        _findings.clear()
        _order_edges.clear()
        _inflight_writes.clear()
        _made.clear()


def assert_clean() -> None:
    found = findings()
    if found:
        raise AssertionError(
            "lock instrumentation recorded hazards:\n  "
            + "\n  ".join(f.format() for f in found))


class TrackedLock:
    """``threading.Lock`` plus role-tagged ordering instrumentation.

    Non-reentrant, same blocking semantics as the lock it wraps; safe
    as a drop-in for ``with``-style use.
    """

    __slots__ = ("role", "_lock", "_owner")

    def __init__(self, role: str):
        self.role = role
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def _note_acquire(self) -> None:
        me = threading.get_ident()
        if self._owner == me:
            _record("reacquire",
                    f"thread re-acquiring held non-reentrant lock "
                    f"{self.role!r}")
        for outer in _held():
            if outer is self:
                continue
            if outer.role == self.role:
                _record("nested-same-role",
                        f"acquiring a {self.role!r} lock while already "
                        f"holding another {self.role!r} lock")
                continue
            edge = (outer.role, self.role)
            rev = (self.role, outer.role)
            with _registry_lock:
                _order_edges.setdefault(edge, True)
                inverted = rev in _order_edges
            if inverted:
                _record("lock-order-inversion",
                        f"locks {outer.role!r} and {self.role!r} "
                        f"acquired in both nesting orders")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if enabled():
            self._note_acquire()     # before blocking, so a deadlock
        got = self._lock.acquire(blocking, timeout)   # is still logged
        if got:
            self._owner = threading.get_ident()
            _held().append(self)
        return got

    def release(self) -> None:
        stack = _held()
        if self in stack:
            stack.remove(self)
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"TrackedLock({self.role!r})"


class GuardedDict(dict):
    """A ``dict`` that must only be touched under its guard lock."""

    def __init__(self, name: str, guard: TrackedLock):
        super().__init__()
        self._gd_name = name
        self._gd_guard = guard

    def _check(self, op: str) -> None:
        if enabled() and not self._gd_guard.held_by_current_thread():
            _record("unguarded-access",
                    f"{op} on {self._gd_name} without holding "
                    f"{self._gd_guard.role!r}")

    # reads --------------------------------------------------------------
    def __getitem__(self, key):
        self._check("__getitem__")
        return super().__getitem__(key)

    def get(self, key, default=None):
        self._check("get")
        return super().get(key, default)

    def __contains__(self, key):
        self._check("__contains__")
        return super().__contains__(key)

    def __iter__(self):
        self._check("__iter__")
        return super().__iter__()

    def __len__(self):
        self._check("__len__")
        return super().__len__()

    def keys(self):
        self._check("keys")
        return super().keys()

    def values(self):
        self._check("values")
        return super().values()

    def items(self):
        self._check("items")
        return super().items()

    # writes -------------------------------------------------------------
    def __setitem__(self, key, value):
        self._check("__setitem__")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check("__delitem__")
        super().__delitem__(key)

    def pop(self, key, *default):
        self._check("pop")
        return super().pop(key, *default)

    def setdefault(self, key, default=None):
        self._check("setdefault")
        return super().setdefault(key, default)

    def clear(self):
        self._check("clear")
        super().clear()

    def update(self, *args, **kwargs):
        self._check("update")
        super().update(*args, **kwargs)


def make_lock(role: str) -> TrackedLock:
    """Instrumented replacement for ``threading.Lock()``; ``role`` tags
    the lock's position in the intended acquisition order."""
    with _registry_lock:
        _made[role] = _made.get(role, 0) + 1
    return TrackedLock(role)


def make_dict(name: str, guard: TrackedLock) -> GuardedDict:
    """Dict whose every access must happen while ``guard`` is held by
    the calling thread."""
    return GuardedDict(name, guard)


@contextlib.contextmanager
def witness_write(path):
    """Record a ``concurrent-write`` finding if two threads are ever
    inside this context for the same path simultaneously (used around
    the corpus store's tmp-file writes)."""
    key = str(path)
    me = threading.get_ident()
    if enabled():
        with _registry_lock:
            other = _inflight_writes.get(key)
            _inflight_writes.setdefault(key, me)
        if other is not None and other != me:   # record outside the
            _record("concurrent-write",         # registry lock
                    f"two threads writing {key} concurrently")
    try:
        yield
    finally:
        if enabled():
            with _registry_lock:
                if _inflight_writes.get(key) == me:
                    del _inflight_writes[key]
