"""Sharding context: a thin registry the model layers consult.

Layers never import mesh machinery directly; the code that builds a
step installs a :class:`ShardCtx` and layers call :func:`constrain` with
logical names.
Without a context everything is a no-op, as in ``repro``, so the model
code runs single-device.  The port's LM layers do not shard yet: with a
context installed :func:`constrain` raises rather than dropping the hint
(the LM sharding item of ``ROADMAP.md``'s queue 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional

_STATE = threading.local()


@dataclasses.dataclass
class ShardCtx:
    mesh: Any
    rules: Dict[str, Any]
    # axis names used by the expert-parallel MoE path
    token_axes: tuple = ("pod", "data")
    expert_axis: str = "model"

    def spec(self, name: str) -> Optional[Any]:
        return self.rules.get(name)


def current() -> Optional[ShardCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use(ctx: Optional[ShardCtx]):
    prev = current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def constrain(x, name: str):
    """The identity with no context installed; with one, the named
    sharding hint is not ported yet and raises ``NotImplementedError``."""
    if current() is None:
        return x
    raise NotImplementedError(
        f"sharding hint {name!r}: the LM layers' sharding (param_spec, "
        "activation_rules, make_ctx) is ROADMAP.md queue 1, item 11, "
        "not ported yet")
