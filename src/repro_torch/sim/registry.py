"""Accelerator spec registry: one named entry point per accelerator model.

An :class:`AcceleratorSpec` wraps everything the session facade needs to
drive a model generically:

* ``config_cls``      — the model's frozen config dataclass (must expose a
  ``dram: Optional[DRAMConfig]`` field so any memory can be plugged in);
* ``build_model``     — construct the (graph-bound) model;
* ``run_algorithm``   — produce the per-iteration :class:`RunResult` the
  trace generation consumes;
* ``algorithm_key``   — hashable identity of that run, for deduplication;
* ``incremental_run`` — the warm-started repair after an update batch
  (the dynamic-graph path);
* ``variants``        — named optimization-variant config overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, List, Optional, Type

from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core.accel import SimReport
from repro_torch.core.dram import DRAMConfig
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs.formats import Graph

VECTORIZED, EVENT = "vectorized", "event"


class AcceleratorSpec:
    """Base class for registered accelerator specs.

    Subclasses set the class attributes and implement the model hooks.
    Specs are stateless: all per-run state lives in the model instances
    they build.
    """

    #: registry key, e.g. ``"hitgraph"``
    name: str = ""
    #: one-line description shown by ``list_accelerators(verbose=True)``
    description: str = ""
    #: config dataclass; must have a ``dram`` field for memory override
    config_cls: Type = None
    #: supported DRAM backends
    backends: tuple = (VECTORIZED, EVENT)

    # -- config ---------------------------------------------------------
    def make_config(self, config=None, memory: Optional[DRAMConfig] = None,
                    cache=None, **overrides):
        """Resolve the effective config: defaults <- config <- overrides
        <- memory (a resolved :class:`DRAMConfig` replaces ``dram``)
        <- cache (a resolved :class:`~repro_torch.core.cache.CacheConfig`
        replaces the memory point's on-chip level; a disabled config
        strips it, ``None`` leaves it as it is)."""
        cfg = config if config is not None else self.config_cls()
        if not isinstance(cfg, self.config_cls):
            raise TypeError(
                f"accelerator {self.name!r} expects a "
                f"{self.config_cls.__name__}, got {type(cfg).__name__}")
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if memory is not None:
            cfg = dataclasses.replace(cfg, dram=memory)
        if cache is not None:
            from repro_torch.core.cache import effective
            dram = (cfg.dram_config() if hasattr(cfg, "dram_config")
                    else cfg.dram)
            cfg = dataclasses.replace(cfg, dram=dataclasses.replace(
                dram, cache=effective(cache)))
        return cfg

    def default_cache(self):
        """The accelerator's paper on-chip hierarchy (selected with
        ``cache="default"``); ``None`` when the spec declares none.  The
        pipeline stays cache-free unless a cache is asked for."""
        return None

    def variants(self) -> Dict[str, Dict[str, Any]]:
        """Named optimization variants as config-field overrides."""
        return {"baseline": {}}

    def design_space(self):
        """The accelerator's default searchable design space (a
        :class:`repro_torch.tune.space.DesignSpace`), or ``None`` when the
        spec declares none.  Implementations import ``repro_torch.tune``
        lazily — the tune package depends on this module."""
        return None

    def apply_variant(self, config, variant: Optional[str]):
        if variant is None or variant == "baseline":
            return config
        table = self.variants()
        if variant not in table:
            raise UnknownPresetError("variant", variant, table)
        return dataclasses.replace(config, **table[variant])

    # -- model hooks ----------------------------------------------------
    def build_model(self, g: Graph, config):
        raise NotImplementedError

    def run_algorithm(self, g: Graph, problem: Problem, config,
                      root: int = 0, fixed_iters: Optional[int] = None,
                      device=None) -> RunResult:
        """The algorithm execution whose per-iteration statistics drive
        trace generation.  MUST be bit-identical to what the model would
        compute internally when ``run=None`` (parity contract)."""
        raise NotImplementedError

    def algorithm_key(self, g: Graph, problem: Problem, config,
                      root: int = 0,
                      fixed_iters: Optional[int] = None) -> Hashable:
        """Cache key identifying :meth:`run_algorithm`'s inputs."""
        raise NotImplementedError

    def incremental_run(self, g_old: Graph, g_new: Graph, batch,
                        problem: Problem, old_values, config,
                        root: int = 0, plan=None,
                        device=None) -> RunResult:
        """Repair ``old_values`` (converged on ``g_old``) after ``batch``
        took the graph to ``g_new``; bit-identical to
        :meth:`run_algorithm` on ``g_new``."""
        raise NotImplementedError(
            f"accelerator {self.name!r} has no incremental variant")

    # -- simulation -----------------------------------------------------
    def preferred_backend(self) -> str:
        return VECTORIZED if VECTORIZED in self.backends else self.backends[0]

    def simulate(self, g: Graph, problem: Problem, config=None,
                 backend: Optional[str] = None, root: int = 0,
                 fixed_iters: Optional[int] = None,
                 run: Optional[RunResult] = None,
                 model=None, device=None) -> SimReport:
        from repro_torch.sim.backends import make_backend
        cfg = config if config is not None else self.config_cls()
        if backend is None:
            backend = self.preferred_backend()
        if backend not in self.backends:
            raise ValueError(
                f"accelerator {self.name!r} supports backends "
                f"{self.backends}, got {backend!r}")
        if model is None:
            model = self.build_model(g, cfg)
        # The backend is built from the CASE's resolved DRAM, not the
        # model's: a session shares one model across every timing
        # variant of a geometry (model state never depends on timing).
        dram = (cfg.dram_config() if hasattr(cfg, "dram_config")
                else model.dram)
        memory_system = make_backend(backend, dram, device=device)
        return model.simulate(problem, root=root, fixed_iters=fixed_iters,
                              run=run, memory_system=memory_system,
                              device=device)


_REGISTRY: Dict[str, AcceleratorSpec] = {}


def register_accelerator(spec):
    """Register an :class:`AcceleratorSpec` (class decorator or instance).
    Returns the argument unchanged so it stacks as a decorator."""
    instance = spec() if isinstance(spec, type) else spec
    if not instance.name:
        raise ValueError("accelerator spec needs a non-empty name")
    _REGISTRY[instance.name] = instance
    return spec


def get_accelerator(name) -> AcceleratorSpec:
    """Look up a spec by name (or pass an AcceleratorSpec through)."""
    if isinstance(name, AcceleratorSpec):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownPresetError("accelerator", name, _REGISTRY) from None


def list_accelerators(verbose: bool = False) -> List:
    """Registered accelerator names (sorted), or (name, description)
    pairs with ``verbose=True``."""
    if verbose:
        return [(n, _REGISTRY[n].description) for n in sorted(_REGISTRY)]
    return sorted(_REGISTRY)
