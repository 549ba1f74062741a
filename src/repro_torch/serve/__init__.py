"""``repro_torch.serve`` — the resident simulation-sweep service.

:mod:`repro_torch.serve.engine` is the supervised multi-tenant job engine
(:class:`SimService`, on the card unless ``device=`` says otherwise);
:mod:`repro_torch.serve.chaos` is the deterministic fault-injection layer
that proves its recovery paths.
"""

# Lazy re-exports (PEP 562): ``repro_torch.sim.sweep`` and
# ``repro_torch.graphs.corpus`` import the chaos module while
# ``repro_torch.serve.engine`` imports the sweep engine — eagerly importing
# engine here would close that loop into a cycle.
_CHAOS = ("ChaosConfig", "SiteConfig", "InjectedFault", "WorkerCrash",
          "StragglerMonitor")
_ENGINE = ("SimService", "SimJob", "ServiceStats", "QUEUED", "RUNNING",
           "DONE", "FAILED", "CANCELLED", "EXPIRED", "RetryPolicy",
           "AdmissionConfig", "AdmissionError", "BreakerConfig",
           "CircuitOpenError", "JobFailed", "JobCancelled", "JobExpired",
           "ServiceError")


def __getattr__(name):
    import importlib
    if name in _CHAOS:
        return getattr(importlib.import_module("repro_torch.serve.chaos"),
                       name)
    if name in _ENGINE:
        return getattr(importlib.import_module("repro_torch.serve.engine"),
                       name)
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")


__all__ = [
    "SimService", "SimJob", "ServiceStats",
    "QUEUED", "RUNNING", "DONE", "FAILED", "CANCELLED", "EXPIRED",
    "RetryPolicy", "AdmissionConfig", "AdmissionError", "BreakerConfig",
    "CircuitOpenError", "JobFailed", "JobCancelled", "JobExpired",
    "ServiceError", "ChaosConfig", "SiteConfig", "InjectedFault",
    "WorkerCrash", "StragglerMonitor",
]
