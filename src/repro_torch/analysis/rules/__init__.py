"""Rule modules register themselves on import; importing this package
is what populates :data:`repro_torch.analysis.framework.RULES`."""

from repro_torch.analysis.rules import (cache_keys, determinism, dtype_drift,
                                        exception_hygiene, jax_hazards,
                                        kernel_parity, quarantine, scenario)

__all__ = ["cache_keys", "determinism", "dtype_drift",
           "exception_hygiene", "jax_hazards", "kernel_parity",
           "quarantine", "scenario"]
