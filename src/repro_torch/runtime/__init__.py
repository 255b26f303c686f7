"""Runtime of the PyTorch port: the training supervisor, deterministic
fault injection, the serving supervisor, the continuous-batching engine
and the shadow auditor.

``faults`` and the training supervisor are dependency-light and imported
eagerly (``ckpt`` hooks fault points into checkpoint writes). The serving
side (``ServingSupervisor``), the batching engine and the auditor pull in
the model/plan stack, so they load lazily on first attribute access, as
in the reference.
"""
from repro_torch.runtime import faults as faults  # noqa: PLC0414 (re-export)
from repro_torch.runtime.supervisor import (RunState, StepMonitor,
                                            Supervisor, TransientWorkerError)

__all__ = ["Supervisor", "StepMonitor", "RunState", "TransientWorkerError",
           "faults",
           "ServingSupervisor", "ServeStats", "serving",
           "HEALTHY", "DEGRADED", "FAILED",
           "BatchingEngine", "StreamHandle", "batching",
           "ShadowAuditor", "audit"]

_SERVING_EXPORTS = ("ServingSupervisor", "ServeStats", "serving",
                    "HEALTHY", "DEGRADED", "FAILED")

# The batching engine sits on top of serving and the model stack -- same
# lazy-load treatment.
_BATCHING_EXPORTS = ("BatchingEngine", "StreamHandle", "batching")

# The shadow auditor builds reference sessions (model stack) -- lazy too.
_AUDIT_EXPORTS = ("ShadowAuditor", "audit")


def __getattr__(name: str):
    import importlib
    if name in _SERVING_EXPORTS:
        serving = importlib.import_module("repro_torch.runtime.serving")
        if name == "serving":
            return serving
        return getattr(serving, name)
    if name in _BATCHING_EXPORTS:
        batching = importlib.import_module("repro_torch.runtime.batching")
        if name == "batching":
            return batching
        return getattr(batching, name)
    if name in _AUDIT_EXPORTS:
        audit = importlib.import_module("repro_torch.runtime.audit")
        if name == "audit":
            return audit
        return getattr(audit, name)
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")
