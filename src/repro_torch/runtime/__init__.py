"""Serving runtime of the PyTorch port: deterministic fault injection,
the serving supervisor and the continuous-batching engine.

``faults`` and the worker-failure types are dependency-light and imported
eagerly. The serving side (``ServingSupervisor``) and the batching engine
pull in the model/plan stack, so they load lazily on first attribute
access, as in the reference. The training ``Supervisor`` comes with
ROADMAP A.12, the shadow auditor with A.9b.
"""
from repro_torch.runtime import faults as faults  # noqa: PLC0414 (re-export)
from repro_torch.runtime.supervisor import (RunState, StepMonitor,
                                            TransientWorkerError)

__all__ = ["StepMonitor", "RunState", "TransientWorkerError", "faults",
           "ServingSupervisor", "ServeStats", "serving",
           "HEALTHY", "DEGRADED", "FAILED",
           "BatchingEngine", "StreamHandle", "batching"]

_SERVING_EXPORTS = ("ServingSupervisor", "ServeStats", "serving",
                    "HEALTHY", "DEGRADED", "FAILED")

# The batching engine sits on top of serving and the model stack -- same
# lazy-load treatment.
_BATCHING_EXPORTS = ("BatchingEngine", "StreamHandle", "batching")


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
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")
