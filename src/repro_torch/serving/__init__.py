"""Serving: the ServingEngine data plane + the shared EpochRuntime.

``ServingEngine`` / ``GenerationResult`` are lazily re-exported so that
importing the scheduling runtime does not pull in torch.
"""
from repro_torch.serving.runtime import (AnalyticExecutor,  # noqa: F401
                                         EngineExecutor, EpochRuntime,
                                         Executor)

__all__ = ["ServingEngine", "GenerationResult", "EpochRuntime", "Executor",
           "AnalyticExecutor", "EngineExecutor"]


def __getattr__(name):
    if name in ("ServingEngine", "GenerationResult"):
        from repro_torch.serving import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
