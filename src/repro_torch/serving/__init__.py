"""Serving: the ServingEngine data plane + the shared EpochRuntime.

``ServingEngine`` / ``GenerationResult`` / ``DecodeState`` are lazily
re-exported so that importing the scheduling runtime does not pull in
torch.
"""
from repro_torch.serving.runtime import (AnalyticContinuousExecutor,  # noqa: F401
                                         AnalyticExecutor, ContinuousExecutor,
                                         ContinuousRuntime,
                                         EngineContinuousExecutor,
                                         EngineExecutor, EpochRuntime,
                                         Executor)

__all__ = ["ServingEngine", "GenerationResult", "DecodeState",
           "EpochRuntime", "ContinuousRuntime", "Executor",
           "AnalyticExecutor", "EngineExecutor", "ContinuousExecutor",
           "AnalyticContinuousExecutor", "EngineContinuousExecutor"]


def __getattr__(name):
    if name in ("ServingEngine", "GenerationResult", "DecodeState"):
        from repro_torch.serving import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
