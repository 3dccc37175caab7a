"""Serving on the port's models: the static-batch :class:`ServeEngine` and
the slot-based :class:`ContinuousBatchEngine`."""
from repro_torch.serve.continuous import ContinuousBatchEngine
from repro_torch.serve.engine import (NULL_TRACER, EngineStats, Request,
                                      ServeEngine)

__all__ = ["ContinuousBatchEngine", "EngineStats", "NULL_TRACER", "Request",
           "ServeEngine"]
