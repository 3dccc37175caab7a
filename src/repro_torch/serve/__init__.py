"""Serving on the port's models: the static-batch :class:`ServeEngine`."""
from repro_torch.serve.engine import (NULL_TRACER, EngineStats, Request,
                                      ServeEngine)

__all__ = ["EngineStats", "NULL_TRACER", "Request", "ServeEngine"]
