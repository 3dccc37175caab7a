"""Tracing seams of the port (see :mod:`repro_torch.obs.trace`)."""
from repro_torch.obs.trace import NULL_TRACER, NullTracer, postmortem_dump

__all__ = ["NULL_TRACER", "NullTracer", "postmortem_dump"]
