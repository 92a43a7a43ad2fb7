"""Tracing for the port: the same span/event recorder as the reference."""
from repro_torch.obs.trace import TRACER, Tracer

__all__ = ["TRACER", "Tracer"]
