"""Continuous-batching serving engine."""
from repro_torch.serve.engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
