"""Continuous-batching serving engine, and the mesh of KV-sharded
serving."""
from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.serve.sharded import resolve_serving_mesh, serving_ctx

__all__ = ["ServeConfig", "ServingEngine", "resolve_serving_mesh",
           "serving_ctx"]
