"""Serving subsystem of the port: the continuous-batching decode engine
for the global model (``engine``) and the synthetic open-loop request
generator with its replay driver (``loadgen``), and the bridge that turns
a training checkpoint into serve params (``bridge``)."""
from repro_torch.serve.bridge import load_serve_params
from repro_torch.serve.engine import Completion, Engine, Request
from repro_torch.serve.loadgen import LoadSpec, generate_requests, replay

__all__ = ["Completion", "Engine", "LoadSpec", "Request",
           "generate_requests", "load_serve_params", "replay"]
