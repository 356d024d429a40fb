"""Serving subsystem of the port: the continuous-batching decode engine
for the global model (``engine``) and the synthetic open-loop request
generator with its replay driver (``loadgen``). The checkpoint bridge
(``bridge``) comes with the LM-training slice, whose trainer state it
reads."""
from repro_torch.serve.engine import Completion, Engine, Request
from repro_torch.serve.loadgen import LoadSpec, generate_requests, replay

__all__ = ["Completion", "Engine", "LoadSpec", "Request",
           "generate_requests", "replay"]
