"""The port's models: every family of the JAX package (``model``; the moe
layer in ``moe``), their attention primitives (``attention``) and
selective state-space layers (``ssm``), parameter specs (``params``), the
training forward's per-layer remat (``remat``) and the serving paths,
prefill and one-token decode against a KV cache, SSM state or the encdec
cross cache (``decode``)."""
from repro_torch.models.decode import (cache_spec, decode_step, init_cache,
                                       prefill)
from repro_torch.models.model import (ModelCtx, features, forward,
                                      head_logits, model_specs)
from repro_torch.models.params import init_params, param_count

__all__ = ["ModelCtx", "cache_spec", "decode_step", "features", "forward",
           "head_logits", "init_cache", "init_params", "model_specs",
           "param_count", "prefill"]
