"""The seed's language models -- counterpart of `repro.models`: ten
architectures in six families (dense, moe, ssm, encdec, vlm, hybrid) as
``nn.Module`` blocks, with the JAX package's parameter names, init rule,
caches and entry points (`model`).  No Pallas kernel lies on this path
in the JAX package, and none is written here: plain tensor ops, as the
JAX modules' einsums are."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (
    Model, cache_specs, count_params, decode_step, forward, forward_hidden,
    init_model, layer_windows, model_flops, prefill,
)

__all__ = ["ModelConfig", "Model", "init_model", "forward", "forward_hidden",
           "prefill", "decode_step", "cache_specs", "layer_windows",
           "count_params", "model_flops"]
