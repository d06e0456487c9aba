"""Model substrate of the port: the transformer stack of every registered
architecture."""
from repro_torch.models.common import count_params
from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            cache_specs, decode_step,
                                            init_cache, init_params,
                                            param_specs, prefill_forward,
                                            train_forward)

__all__ = ["ModelConfig", "Transformer", "cache_specs", "count_params",
           "decode_step", "init_cache", "init_params", "param_specs",
           "prefill_forward", "train_forward"]
