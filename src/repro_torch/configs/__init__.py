"""Architecture configs of the port (one module per arch, each citing its
source paper): all ten architectures of the JAX package."""
from repro_torch.configs.base import (INPUT_SHAPES, decode_capacity,
                                      get_citation, get_config, input_specs,
                                      list_archs, register, uses_ring)

__all__ = ["INPUT_SHAPES", "decode_capacity", "get_citation", "get_config",
           "input_specs", "list_archs", "register", "uses_ring"]
