"""Architecture configs of the port (one module per arch, each citing its
source paper): all ten architectures of the JAX package."""
from repro_torch.configs.base import (INPUT_SHAPES, get_citation, get_config,
                                      list_archs, register)

__all__ = ["INPUT_SHAPES", "get_citation", "get_config", "list_archs",
           "register"]
