"""Architecture configs of the port (one module per arch, each citing its
source paper): the dense-attention and MoE decoders."""
from repro_torch.configs.base import (INPUT_SHAPES, get_citation, get_config,
                                      list_archs, register)

__all__ = ["INPUT_SHAPES", "get_citation", "get_config", "list_archs",
           "register"]
