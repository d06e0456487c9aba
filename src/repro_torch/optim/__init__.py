"""The substrate's optimizer (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     global_norm, init_opt_state, schedule)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule"]
