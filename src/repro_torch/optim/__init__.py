"""The substrate's optimizer (port of ``repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     global_norm, init_opt_state,
                                     opt_state_specs, schedule)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "opt_state_specs", "schedule"]
