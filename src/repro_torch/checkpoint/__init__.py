from repro_torch.checkpoint.store import (latest_version, leaf_spec,
                                          load_checkpoint, load_published,
                                          publish_checkpoint,
                                          save_checkpoint)

__all__ = ["load_checkpoint", "save_checkpoint", "publish_checkpoint",
           "latest_version", "load_published", "leaf_spec"]
