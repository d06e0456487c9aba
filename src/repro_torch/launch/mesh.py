"""Production mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches no
process group: a mesh is built over whatever group the caller initialised
(``torch.distributed.init_process_group``), on the card's device type
unless the caller asks for another. Only ``launch/dryrun.py``, in a
process of its own, builds the production meshes, over a fake group of 256
or 512 ranks.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: (data=16, model=16), 256 ranks. Multi-pod: (pod=2,
    data=16, model=16), 512 ranks. The initialised group must have that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type="cuda"):
    """A (data, model) mesh over the initialised group's ranks (one card
    under NCCL; gloo ranks on the CPU)."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world size {n}")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def fsdp_axes(multi_pod: bool):
    """The spec entry used for FSDP sharding of parameters: batch-parallel
    axes also shard the parameter d_model/d_ff dimensions (ZeRO-3 style)."""
    return ("pod", "data") if multi_pod else "data"


def batch_axes(multi_pod: bool, global_batch: int):
    """Axes over which the batch dimension shards (None when the batch is
    too small to shard, e.g. long-context B=1 decode)."""
    total = 32 if multi_pod else 16
    if global_batch % total == 0:
        return ("pod", "data") if multi_pod else "data"
    if global_batch % 16 == 0:
        return "data"
    return None
