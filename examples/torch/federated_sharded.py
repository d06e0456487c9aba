"""The mesh-collective federated runtime: clients as data-axis shards of a
``torch.distributed`` ``DeviceMesh``. FedGenGMM is ONE all-gather; DEM is
one all-reduce a round. The counterpart of ``examples/federated_sharded.py``
with the same data, split and seeds.

One process a rank. Alone, it makes a group of one rank on a ``file://``
store (NCCL on the card, gloo on the CPU):

    PYTHONPATH=src python examples/torch/federated_sharded.py     # the card
    PYTHONPATH=src python examples/torch/federated_sharded.py --device cpu

Under ``torchrun`` it takes the launcher's group (the 16 clients must
divide among the ranks); each rank uses the card of its local rank:

    PYTHONPATH=src torchrun --nproc-per-node 4 \\
        examples/torch/federated_sharded.py
"""
import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.api import FitConfig, GMMEstimator
from repro_torch.convert import split_to_clients
from repro_torch.core.dem import fed_kmeans_centers
from repro_torch.core.partition import partition
from repro_torch.distributed import dem_sharded, fedgen_sharded


def _init_group(device: str, store_dir: str) -> None:
    """The launcher's group under ``torchrun``, else one rank."""
    backend = "nccl" if device == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    if device == "cuda":
        # NCCL's bootstrap needs an interface; one rank needs only loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1)


def main(argv=None) -> dict:
    """Run the example; return the numbers it printed (every rank holds
    them, rank 0 prints them)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("federated_sharded.py: no CUDA card (torch.cuda."
                         "is_available() is False); pass --device cpu")
    with tempfile.TemporaryDirectory() as store_dir:
        _init_group(args.device, store_dir)
        try:
            return _run(args.device)
        finally:
            dist.destroy_process_group()


def _run(device: str) -> dict:
    world = dist.get_world_size()
    mesh = init_device_mesh(device, (world,), mesh_dim_names=("data",))
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh}")

    rng = np.random.default_rng(0)
    mus = rng.normal(0, 5, (4, 6)).astype(np.float32)
    y = rng.integers(0, 4, 6000)
    x = (mus[y] + rng.normal(0, 0.5, (6000, 6))).astype(np.float32)
    split = partition(rng, x, y, 16, "dirichlet", 0.3)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    xt = torch.as_tensor(x, device=dev)

    # the sharded runtime consumes the same FitConfig as the facades
    cfg = FitConfig(device=device)
    res = fedgen_sharded(mesh, 0, split.data, split.mask, k=4, k_global=4,
                         h=80, config=cfg)
    ll_fedgen = float(res.global_gmm.score(xt))
    say(f"FedGenGMM (1 all-gather):   ll={ll_fedgen:.4f}")

    centers = fed_kmeans_centers(1, split_to_clients(split, dev), 4)
    gmm, rounds = dem_sharded(mesh, 2, split.data, split.mask, 4, centers,
                              config=cfg.replace(max_iter=100))
    ll_dem = float(gmm.score(xt))
    say(f"DEM ({int(rounds)} all-reduce rounds):  ll={ll_dem:.4f}")

    bench = GMMEstimator(4, seed=3, device=device).fit(xt)
    ll_central = float(bench.score(xt))
    say(f"non-federated benchmark:    ll={ll_central:.4f}")
    return {"world_size": world, "ll_fedgen": ll_fedgen,
            "dem_rounds": int(rounds), "ll_dem": ll_dem,
            "ll_central": ll_central}


if __name__ == "__main__":
    main()
