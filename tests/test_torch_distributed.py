"""The port's mesh runtime (``repro_torch.distributed``,
``fed/runtime.py::ShardedClients``, ``run_rounds(mesh=)``,
``run_async(mesh=)``) on the CPU, mirroring ``tests/test_distributed.py``.

The JAX package shards a mesh axis inside one process; the port runs one
process a rank over gloo. A module-scoped fixture writes a worker script,
starts it as 4 ranks and as 1 rank (``torch.distributed`` over a
``file://`` store, one thread each), and every rank writes what it saw to
JSON. The data is the reference's: 4,000 rows of three clusters at d = 3
over 16 Dirichlet(0.5) clients.

Bounds:
- the reference's five assertions, with its bounds;
- at 4 ranks against the port's single process: FedGenGMM bit for bit
  (client c draws the same on whatever rank it lands, and the server step
  is replicated); DEM and FedEM from injected centers and FedKMeans the
  same rounds, final avg log-likelihood (FedKMeans: centers and inertia a
  row) within 1e-4 (DESIGN.md §6). The all-reduce re-associates the rank
  sums; these runs measure 4.3e-6 (DEM), 2.4e-7 (FedEM), 4.8e-7 in the
  centers and 8.5e-7 in inertia a row (FedKMeans);
- at 4 ranks against the JAX package's single-process DEM from its own
  federated k-means centers: the same rounds, within 1e-4 (6.7e-6
  measured);
- at world size 1: ``torch.equal`` to ``SplitClients`` for all four entry
  points and for the cohort arm with stragglers;
- every rank's results the same bits.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.dem import DEMStrategy as JaxDEMStrategy
from repro.core.dem import fed_kmeans_centers as jax_fed_kmeans_centers
from repro.core.em import init_from_means as jax_init_from_means
from repro.core.partition import partition as jax_partition
from repro.fed.runtime import run_rounds as jax_run_rounds

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4

WORKER = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import split_to_clients
    from repro_torch.core.config import FitConfig
    from repro_torch.core.dem import DEMStrategy, fed_kmeans_centers
    from repro_torch.core.em import fit_gmm, init_from_means
    from repro_torch.core.fedgen import fedgengmm, fedgengmm_cfg
    from repro_torch.core.partition import partition
    from repro_torch.distributed import (dem_sharded, fed_kmeans_sharded,
                                         fedem_sharded, fedgen_sharded)
    from repro_torch.fed import (ArrivalStragglers, CyclicSampler,
                                 GaussianDP, Identity, PairwiseMask,
                                 make_sampler, run_async, run_rounds)
    from repro_torch.fed.runtime import ShardedClients
    from repro_torch.fed.strategies import (FedEMStrategy, fed_kmeans_cfg,
                                            fedem_cfg)

    torch.set_num_threads(1)
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    CPU = FitConfig(device="cpu")

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().contiguous().numpy().tobytes())
        return h.hexdigest()

    def gdig(g):
        return digest(g.weights, g.means, g.covs)

    rng = np.random.default_rng(0)
    mus = np.array([[0, 0, 0], [5, 5, 5], [-5, 5, -5]], np.float32)
    y = rng.integers(0, 3, 4000)
    x = (mus[y] + rng.normal(0, .5, (4000, 3))).astype(np.float32)
    split = partition(rng, x, y, 16, "dirichlet", 0.5)
    data, mask = split.data, split.mask
    xt = torch.as_tensor(x)
    clients = split_to_clients(split, "cpu")
    flat, flat_w = clients.data.reshape(-1, 3), clients.mask.reshape(-1)
    out, digests = {}, {}

    # the reference's five
    res = fedgen_sharded(mesh, 0, data, mask, k=3, k_global=3, h=60)
    out["fed_ll"] = float(res.global_gmm.score(xt))
    digests["fedgen"] = gdig(res.global_gmm)
    centers = fed_kmeans_centers(1, clients, 3)
    ShardedClients.collectives = 0
    gmm, rounds = dem_sharded(mesh, 2, data, mask, 3, centers)
    out["dem_collectives"] = ShardedClients.collectives
    out["dem_ll"] = float(gmm.score(xt))
    out["dem_rounds"] = int(rounds)
    digests["dem"] = gdig(gmm)
    out["central_ll"] = float(fit_gmm(3, x, 3, device="cpu").gmm.score(xt))
    ref = fedgengmm(0, split, k_clients=3, k_global=3, h=60, device="cpu")
    out["fed_ll_ref"] = float(ref.global_gmm.score(xt))
    fe = fedem_sharded(mesh, 4, data, mask, 3, participation=0.5,
                       local_epochs=2)
    out["fedem_ll"] = float(fe.global_gmm.score(xt))
    out["fedem_rounds"] = int(fe.n_rounds)
    out["fedem_uplink"] = int(fe.comm.uplink_floats)
    out["fedem_itemsize"] = int(fe.comm.itemsize)
    digests["fedem"] = gdig(fe.global_gmm)
    km = fed_kmeans_sharded(mesh, 5, data, mask, 3)
    out["km_rounds"] = int(km.n_rounds)
    out["km_uplink"] = int(km.comm.uplink_floats)
    c = km.centers.numpy()
    out["km_center_err"] = float(max(
        min(np.linalg.norm(c - m, axis=1)) for m in mus))
    digests["km"] = digest(km.centers, km.inertia)

    # against the port's single process
    single = fedgengmm_cfg(0, split, CPU, k_clients=3, k_global=3, h=60)
    out["fedgen_equal"] = gdig(single.global_gmm) == digests["fedgen"]
    out["fedgen_locals_equal"] = digest(
        *(g.means for g in single.local_gmms)) == digest(
        *res.local_means.unbind(0))
    strat = DEMStrategy(k=3)
    dem1 = run_rounds(strat, split, device="cpu", max_rounds=100,
                      state0=strat.state_from_gmm(
                          init_from_means(centers, flat, flat_w)))
    out["dem_single"] = [int(dem1.n_rounds),
                         float(dem1.global_gmm.score(xt)),
                         gdig(dem1.global_gmm) == digests["dem"]]
    fe_inj = fedem_sharded(mesh, 4, data, mask, 3, participation=0.5,
                           local_epochs=2, init_centers=centers)
    digests["fedem_injected"] = gdig(fe_inj.global_gmm)
    fstrat = FedEMStrategy(k=3, participation=0.5, local_epochs=2,
                           n_clients=16)
    fe1 = run_rounds(fstrat, split, device="cpu", max_rounds=200,
                     sampler=make_sampler("cyclic", 16, 8, seed=0),
                     state0=fstrat.state_from_gmm(
                         init_from_means(centers, flat, flat_w)))
    out["fedem_injected"] = [int(fe_inj.n_rounds), int(fe1.n_rounds),
                             float(fe_inj.log_likelihood),
                             float(fe1.log_likelihood)]
    km1 = fed_kmeans_cfg(5, split, CPU, 3)
    out["km_single"] = [int(km1.n_rounds),
                        float((km1.centers - km.centers).abs().max()),
                        (float(km.inertia) - float(km1.inertia)) / 4000,
                        km.comm == km1.comm]

    # the bits of SplitClients (held at world size 1)
    fe_split = fedem_cfg(4, split, CPU, 3, participation=0.5,
                         local_epochs=2)
    out["fedem_equal"] = [gdig(fe_split.global_gmm) == digests["fedem"],
                          fe_split.comm == fe.comm]
    out["km_equal"] = digest(km1.centers, km1.inertia) == digests["km"]
    straggle = ArrivalStragglers(0.25, seed=3)
    fs = fedem_sharded(mesh, 4, data, mask, 3, participation=0.5,
                       local_epochs=2, stragglers=straggle)
    fs1 = fedem_cfg(4, split, CPU, 3, participation=0.5, local_epochs=2,
                    stragglers=straggle)
    digests["fedem_stragglers"] = gdig(fs.global_gmm)
    out["stragglers_equal"] = [gdig(fs1.global_gmm) == gdig(fs.global_gmm),
                               int(fs.n_rounds), int(fs1.n_rounds)]

    # the JAX package's centers
    jc = np.load(outdir + "/jax_centers.npy")
    gj, rj = dem_sharded(mesh, 2, data, mask, 3, jc)
    out["dem_at_jax_centers"] = [int(rj), float(gj.score(xt))]

    # the transform seam (test_fed_transforms.py's sharded subprocess)
    rng2 = np.random.default_rng(0)
    x2 = rng2.uniform(0.05, 0.95, (1600, 3)).astype(np.float32)
    y2 = rng2.integers(0, 2, 1600)
    split2 = partition(rng2, x2, y2, 16, "dirichlet", 100.0)
    centers2 = fed_kmeans_centers(1, split_to_clients(split2, "cpu"), 2)

    def seam(t):
        g, _ = dem_sharded(mesh, 2, split2.data, split2.mask, 2, centers2,
                           max_rounds=4, transform=t)
        return gdig(g)

    base = seam(None)
    ShardedClients.collectives = 0
    masked = seam(PairwiseMask())
    out["mask_collectives"] = ShardedClients.collectives
    out["seam"] = [seam(Identity()) == base, masked == base,
                   seam(GaussianDP(epsilon=2.0, rounds=4)) != base]
    digests["seam"] = base

    # the int32 channel: a leaf near 2^31 from every rank
    ints = torch.tensor([2**31 - 1 - rank, -2**31 + rank, 7],
                        dtype=torch.int32)
    total = ShardedClients(data, mask, mesh).all_reduce(
        {"i": ints, "f": torch.tensor([0.5])})
    out["int32"] = [total["i"].dtype == torch.int32, total["i"].tolist(),
                    total["f"].tolist()]

    # async: the sync-equivalent configuration gives run_rounds' bits
    dstrat = DEMStrategy(k=3, tol=0.0)
    state0 = dstrat.state_from_gmm(init_from_means(centers, flat, flat_w))
    a = run_async(dstrat, (data, mask), mesh=mesh, state0=state0,
                  max_rounds=5)
    r = run_rounds(dstrat, (data, mask), mesh=mesh, state0=state0,
                   max_rounds=5)
    fstate0 = fstrat.state_from_gmm(init_from_means(centers, flat, flat_w))
    fa = run_async(fstrat, split, mesh=mesh, state0=fstate0, max_rounds=5,
                   sampler=CyclicSampler(16, 8))
    fr = run_rounds(fstrat, split, mesh=mesh, state0=fstate0, max_rounds=5,
                    sampler=CyclicSampler(16, 8))
    out["async"] = [gdig(a.global_gmm) == gdig(r.global_gmm),
                    gdig(fa.global_gmm) == gdig(fr.global_gmm),
                    a.n_rounds == r.n_rounds > 1
                    and a.comm._replace(staleness=()) == r.comm]
    digests["async"] = gdig(a.global_gmm)

    # errors
    try:
        fedgen_sharded(mesh, 0, data[:world + 2], mask[:world + 2], 3, 3)
        out["indivisible_raises"] = world == 1
    except ValueError:
        out["indivisible_raises"] = True
    if world == 1:
        cmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        try:
            fedgen_sharded(cmesh, 0, data, mask, 3, 3)
            out["cuda_mesh_raises"] = torch.cuda.is_available()
        except RuntimeError:
            out["cuda_mesh_raises"] = True

    out["digests"] = digests
    with open(f"{outdir}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


def _launch(workdir: Path, world: int) -> list:
    """Run the worker as ``world`` gloo ranks; each rank's JSON."""
    script = workdir / "worker.py"
    script.write_text(WORKER)
    store = workdir / f"store{world}"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(world)]


def _jax_reference(workdir: Path):
    """JAX's federated k-means centers (saved for the workers) and its
    single-process DEM from them: (rounds, avg loglik over the rows)."""
    rng = np.random.default_rng(0)
    mus = np.array([[0, 0, 0], [5, 5, 5], [-5, 5, -5]], np.float32)
    y = rng.integers(0, 3, 4000)
    x = (mus[y] + rng.normal(0, .5, (4000, 3))).astype(np.float32)
    split = jax_partition(rng, x, y, 16, "dirichlet", 0.5)
    centers = np.asarray(jax_fed_kmeans_centers(jax.random.key(1), split, 3))
    np.save(workdir / "jax_centers.npy", centers)
    strat = JaxDEMStrategy(k=3)
    g0 = jax_init_from_means(jnp.asarray(centers),
                             jnp.asarray(split.data.reshape(-1, 3)),
                             jnp.asarray(split.mask.reshape(-1)))
    res = jax_run_rounds(strat, split, key=jax.random.key(2),
                         state0=strat.state_from_gmm(g0, dtype=jnp.float32),
                         max_rounds=100)
    return int(res.n_rounds), float(res.global_gmm.score(jnp.asarray(x)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    four = tmp_path_factory.mktemp("world4")
    one = tmp_path_factory.mktemp("world1")
    jax_dem = _jax_reference(four)
    np.save(one / "jax_centers.npy", np.load(four / "jax_centers.npy"))
    return {"four": _launch(four, WORLD), "one": _launch(one, 1),
            "jax_dem": jax_dem}


# ----------------------------------------------------------------------
# The reference's five (tests/test_distributed.py), at 4 ranks
# ----------------------------------------------------------------------

def test_sharded_fedgen_close_to_centralized(runs):
    r = runs["four"][0]
    assert r["fed_ll"] > r["central_ll"] - 0.3, r


def test_sharded_dem_close_to_centralized(runs):
    r = runs["four"][0]
    assert r["dem_ll"] > r["central_ll"] - 0.3, r
    assert r["dem_rounds"] >= 2


def test_sharded_matches_single_process(runs):
    r = runs["four"][0]
    assert abs(r["fed_ll"] - r["fed_ll_ref"]) < 0.25, r


def test_sharded_fedem_fits_with_cohort_ledger(runs):
    """8 of 16 clients a round, diag stats for k=3, d=3 (3 + 9 + 9 + 2
    floats each), plus the fed-kmeans warm start of all 16 clients."""
    r = runs["four"][0]
    assert r["fedem_ll"] > r["central_ll"] - 0.5, r
    assert r["fedem_uplink"] == \
        r["fedem_rounds"] * 8 * (3 + 9 + 9 + 2) + 16 * (9 + 3), r
    assert r["fedem_itemsize"] == 4


def test_sharded_fed_kmeans_recovers_centers(runs):
    """Label stats a round (16 clients x (k + k*d + 1) floats), the
    rescore scalar a client once, and the warm start."""
    r = runs["four"][0]
    assert r["km_center_err"] < 0.5, r
    assert r["km_uplink"] == \
        r["km_rounds"] * 16 * (3 + 9 + 1) + 16 + 16 * (9 + 3), r


# ----------------------------------------------------------------------
# Against the port's single process and the JAX package, at 4 ranks
# ----------------------------------------------------------------------

def test_fedgen_at_four_ranks_is_the_single_process_bits(runs):
    r = runs["four"][0]
    assert r["fedgen_locals_equal"] and r["fedgen_equal"]
    assert r["fed_ll"] == r["fed_ll_ref"]


@pytest.mark.parametrize("arm", ["dem", "fedem", "fedkmeans"])
def test_iterative_at_four_ranks_within_1e4_of_single_process(runs, arm):
    r = runs["four"][0]
    if arm == "dem":
        rounds, ll, _ = r["dem_single"]
        assert r["dem_rounds"] == rounds
        assert abs(r["dem_ll"] - ll) <= 1e-4
    elif arm == "fedem":
        got_rounds, rounds, got_ll, ll = r["fedem_injected"]
        assert got_rounds == rounds
        assert abs(got_ll - ll) <= 1e-4
    else:
        rounds, center_gap, inertia_gap, same_comm = r["km_single"]
        assert r["km_rounds"] == rounds and same_comm
        assert center_gap <= 1e-4 and abs(inertia_gap) <= 1e-4


def test_dem_at_four_ranks_from_jax_centers_matches_jax(runs):
    rounds, ll = runs["four"][0]["dem_at_jax_centers"]
    jax_rounds, jax_ll = runs["jax_dem"]
    assert rounds == jax_rounds
    assert abs(ll - jax_ll) <= 1e-4


def test_one_all_reduce_a_round(runs):
    """DEM from injected centers: two all-reduces for the init's two-pass
    variance, then one a round; the masked run adds the int32 channel's
    one a round."""
    for world in ("four", "one"):
        r = runs[world][0]
        assert r["dem_collectives"] == r["dem_rounds"] + 2
    assert runs["four"][0]["mask_collectives"] == 2 + 2 * 4


# ----------------------------------------------------------------------
# World size 1: the bits of SplitClients
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["fedgen", "dem", "fedem", "fedkmeans",
                                 "cohort_stragglers"])
def test_world_size_one_is_split_clients(runs, arm):
    r = runs["one"][0]
    if arm == "fedgen":
        assert r["fedgen_equal"] and r["fedgen_locals_equal"]
    elif arm == "dem":
        assert r["dem_single"][2] and r["dem_rounds"] == r["dem_single"][0]
    elif arm == "fedem":
        assert r["fedem_equal"] == [True, True]
        got_rounds, rounds, got_ll, ll = r["fedem_injected"]
        assert got_rounds == rounds and got_ll == ll
    elif arm == "fedkmeans":
        assert r["km_equal"] and r["km_single"][1] == 0.0
    else:
        same, rounds, rounds1 = r["stragglers_equal"]
        assert same and rounds == rounds1


# ----------------------------------------------------------------------
# Replication, the transform seam, the int32 channel, async, errors
# ----------------------------------------------------------------------

def test_every_rank_holds_the_same_bits(runs):
    ranks = runs["four"]
    assert len(ranks) == WORLD
    for other in ranks[1:]:
        assert other["digests"] == ranks[0]["digests"]


@pytest.mark.parametrize("what", ["identity_same", "mask_same",
                                  "dp_differs"])
def test_transform_seam_at_four_ranks(runs, what):
    identity_same, mask_same, dp_differs = runs["four"][0]["seam"]
    assert {"identity_same": identity_same, "mask_same": mask_same,
            "dp_differs": dp_differs}[what]


def test_int32_channel_wraps_across_ranks(runs):
    def wrap(v):
        return (v + 2**31) % 2**32 - 2**31

    is_int32, got, floats = runs["four"][0]["int32"]
    ranks = range(WORLD)
    assert is_int32
    assert got == [wrap(sum(2**31 - 1 - r for r in ranks)),
                   wrap(sum(-2**31 + r for r in ranks)), 7 * WORLD]
    assert got[0] == -WORLD - sum(ranks)
    assert floats == [0.5 * WORLD]


def test_async_sync_equivalent_is_run_rounds(runs):
    for world in ("four", "one"):
        assert runs[world][0]["async"] == [True, True, True]


def test_errors(runs):
    assert runs["four"][0]["indivisible_raises"]
    assert runs["one"][0]["cuda_mesh_raises"]
