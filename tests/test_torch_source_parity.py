"""The port's out-of-core engines against ``repro``'s on the CPU, on the
same numpy rows streamed as sources.

Deterministic stages run from injected state in both packages: E-step
statistics within 2e-4; fits from one initial model with the same
iteration count and final avg log-likelihood within 1e-4 (DESIGN.md §6);
k-means from injected centers; DEM, FedEM and FedKMeans over ragged
source clients from one initial model or set of centers, with the same
rounds and ledgers. Within the port, fits over ``ArraySource``,
``NpyFileSource`` and ``ConcatSource`` holding the same rows are
bit-identical, and a source fit equals the resident fit at the same chunk
bit for bit. The seeded stages (streamed k-means++, the synthetic replay)
are held to their properties: chunk invariance, distinct real rows,
planted centers recovered, FedGenGMM's quality against a central fit.
The working set is held to O(chunk) by a dispatch-mode spy that sees
every tensor the fit creates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.api import FedGenGMM as JaxFedGen
from repro.core import em as jem
from repro.core.dem import DEMStrategy as JaxDEMStrategy
from repro.core.gmm import GMM as JaxGMM
from repro.core.kmeans import kmeans_source as jax_kmeans_source
from repro.data import sources as jsrc
from repro.fed.runtime import run_rounds as jax_run_rounds
from repro.fed.strategies import FedEMStrategy as JaxFedEMStrategy
from repro.fed.strategies import FedKMeansState as JaxFedKMeansState
from repro.fed.strategies import FedKMeansStrategy as JaxFedKMeansStrategy
from repro_torch import api
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core import em, kmeans
from repro_torch.core.dem import DEMStrategy
from repro_torch.core.gmm import GMM
from repro_torch.data.sources import (ArraySource, ConcatSource, DataSource,
                                      NpyFileSource, SyntheticGMMSource)
from repro_torch.fed.runtime import run_rounds
from repro_torch.fed.strategies import (FedEMStrategy, FedKMeansState,
                                        FedKMeansStrategy)

from conftest import planted_gmm_data

CHUNK = 512  # deliberately not dividing the 3000-row fixture
CPU = api.FitConfig(device="cpu", chunk_size=CHUNK)
CUTS = [0, 450, 1300, 1999, 3000]  # ragged clients


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(17)
    x, _, mus = planted_gmm_data(rng, n=3000, d=4, k=3, spread=5.0, std=0.5,
                                 min_sep_sigma=8.0)
    return x, mus


@pytest.fixture(scope="module")
def init(setup):
    """One initial model for both packages: planted means moved off their
    optimum, unit weights, the data's variance."""
    x, mus = setup
    mu = (mus + np.random.default_rng(1).normal(0, 1.0, mus.shape)
          ).astype(np.float32)
    var = np.tile(x.var(0), (3, 1)).astype(np.float32)
    return np.full(3, 1 / 3, np.float32), mu, var


def jsources(x):
    return [jsrc.ArraySource(x[a:b]) for a, b in zip(CUTS, CUTS[1:])]


def sources(x):
    return [ArraySource(x[a:b]) for a, b in zip(CUTS, CUTS[1:])]


def arrays(g):
    return tuple(np.array(a) for a in (g.weights, g.means, g.covs))


def assert_same_gmm(g1, g2):
    for a, b in zip(gmm_to_numpy(g1), gmm_to_numpy(g2)):
        np.testing.assert_array_equal(a, b)


def assert_close_gmm(got, exp, tol=2e-4):
    for a, b in zip(gmm_to_numpy(got), arrays(exp)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def assert_same_comm(got, exp):
    assert (got.rounds, got.uplink_floats, got.downlink_floats,
            got.itemsize) == (exp.rounds, exp.uplink_floats,
                              exp.downlink_floats, exp.itemsize)


# ----------------------------------------------------------------------
# Engines against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_estep_stats_over_a_source_match_jax(setup, init, backend):
    x, _ = setup
    got = em.e_step_stats(gmm_from_numpy(*init, "cpu"), ArraySource(x),
                          estep_backend=backend, chunk_size=CHUNK)
    exp = jem.e_step_stats(JaxGMM(*map(jnp.asarray, init)),
                           jsrc.ArraySource(x), chunk_size=CHUNK)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=2e-4,
                                   atol=2e-4)
    assert float(got.wsum) == 3000.0


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_fit_from_injected_init_matches_jax_source_fit(setup, init, backend):
    x, _ = setup
    exp = jem.fit_gmm(jax.random.key(0), jsrc.ArraySource(x), 3,
                      init_gmm=JaxGMM(*map(jnp.asarray, init)), tol=1e-5,
                      max_iter=60, chunk_size=CHUNK)
    got = em.fit_gmm_cfg(0, ArraySource(x), 3,
                         CPU.replace(backend=backend, tol=1e-5, max_iter=60),
                         init_gmm=gmm_from_numpy(*init, "cpu"))
    assert int(got.n_iter) == int(exp.n_iter) > 2
    assert abs(float(got.log_likelihood)
               - float(exp.log_likelihood)) <= 1e-4
    assert_close_gmm(got.gmm, exp.gmm)


def test_kmeans_source_from_injected_centers_matches_jax(setup):
    x, mus = setup
    c0 = (mus + np.random.default_rng(3).normal(0, 1.5, mus.shape)
          ).astype(np.float32)
    exp = jax_kmeans_source(jax.random.key(0), jsrc.ArraySource(x), 3,
                            chunk_size=CHUNK, init_centers=jnp.asarray(c0))
    got = kmeans.kmeans_source(0, ArraySource(x), 3, chunk_size=CHUNK,
                               init_centers=torch.as_tensor(c0),
                               assign_backend="reference")
    assert got.assignments is None and exp.assignments is None
    assert int(got.n_iter) == int(exp.n_iter)
    np.testing.assert_allclose(got.centers.numpy(), np.array(exp.centers),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.inertia), float(exp.inertia),
                               rtol=1e-4)
    np.testing.assert_array_equal(got.cluster_sizes.numpy(),
                                  np.array(exp.cluster_sizes))


def test_init_from_means_streams_the_jax_moments(setup):
    x, _ = setup
    centers = x[:3]
    got = em.init_from_means(torch.as_tensor(centers), ArraySource(x),
                             chunk_size=CHUNK)
    exp = jem.init_from_means(jnp.asarray(centers), jsrc.ArraySource(x),
                              chunk_size=CHUNK)
    for a, b in zip(gmm_to_numpy(got), arrays(exp)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    resident = em.init_from_means(torch.as_tensor(centers),
                                  torch.as_tensor(x))
    np.testing.assert_allclose(got.covs.numpy(), resident.covs.numpy(),
                               rtol=1e-3)


def test_bic_over_a_source_picks_the_jax_k(setup):
    x, _ = setup
    best, bics = em.fit_gmm_bic_cfg(0, ArraySource(x), [2, 3, 4], CPU)
    _, jbics = jem.fit_gmm_bic(jax.random.key(5), jsrc.ArraySource(x),
                               [2, 3, 4], chunk_size=CHUNK)
    assert min(bics, key=bics.get) == min(jbics, key=jbics.get) == 3
    assert best.gmm.n_components == 3
    np.testing.assert_allclose(bics[3], jbics[3], rtol=1e-3)


# ----------------------------------------------------------------------
# Within the port: source types, resident paths, scoring
# ----------------------------------------------------------------------

def test_npy_and_concat_fits_equal_the_array_source_fit(setup, tmp_path):
    """Same rows, same chunk partition -> the same block loop -> the same
    bits, whatever storage backs the stream (seeded init included)."""
    x, _ = setup
    path, tail = tmp_path / "x.npy", tmp_path / "tail.npy"
    np.save(path, x)
    np.save(tail, x[2050:])
    ragged = ConcatSource([ArraySource(x[:700]), ArraySource(x[700:701]),
                           ArraySource(x[701:2050]), NpyFileSource(tail)])
    base = em.fit_gmm_cfg(0, ArraySource(x), 3, CPU)
    for src in (NpyFileSource(path), ragged):
        res = em.fit_gmm_cfg(0, src, 3, CPU)
        assert_same_gmm(base.gmm, res.gmm)
        assert int(res.n_iter) == int(base.n_iter)


def test_synthetic_stream_fits_as_its_materialized_rows(setup):
    _, mus = setup
    truth = GMM(torch.full((3,), 1 / 3), torch.as_tensor(mus),
                torch.full((3, 4), 0.25))
    src = SyntheticGMMSource(truth, 3000, seed=9)
    streamed = em.fit_gmm_cfg(1, src, 3, CPU)
    resident = em.fit_gmm_cfg(1, ArraySource(src.materialize(CHUNK)), 3, CPU)
    assert_same_gmm(streamed.gmm, resident.gmm)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_source_fit_equals_resident_fit_at_the_same_chunk(setup, init,
                                                           backend):
    x, _ = setup
    cfg = CPU.replace(backend=backend)
    g0 = gmm_from_numpy(*init, "cpu")
    src = em.fit_gmm_cfg(0, ArraySource(x), 3, cfg, init_gmm=g0)
    res = em.fit_gmm_cfg(0, x, 3, cfg, init_gmm=g0)
    assert int(src.n_iter) == int(res.n_iter)
    assert_same_gmm(src.gmm, res.gmm)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_scoring_over_a_source_equals_resident_scoring(setup, init, backend):
    x, _ = setup
    g = gmm_from_numpy(*init, "cpu")
    cfg = CPU.replace(backend=backend)
    xs, xt = ArraySource(x), torch.as_tensor(x)
    for fn in (api.score, api.bic, api.log_prob):
        assert torch.equal(fn(g, xs, config=cfg), fn(g, xt, config=cfg))
    np.testing.assert_allclose(
        float(api.score(g, xs, config=cfg)),
        float(JaxGMM(*map(jnp.asarray, init)).score(jnp.asarray(x))),
        rtol=1e-5)


def test_streamed_kmeanspp_is_chunk_invariant_and_draws_real_rows(setup):
    x, _ = setup
    src = ArraySource(x)
    c = kmeans.kmeans_plusplus_streaming(4, src, 6, 256, "cpu")
    for chunk in (97, 1000, 4096):
        assert torch.equal(
            c, kmeans.kmeans_plusplus_streaming(4, src, 6, chunk, "cpu"))
    rows = {tuple(r) for r in x.tolist()}
    picked = [tuple(r) for r in c.tolist()]
    assert all(p in rows for p in picked)
    assert len(set(picked)) == 6
    assert not torch.equal(
        c, kmeans.kmeans_plusplus_streaming(5, src, 6, 256, "cpu"))


def test_kmeans_source_recovers_planted_centers(setup):
    x, mus = setup
    res = api.KMeansEstimator(3, n_init=2, config=CPU).fit(ArraySource(x))
    assert res.assignments_ is None  # the one O(N) output, not collected
    got = res.centers_.numpy()
    dists = np.linalg.norm(got[:, None] - mus[None], axis=-1)
    assert dists.min(axis=0).max() < 0.5
    assert float(res.result_.cluster_sizes.sum()) == float(len(x))


# ----------------------------------------------------------------------
# Federated runs over ragged source clients
# ----------------------------------------------------------------------

def test_fedgen_over_ragged_sources(setup):
    """The seeded pipeline (streamed seeding, replayed S) is compared by
    quality: within 0.35 of a central fit (the JAX test's bound) and within
    0.05 of the JAX package's run (seed 0 reads -4.0176 here against
    -4.0083 there); the ledger is the same."""
    x, _ = setup
    fr = api.FedGenGMM(k_clients=3, k_global=3, h=40,
                       config=CPU).run(sources(x), seed=0)
    jr = JaxFedGen(k_clients=3, k_global=3, h=40, chunk_size=CHUNK).run(
        jsources(x), key=jax.random.key(0))
    bench = api.GMMEstimator(3, config=CPU).fit(x, seed=1)
    ll_fed = float(api.score(fr.global_gmm, x, config=CPU))
    ll_jax = float(jr.global_gmm.score(jnp.asarray(x)))
    assert ll_fed > float(bench.score(x)) - 0.35
    assert abs(ll_fed - ll_jax) < 0.05, (ll_fed, ll_jax)
    assert isinstance(fr.synthetic, DataSource)  # S never resident
    assert fr.synthetic.num_rows == jr.synthetic.num_rows == 40 * 3 * 4
    assert_same_comm(fr.comm, jr.comm)
    resident = api.FedGenGMM(k_clients=3, k_global=3, h=40,
                             synthetic="resident",
                             config=CPU).run(sources(x), seed=0)
    assert isinstance(resident.synthetic, torch.Tensor)


@pytest.mark.parametrize("init_name", ["separated", "fed-kmeans"])
def test_dem_over_sources_from_injected_init_matches_jax(setup, init,
                                                         init_name):
    x, _ = setup
    kw = dict(k=3, init=init_name, chunk=CHUNK, tol=1e-4)
    jstrat = JaxDEMStrategy(host=True, **kw)
    exp = jax_run_rounds(jstrat, jsources(x), key=jax.random.key(0),
                         state0=jstrat.state_from_gmm(
                             JaxGMM(*map(jnp.asarray, init))),
                         max_rounds=60)
    strat = DEMStrategy(**kw)
    got = run_rounds(strat, sources(x), device="cpu", max_rounds=60,
                     state0=strat.state_from_gmm(
                         gmm_from_numpy(*init, "cpu")))
    assert got.n_rounds == int(exp.n_rounds) > 2
    assert abs(float(got.log_likelihood)
               - float(exp.log_likelihood)) <= 1e-4
    assert_close_gmm(got.global_gmm, exp.global_gmm)
    assert_same_comm(got.comm, exp.comm)


def test_dem_facade_over_sources(setup):
    x, _ = setup
    auto = api.DEM(3, config=CPU).run(sources(x), seed=0)
    sep = api.DEM(3, init="separated", config=CPU).run(sources(x), seed=0)
    assert auto.n_rounds == sep.n_rounds
    assert_same_gmm(auto.global_gmm, sep.global_gmm)
    fk = api.DEM(3, init="fed-kmeans", config=CPU).run(sources(x), seed=0)
    bench = float(api.GMMEstimator(3, config=CPU).fit(x, seed=1).score(x))
    assert float(fk.log_likelihood) > bench - 0.05
    assert fk.comm.rounds == fk.n_rounds
    with pytest.raises(ValueError, match="pilot"):
        api.DEM(3, init="pilot", config=CPU).run(sources(x), seed=0)


def test_fedem_over_sources_from_injected_init_matches_jax(setup, init):
    x, _ = setup
    kw = dict(k=3, init="separated", chunk=CHUNK, tol=1e-4, local_epochs=2,
              n_clients=4)
    jstrat = JaxFedEMStrategy(host=True, **kw)
    exp = jax_run_rounds(jstrat, jsources(x), key=jax.random.key(0),
                         state0=jstrat.state_from_gmm(
                             JaxGMM(*map(jnp.asarray, init))),
                         max_rounds=60)
    strat = FedEMStrategy(**kw)
    got = run_rounds(strat, sources(x), device="cpu", max_rounds=60,
                     state0=strat.state_from_gmm(
                         gmm_from_numpy(*init, "cpu")))
    assert got.n_rounds == int(exp.n_rounds) > 1
    assert abs(float(got.log_likelihood)
               - float(exp.log_likelihood)) <= 1e-4
    assert_close_gmm(got.global_gmm, exp.global_gmm)
    assert_same_comm(got.comm, exp.comm)
    part = api.FedEM(3, participation=0.5, config=CPU).run(sources(x), seed=0)
    assert part.comm.rounds == part.n_rounds >= 2


def test_fedkmeans_over_sources_from_injected_centers_matches_jax(setup):
    x, mus = setup
    c0 = (mus + np.random.default_rng(3).normal(0, 1.5, mus.shape)
          ).astype(np.float32)
    jstrat = JaxFedKMeansStrategy(k=3, init="separated", chunk=CHUNK,
                                  host=True)
    inf = float("inf")
    exp = jax_run_rounds(jstrat, jsources(x), key=jax.random.key(0),
                         state0=JaxFedKMeansState(jnp.asarray(c0), inf, inf,
                                                  1e-4), max_rounds=100)
    strat = FedKMeansStrategy(k=3, init="separated", chunk=CHUNK)
    t_inf = torch.tensor(inf)
    got = run_rounds(strat, sources(x), device="cpu", max_rounds=100,
                     state0=FedKMeansState(torch.as_tensor(c0), t_inf, t_inf,
                                           1e-4))
    assert got.n_rounds == int(exp.n_rounds)
    np.testing.assert_allclose(got.centers.numpy(), np.array(exp.centers),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.inertia), float(exp.inertia),
                               rtol=1e-4)
    assert_same_comm(got.comm, exp.comm)
    fac = api.FedKMeans(3, config=CPU).run(sources(x), seed=0)
    assert fac.comm.rounds == fac.n_rounds


# ----------------------------------------------------------------------
# The facades' dispatch, and the working set
# ----------------------------------------------------------------------

def test_facade_dispatch_errors(setup):
    x, _ = setup
    src = ArraySource(x)
    with pytest.raises(TypeError, match="accepts an \\(N, d\\) array or a "
                       "DataSource"):
        api.GMMEstimator(3, config=CPU).fit(sources(x))
    with pytest.raises(TypeError, match="ClientSplit or a list"):
        api.FedGenGMM(k_clients=3, k_global=3, config=CPU).run(src)
    with pytest.raises(TypeError, match="not a list of DataSources"):
        api.DEM(3, config=CPU).run([x[:10], x[10:20]])
    with pytest.raises(TypeError, match="empty"):
        api.FedEM(3, config=CPU).run([])
    with pytest.raises(TypeError, match="cannot dispatch"):
        api.score(GMM(torch.ones(1), torch.zeros(1, 4), torch.ones(1, 4)),
                  "rows", config=CPU)
    with pytest.raises(ValueError, match="sample_weight is only supported"):
        api.GMMEstimator(3, config=CPU).fit(src, sample_weight=np.ones(3000))
    with pytest.raises(ValueError, match="sample_weight"):
        api.KMeansEstimator(3, config=CPU).fit(src,
                                               sample_weight=np.ones(3000))
    g = api.GMMEstimator(3, config=CPU).fit(src, seed=0)
    with pytest.raises(ValueError, match="sample_weight"):
        g.score(src, sample_weight=np.ones(3000))
    with pytest.raises(ValueError, match="sample_weight"):
        g.bic(src, sample_weight=np.ones(3000))
    with pytest.raises(ValueError, match="synthetic"):
        api.FedGenGMM(k_clients=3, k_global=3, synthetic="disk")
    assert api.GMMEstimator(3, device="cpu").fit(src).gmm_.device.type \
        == "cpu"


class _NoLargeTensors(TorchDispatchMode):
    """Fails the moment any operation creates a tensor with a dimension
    longer than ``max_rows``: a leaked O(N) materialization."""

    def __init__(self, max_rows: int):
        super().__init__()
        self.max_rows = max_rows
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and t.ndim:
                assert max(t.shape) <= self.max_rows, \
                    f"O(N) tensor {tuple(t.shape)} from {func}"
        self.ops += 1
        return out


class _CountingSource(DataSource):
    def __init__(self, inner):
        self._inner = inner
        self.blocks = 0

    num_rows = property(lambda self: self._inner.num_rows)
    dim = property(lambda self: self._inner.dim)

    def iter_blocks(self, chunk_size):
        for block in self._inner.iter_blocks(chunk_size):
            self.blocks += 1
            yield block


def test_million_row_synthetic_fit_constant_memory():
    """N = 1M rows at 65,536-row blocks: every tensor the fit creates, its
    seeding, Lloyd sweeps, label pass and EM included, is at most 4 blocks
    long; the fit reads the stream many times over and recovers the
    planted mixture."""
    n, chunk = 1_000_000, 65536
    truth = GMM(torch.tensor([0.4, 0.6]),
                torch.tensor([[-4.0, 0.0, 2.0, 1.0], [4.0, 1.0, -2.0, 0.0]]),
                torch.full((2, 4), 0.3))
    src = _CountingSource(SyntheticGMMSource(truth, n, seed=11))
    spy = _NoLargeTensors(4 * chunk)
    with spy:
        res = api.GMMEstimator(2, chunk_size=chunk, max_iter=5,
                               device="cpu").fit(src, seed=0).result_
    assert spy.ops > 1000
    assert src.blocks >= 2 * src.num_blocks(chunk)  # multi-pass
    assert bool(torch.isfinite(res.gmm.means).all())
    got = np.sort(res.gmm.means[:, 0].numpy())
    np.testing.assert_allclose(got, [-4.0, 4.0], atol=0.1)
    np.testing.assert_allclose(np.sort(res.gmm.weights.numpy()), [0.4, 0.6],
                               atol=0.02)


def test_materialize_is_the_opt_in_exception():
    truth = GMM(torch.ones(1), torch.zeros((1, 2)), torch.ones((1, 2)))
    src = SyntheticGMMSource(truth, 1024, seed=0)
    assert tuple(src.materialize(256).shape) == (1024, 2)
