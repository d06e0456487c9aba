"""The port's DEM (``repro_torch.core.dem``) against ``repro.core.dem`` on
the CPU, on the same numpy split.

DEM runs from one injected initial model in both packages (the
deterministic stage): final avg log-likelihood within 1e-4 (DESIGN.md §6),
parameters within 2e-4, the same round count and the same ledger, for
diagonal and full covariance. The random init stages draw from the port's
generators, so they are held to their properties: the farthest-point step
on the JAX package's own candidates, the pilot subset on real rows only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dem import DEMStrategy as JaxDEMStrategy
from repro.core.dem import max_separated_centers as jax_separated
from repro.core.em import init_from_means as jax_init_from_means
from repro.core.gmm import GMM as JaxGMM
from repro.core.partition import ClientSplit as JaxSplit
from repro.fed.runtime import run_rounds as jax_run_rounds
from repro_torch import api
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.convert import split_to_clients
from repro_torch.core.dem import (INIT_SCHEME_NAMES, DEMState, DEMStrategy,
                                  farthest_point_centers, fed_kmeans_centers,
                                  max_separated_centers,
                                  pilot_subset_centers)
from repro_torch.core.em import init_from_means
from repro_torch.core.partition import partition
from repro_torch.fed.ledger import gmm_payload_floats, stats_payload_floats
from repro_torch.fed.runtime import run_rounds

from conftest import planted_gmm_data

K, D, C = 3, 4, 6
CPU = api.FitConfig(device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    x, y, mus = planted_gmm_data(rng, n=1800, d=D, k=K, spread=5.0,
                                 std=0.5, min_sep_sigma=8.0)
    split = partition(np.random.default_rng(0), x, y, C, "dirichlet", 0.5)
    return x, mus, split


def _arrays(g):
    """(weights, means, covs) of a JAX model as numpy arrays."""
    return tuple(np.array(a) for a in (g.weights, g.means, g.covs))


def _gmm0(split, mus, covariance_type):
    """One initial model for both packages: planted means moved off their
    optimum, the data's variance (init_from_means' rule)."""
    centers = (mus + np.random.default_rng(1).normal(0, 1.0, mus.shape)
               ).astype(np.float32)
    flat = split.data.reshape(-1, D)
    w = split.mask.reshape(-1)
    g = jax_init_from_means(jnp.asarray(centers), jnp.asarray(flat),
                            jnp.asarray(w), covariance_type=covariance_type)
    return _arrays(g)


def assert_same_comm(got, exp):
    assert (got.rounds, got.uplink_floats, got.downlink_floats,
            got.itemsize) == (exp.rounds, exp.uplink_floats,
                              exp.downlink_floats, exp.itemsize)
    assert got.payload_bytes == exp.payload_bytes


@pytest.mark.parametrize("covariance_type", ["diag", "full"])
def test_dem_from_injected_init_matches_jax(setup, covariance_type):
    _, mus, split = setup
    g0 = _gmm0(split, mus, covariance_type)
    jstrat = JaxDEMStrategy(k=K, covariance_type=covariance_type,
                            init="separated", tol=1e-4)
    exp = jax_run_rounds(jstrat, JaxSplit(*split), key=jax.random.key(0),
                         state0=jstrat.state_from_gmm(
                             JaxGMM(*map(jnp.asarray, g0)),
                             dtype=jnp.float32),
                         max_rounds=60)
    strat = DEMStrategy(k=K, covariance_type=covariance_type,
                        init="separated", tol=1e-4)
    got = run_rounds(strat, split, device="cpu",
                     state0=strat.state_from_gmm(gmm_from_numpy(*g0, "cpu")),
                     max_rounds=60)
    assert got.n_rounds == int(exp.n_rounds) > 2
    assert got.converged == bool(exp.converged)
    assert abs(float(got.log_likelihood)
               - float(exp.log_likelihood)) <= 1e-4
    for a, b in zip(gmm_to_numpy(got.global_gmm), _arrays(exp.global_gmm)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    assert_same_comm(got.comm, exp.comm)
    diag = covariance_type == "diag"
    assert got.comm.uplink_floats == got.n_rounds * C * stats_payload_floats(
        K, D, diag)
    assert got.comm.downlink_floats == (got.n_rounds + 1) * C * \
        gmm_payload_floats(K, D, diag)


def test_init_from_means_matches_jax(setup):
    x, mus, split = setup
    w = split.mask.reshape(-1)
    flat = split.data.reshape(-1, D)
    for cov in ("diag", "full"):
        exp = jax_init_from_means(jnp.asarray(mus), jnp.asarray(flat),
                                  jnp.asarray(w), covariance_type=cov)
        got = init_from_means(torch.as_tensor(mus), torch.as_tensor(flat),
                              torch.as_tensor(w), covariance_type=cov)
        for a, b in zip(gmm_to_numpy(got), _arrays(exp)):
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6)
    g = init_from_means(torch.zeros(4, D), torch.as_tensor(x))
    np.testing.assert_allclose(g.weights.numpy(), 0.25, rtol=1e-6)
    assert bool((g.covs > 0).all())


@pytest.mark.parametrize("k,d", [(8, 5), (30, 4)])
def test_farthest_point_step_on_jax_candidates(k, d):
    """``max_separated_centers`` draws 2048 uniforms from its key, then runs
    the greedy step; fed the same candidates, the port's step picks the
    same centers."""
    key = jax.random.key(3)
    cand = np.array(jax.random.uniform(key, (2048, d)))
    got = farthest_point_centers(torch.as_tensor(cand), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_separated(key, k, d)))


def test_max_separated_centers_spread():
    c = max_separated_centers(0, 8, 5)
    assert c.shape == (8, 5)
    assert bool(((c >= 0) & (c <= 1)).all())
    d2 = ((c[:, None] - c[None]) ** 2).sum(-1) + torch.eye(8)
    assert float(d2.min()) > 1e-3
    assert torch.equal(c, max_separated_centers(0, 8, 5))
    assert not torch.equal(c, max_separated_centers(1, 8, 5))


def test_pilot_subset_ignores_padding(setup):
    """Padded rows are NaN here: a pilot fit that drew one would not be
    finite."""
    _, _, split = setup
    assert (split.mask == 0).any()
    data = split.data.copy()
    data[split.mask == 0] = np.nan
    poisoned = split._replace(data=data)
    centers = pilot_subset_centers(0, poisoned, K, device="cpu")
    assert centers.shape == (K, D)
    assert bool(torch.isfinite(centers).all())
    assert torch.equal(centers, pilot_subset_centers(0, poisoned, K,
                                                     device="cpu"))


def test_fed_kmeans_centers(setup):
    """Init 3 on the split: k centers, each near a planted mean."""
    _, mus, split = setup
    centers = fed_kmeans_centers(0, split_to_clients(split, "cpu"), K)
    assert centers.shape == (K, D)
    np.testing.assert_allclose(np.sort(centers.numpy(), axis=0),
                               np.sort(mus, axis=0), atol=0.3)


def test_nan_halts_the_loop_and_reports_not_converged(setup):
    s = DEMStrategy(k=2)
    state = DEMState(gmm=None, prev_ll=-1.0, ll=float("nan"), tol=1e-3,
                     reg_covar=1e-6)
    assert not s.keep_going(state)
    assert not s.converged(state)
    _, mus, split = setup
    g0 = list(_gmm0(split, mus, "diag"))
    g0[1] = g0[1].copy()
    g0[1][0, 0] = np.nan
    strat = DEMStrategy(k=K, init="separated")
    res = run_rounds(strat, split, device="cpu", max_rounds=50,
                     state0=strat.state_from_gmm(gmm_from_numpy(*g0, "cpu")))
    assert res.n_rounds == 1 and res.converged is False
    assert res.comm.rounds == 1


@pytest.mark.parametrize("init", sorted(INIT_SCHEME_NAMES.values()))
def test_all_inits_converge(setup, init):
    x, _, split = setup
    res = api.DEM(K, init=init, config=CPU).run(split, seed=0)
    assert res.converged and res.n_rounds >= 2
    assert bool(torch.isfinite(res.global_gmm.means).all())
    assert res.comm.rounds == res.n_rounds
    bench = api.GMMEstimator(K, config=CPU).fit(x, seed=1)
    assert float(api.score(res.global_gmm, x, config=CPU)) > \
        float(bench.score(x)) - 0.3


def test_dem_validation(setup):
    with pytest.raises(ValueError, match="kmeans"):
        api.DEM(K, init="kmeans", device="cpu")
    with pytest.raises(TypeError):
        api.DEM(K, transform=None, device="cpu")
    _, _, split = setup
    bare = split_to_clients(split, "cpu")
    bare.split = None
    with pytest.raises(ValueError, match="ClientSplit"):
        api.DEM(K, init="pilot", config=CPU).run(bare)


def test_separated_init_lands_low_in_both_packages():
    """ROADMAP Queue C, R6: DEM's "separated" init ends far below the other
    inits in the JAX package as in the port, so the gap is a property of
    the reference's scheme (farthest points of the unit hypercube), not of
    the port. On this 6,000-row mnist_like split (20 clients, K = 30),
    seeds 0-2, this test reads JAX 13.180, 13.234, 12.959 and the port
    12.845, 12.872, 12.644; the port from JAX's own separated centers
    2.0e-5, 7.1e-5, 5.9e-5 from JAX; fed-kmeans (seed 0) 21.058 in JAX
    and 21.404 in the port. Bounds: from JAX's centers 2e-4; the means
    over the seeds within 0.5 (0.337 apart); separated at least 7 below
    fed-kmeans in each package (7.93 and 8.62 below)."""
    from repro.api import DEM as JaxDEM
    from repro.core.partition import partition as jax_partition
    from repro_torch.data.datasets import mnist_like

    ds = mnist_like(np.random.default_rng(0), n_train=6000)
    split = partition(np.random.default_rng(0), ds.x_train, ds.y_train, 20,
                      "dirichlet", 0.5)
    jsplit = jax_partition(np.random.default_rng(0), ds.x_train,
                           ds.y_train, 20, "dirichlet", 0.5)
    clients = split_to_clients(split, "cpu")
    flat, flat_w = clients.data.reshape(-1, 24), clients.mask.reshape(-1)
    jax_ll, port_ll = [], []
    for seed in range(3):
        exp = JaxDEM(30, init="separated", seed=seed).run(jsplit)
        got = api.DEM(30, init="separated", seed=seed,
                      device="cpu").run(split)
        jax_ll.append(float(exp.log_likelihood))
        port_ll.append(float(got.log_likelihood))
        k_init, _ = jax.random.split(jax.random.key(seed))
        centers = torch.as_tensor(np.array(jax_separated(k_init, 30, 24)))
        strat = DEMStrategy(k=30, init="separated")
        at_jax = run_rounds(strat, clients, device="cpu", max_rounds=200,
                            state0=strat.state_from_gmm(
                                init_from_means(centers, flat, flat_w)))
        assert at_jax.n_rounds == int(exp.n_rounds)
        assert abs(float(at_jax.log_likelihood) - jax_ll[-1]) <= 2e-4
    assert abs(np.mean(jax_ll) - np.mean(port_ll)) <= 0.5
    jax_fk = float(JaxDEM(30, init="fed-kmeans", seed=0).run(
        jsplit).log_likelihood)
    port_fk = float(api.DEM(30, init="fed-kmeans", seed=0,
                            device="cpu").run(split).log_likelihood)
    assert np.mean(jax_ll) <= jax_fk - 7
    assert np.mean(port_ll) <= port_fk - 7
