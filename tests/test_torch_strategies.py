"""The port's FedEM and FedKMeans strategies, cohort samplers and straggler
policy (``repro_torch.fed``) against ``repro.fed`` on the CPU.

Deterministic stages run from injected state in both packages: FedEM from
one initial model (avg log-likelihood within 1e-4, parameters within 2e-4),
FedKMeans from one set of centers (centers within 2e-4), with the same
round counts and ledgers. The cyclic cohorts equal the JAX package's. The
uniform sampler and the straggler policy draw from the port's generators,
so they are held to their properties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gmm import GMM as JaxGMM
from repro.core.partition import ClientSplit as JaxSplit
from repro.fed import CyclicSampler as JaxCyclic
from repro.fed.runtime import run_rounds as jax_run_rounds
from repro.fed.strategies import FedEMStrategy as JaxFedEMStrategy
from repro.fed.strategies import FedKMeansState as JaxFedKMeansState
from repro.fed.strategies import FedKMeansStrategy as JaxFedKMeansStrategy
from repro_torch import api
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core.fedgen import FedGenStrategy
from repro_torch.core.kmeans import lloyd_round_stats
from repro_torch.core.partition import partition
from repro_torch.fed import (ArrivalStragglers, CyclicSampler,
                             UniformSampler, make_sampler, run_rounds,
                             stats_payload_floats)
from repro_torch.fed.strategies import (FedEMStrategy, FedKMeansState,
                                        FedKMeansStrategy)

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


def _moved(mus, scale=1.0, seed=1):
    return (mus + np.random.default_rng(seed).normal(0, scale, mus.shape)
            ).astype(np.float32)


def _gmm0(split, mus):
    w = np.full(K, 1 / K, np.float32)
    var = np.tile(split.data[split.mask > 0].var(0), (K, 1))
    return w, _moved(mus), var.astype(np.float32)


def assert_same_gmm(g1, g2):
    for a, b in zip(gmm_to_numpy(g1), gmm_to_numpy(g2)):
        np.testing.assert_array_equal(a, b)


def assert_same_comm(got, exp):
    assert (got.rounds, got.uplink_floats, got.downlink_floats,
            got.itemsize) == (exp.rounds, exp.uplink_floats,
                              exp.downlink_floats, exp.itemsize)


# ----------------------------------------------------------------------
# FedEM
# ----------------------------------------------------------------------

def test_default_knobs_reduce_to_dem_bitwise(setup):
    _, _, split = setup
    dem = api.DEM(K, init="separated", config=CPU).run(split, seed=4)
    fedem = api.FedEM(K, init="separated", config=CPU).run(split, seed=4)
    assert_same_gmm(dem.global_gmm, fedem.global_gmm)
    assert dem.n_rounds == fedem.n_rounds
    assert torch.equal(dem.log_likelihood, fedem.log_likelihood)
    assert dem.comm == fedem.comm


def test_cyclic_fedem_from_injected_init_matches_jax(setup):
    """Participation 0.5 (cohorts of 3 of 6, period 2) with 2 local
    epochs."""
    _, mus, split = setup
    g0 = _gmm0(split, mus)
    kw = dict(k=K, init="separated", tol=1e-4, participation=0.5,
              local_epochs=2, n_clients=C)
    jstrat = JaxFedEMStrategy(**kw)
    exp = jax_run_rounds(jstrat, JaxSplit(*split), key=jax.random.key(0),
                         state0=jstrat.state_from_gmm(
                             JaxGMM(*map(jnp.asarray, g0)),
                             dtype=jnp.float32),
                         max_rounds=60, sampler=JaxCyclic(C, 3))
    strat = FedEMStrategy(**kw)
    got = run_rounds(strat, split, device="cpu", max_rounds=60,
                     state0=strat.state_from_gmm(gmm_from_numpy(*g0, "cpu")),
                     sampler=CyclicSampler(C, 3))
    assert got.n_rounds == int(exp.n_rounds) > 2
    assert got.converged == bool(exp.converged)
    assert abs(float(got.log_likelihood)
               - float(exp.log_likelihood)) <= 1e-4
    for a, b in zip(gmm_to_numpy(got.global_gmm),
                    (exp.global_gmm.weights, exp.global_gmm.means,
                     exp.global_gmm.covs)):
        np.testing.assert_allclose(a, np.array(b), rtol=2e-4, atol=2e-4)
    assert_same_comm(got.comm, exp.comm)


def test_cohort_round_adds_like_the_zero_masked_population(setup):
    """A cohort round scatters its members' payloads into population slots
    before the sum over C, so it gives the same bits as computing every
    client and zeroing the non-members."""
    _, mus, split = setup
    strat = FedEMStrategy(k=K, init="separated", participation=0.5,
                          n_clients=C)
    state = strat.state_from_gmm(gmm_from_numpy(*_gmm0(split, mus), "cpu"))
    from repro_torch.convert import split_to_clients
    backend = split_to_clients(split, "cpu")
    cohort = CyclicSampler(C, 3).cohort(1)
    got = backend.reduce_clients(strat.local_step, state, cohort)
    zero = np.zeros(C, np.float32)
    zero[cohort] = 1.0
    exp = backend.reduce_clients(strat.local_step, state, None, zero)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c,m", [(6, 3), (7, 3), (5, 5), (20, 10)])
def test_cyclic_cohorts_equal_jax(c, m):
    key = jax.random.key(0)
    for rnd in range(2 * c):
        np.testing.assert_array_equal(
            CyclicSampler(c, m).cohort(rnd),
            np.asarray(JaxCyclic(c, m).cohort(key, rnd)))


def test_partial_participation_ledger_is_cohort_sized(setup):
    _, _, split = setup
    fr = api.FedEM(K, participation=0.5, local_epochs=2, init="separated",
                   max_iter=12, config=CPU).run(split, seed=6)
    m = 3
    assert fr.comm.uplink_floats == fr.comm.rounds * m * \
        stats_payload_floats(K, D, True)
    gmm_floats = K + 2 * K * D
    assert fr.comm.downlink_floats == \
        fr.comm.rounds * m * gmm_floats + C * gmm_floats
    assert fr.comm.rounds == fr.n_rounds
    assert bool(torch.isfinite(fr.global_gmm.means).all())


def test_local_epochs_still_fit_well(setup):
    """Local epochs change the trajectory, not the destination."""
    x, _, split = setup
    fr = api.FedEM(K, local_epochs=3, init="separated", max_iter=60,
                   config=CPU).run(split, seed=8)
    dr = api.DEM(K, init="separated", max_iter=60,
                 config=CPU).run(split, seed=8)
    assert float(api.score(fr.global_gmm, x, config=CPU)) > \
        float(api.score(dr.global_gmm, x, config=CPU)) - 0.3


def test_uniform_cohort_fedem_fits(setup):
    x, _, split = setup
    fr = api.FedEM(K, participation=0.5, cohort="uniform", cohort_seed=5,
                   init="separated", max_iter=40,
                   config=CPU).run(split, seed=6)
    assert float(api.score(fr.global_gmm, x, config=CPU)) > -8.0
    assert fr.comm.uplink_floats == \
        fr.comm.rounds * 3 * stats_payload_floats(K, D, True)


def test_fedem_validation():
    with pytest.raises(ValueError, match="n_clients"):
        FedEMStrategy(k=3, participation=0.5)
    with pytest.raises(ValueError, match="local_epochs"):
        FedEMStrategy(k=3, local_epochs=0)
    with pytest.raises(ValueError, match="participation"):
        api.FedEM(3, participation=2.0, device="cpu")
    with pytest.raises(ValueError, match="cohort"):
        api.FedEM(3, cohort="random", device="cpu")


# ----------------------------------------------------------------------
# FedKMeans
# ----------------------------------------------------------------------

def test_fedkmeans_from_injected_centers_matches_jax(setup):
    _, mus, split = setup
    c0 = _moved(mus, 2.0, seed=3)
    jstrat = JaxFedKMeansStrategy(k=K, init="separated")
    inf = jnp.array(jnp.inf, jnp.float32)
    exp = jax_run_rounds(jstrat, JaxSplit(*split), key=jax.random.key(0),
                         state0=JaxFedKMeansState(jnp.asarray(c0), inf, inf,
                                                  jnp.float32(1e-4)),
                         max_rounds=100)
    strat = FedKMeansStrategy(k=K, init="separated")
    t_inf = torch.tensor(float("inf"))
    got = run_rounds(strat, split, device="cpu", max_rounds=100,
                     state0=FedKMeansState(torch.as_tensor(c0), t_inf,
                                           t_inf, 1e-4))
    assert got.n_rounds == int(exp.n_rounds) > 1
    assert got.converged == bool(exp.converged)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(exp.centers),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(got.inertia), float(exp.inertia),
                               rtol=2e-4)
    assert_same_comm(got.comm, exp.comm)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_fedkmeans_rescores_the_returned_centers(setup, backend):
    _, _, split = setup
    res = api.FedKMeans(K, backend=backend, config=CPU).run(split, seed=3)
    per = lloyd_round_stats(res.centers, torch.as_tensor(split.data),
                            torch.as_tensor(split.mask), backend)[2]
    assert torch.equal(res.inertia, per.sum(0))
    assert res.comm.uplink_floats == res.comm.rounds * C * (K + K * D + 1) \
        + C + C * (K * D + K)


def test_fedkmeans_finds_the_planted_centers(setup):
    _, mus, split = setup
    for init in ("fed-kmeans", "separated"):
        res = api.FedKMeans(K, init=init, config=CPU).run(split, seed=0)
        assert res.converged
        np.testing.assert_allclose(np.sort(res.centers.numpy(), axis=0),
                                   np.sort(mus, axis=0), atol=0.3)
    with pytest.raises(ValueError, match="FedKMeans init"):
        api.FedKMeans(K, init="pilot", device="cpu")


def test_nan_shift_halts_fedkmeans():
    s = FedKMeansStrategy(k=2)
    state = FedKMeansState(centers=None, shift=float("nan"), inertia=0.0,
                           tol=1e-4)
    assert not s.keep_going(state)
    assert not s.converged(state)


# ----------------------------------------------------------------------
# Samplers and stragglers
# ----------------------------------------------------------------------

def test_uniform_sampler_properties():
    s = UniformSampler(num_clients=50, cohort_size=8, seed=3)
    cohorts = [s.cohort(rnd) for rnd in range(6)]
    for c in cohorts:
        assert c.shape == (8,) and len(set(c.tolist())) == 8
        assert (np.sort(c) == c).all() and c.min() >= 0 and c.max() < 50
    for a, b in zip(cohorts, [s.cohort(rnd) for rnd in range(6)]):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(cohorts[:-1], cohorts[1:]))
    other = UniformSampler(50, 8, seed=4)
    assert any((a != other.cohort(r)).any() for r, a in enumerate(cohorts))


def test_cyclic_covers_every_client_within_a_cycle():
    s = CyclicSampler(7, 3)
    seen = set()
    for rnd in range(7):
        seen |= set(s.cohort(rnd).tolist())
    assert seen == set(range(7))


def test_sampler_validation(setup):
    _, _, split = setup
    with pytest.raises(ValueError):
        CyclicSampler(4, 0)
    with pytest.raises(ValueError):
        UniformSampler(4, 5)
    with pytest.raises(ValueError):
        make_sampler("random", 4, 2)
    with pytest.raises(ValueError, match="sized"):
        run_rounds(FedEMStrategy(k=2), split, device="cpu",
                   sampler=CyclicSampler(C + 1, 2))


def test_stragglers_keep_exactly_n_keep_and_at_least_one():
    pol = ArrivalStragglers(drop_frac=0.3, seed=0)
    cohort = np.arange(10)
    for rnd in range(5):
        mask = pol.drop_mask(rnd, cohort)
        assert mask.shape == (10,) and set(mask.tolist()) <= {0.0, 1.0}
        assert mask.sum() == pol.n_keep(10) == 7
    assert ArrivalStragglers(0.99).drop_mask(0, np.arange(3)).sum() == 1
    with pytest.raises(ValueError):
        ArrivalStragglers(1.0)


def test_stragglers_are_deterministic_and_keyed_by_client_id():
    pol = ArrivalStragglers(drop_frac=0.5, seed=2)
    np.testing.assert_array_equal(pol.drop_mask(4, [3, 7, 11, 20]),
                                  pol.drop_mask(4, [3, 7, 11, 20]))
    # a client's arrival does not depend on the cohort it lands in: the
    # survivors of a cohort are the survivors of its sub-cohort pairs
    full = pol.drop_mask(4, [3, 7, 11, 20])
    for pair in ([3, 7], [11, 20], [3, 20]):
        sub = pol.drop_mask(4, pair)
        order = {3: 0, 7: 1, 11: 2, 20: 3}
        if full[order[pair[0]]] != full[order[pair[1]]]:
            assert (sub == full[[order[p] for p in pair]]).all()


def test_zero_drop_frac_is_a_bitwise_noop(setup):
    _, _, split = setup
    base = api.FedEM(K, participation=0.5, init="separated", max_iter=20,
                     config=CPU).run(split, seed=6)
    wired = api.FedEM(K, participation=0.5, init="separated", max_iter=20,
                      stragglers=ArrivalStragglers(0.0),
                      config=CPU).run(split, seed=6)
    assert_same_gmm(base.global_gmm, wired.global_gmm)
    assert base.n_rounds == wired.n_rounds


def test_fedem_survives_drops(setup):
    x, _, split = setup
    fr = api.FedEM(K, stragglers=ArrivalStragglers(0.34, seed=1),
                   config=CPU).run(split, seed=0)
    assert bool(torch.isfinite(fr.global_gmm.means).all())
    assert float(api.score(fr.global_gmm, x, config=CPU)) > -6.0


def test_one_shot_strategies_reject_sampler_and_stragglers(setup):
    _, _, split = setup
    strat = FedGenStrategy(config=CPU, k_clients=2, k_global=2, h=10)
    with pytest.raises(ValueError, match="one-shot"):
        run_rounds(strat, split, device="cpu", sampler=CyclicSampler(C, 2))
    with pytest.raises(ValueError, match="one-shot"):
        run_rounds(strat, split, device="cpu",
                   stragglers=ArrivalStragglers(0.5))


# ----------------------------------------------------------------------
# fit_federated
# ----------------------------------------------------------------------

def test_fit_federated_by_name_equals_the_facades(setup):
    _, _, split = setup
    for name, facade, kw in (
            ("dem", api.DEM, dict(k=K)),
            ("fedem", api.FedEM, dict(k=K, participation=0.5)),
            ("fedkmeans", api.FedKMeans, dict(k=K)),
            ("fedgen", api.FedGenGMM, dict(k_clients=K, k_global=K, h=10))):
        r1 = api.fit_federated(split, strategy=name, config=CPU, seed=2,
                               **kw)
        r2 = facade(config=CPU, **kw).run(split, seed=2)
        if name == "fedkmeans":
            assert torch.equal(r1.centers, r2.centers)
        else:
            assert_same_gmm(r1.global_gmm, r2.global_gmm)
        assert r1.comm == r2.comm


def test_directly_built_fedkmeans_strategy_equals_the_facade(setup):
    """A ``FedKMeansStrategy`` built with its defaults resolves its
    assignment backend with the clients' device, as the facade does."""
    _, _, split = setup
    strat = FedKMeansStrategy(k=K)
    assert strat.assign_backend == "auto"
    r1 = api.fit_federated(split, strategy=strat, config=CPU, seed=2,
                           max_rounds=100)
    r2 = api.FedKMeans(K, config=CPU).run(split, seed=2)
    assert torch.equal(r1.centers, r2.centers)
    assert torch.equal(r1.inertia, r2.inertia)
    assert r1.comm == r2.comm


def test_fit_federated_custom_strategy_and_validation(setup):
    _, _, split = setup
    from repro_torch.core.dem import DEMStrategy
    strat = DEMStrategy(k=2, init="separated")
    res = api.fit_federated(split, strategy=strat, config=CPU,
                            max_rounds=10, sampler=CyclicSampler(C, 3))
    assert 1 <= res.n_rounds <= 10
    with pytest.raises(ValueError, match="unknown strategy"):
        api.fit_federated(split, strategy="fedprox", config=CPU)
    with pytest.raises(TypeError):
        api.fit_federated(split, strategy=object(), config=CPU)
    with pytest.raises(TypeError, match="max_rounds"):
        api.fit_federated(split, strategy="dem", k=2, max_rounds=3,
                          config=CPU)
