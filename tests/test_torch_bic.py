"""BIC model selection in the port (``fit_gmm_bic_cfg``,
``train_locals_bic_cfg``, ``GMMEstimator`` / ``FedGenGMM`` with
``k_candidates``) and ``KMeansEstimator``, against ``repro`` on the CPU.

The candidate fits start from k-means++ seeds drawn by each package's own
generator, so the packages are compared where the answer does not depend on
the seed: a planted mixture whose components lie 8 sigma apart. There both
select the true K, and their BICs agree within the relative bound written
in each test. The port's batched per-client selection is held to a
per-client loop in the port itself: same K_c, BICs within 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.em import fit_gmm_bic_cfg as jax_fit_bic
from repro.core.kmeans import federated_kmeans as jax_federated_kmeans
from repro_torch import api
from repro_torch.core.config import derive_seed
from repro_torch.core.em import fit_gmm_bic_cfg
from repro_torch.core.fedgen import train_locals_bic_cfg
from repro_torch.core.kmeans import federated_kmeans
from repro_torch.core.partition import partition
from repro_torch.fed.ledger import gmm_payload_floats

from conftest import planted_gmm_data

CPU = api.FitConfig(device="cpu")
CANDIDATES = (1, 2, 3, 4, 5)


@pytest.fixture(scope="module")
def planted():
    return planted_gmm_data(np.random.default_rng(7), n=3000, d=4, k=3,
                            spread=6.0, std=0.4, min_sep_sigma=8.0)


def test_bic_selects_the_true_k_in_both_packages(planted):
    """Per-candidate BICs within 1e-3 relative up to the true K (a unique
    optimum); beyond it, extra components split clusters differently per
    seed, and BIC is held within 1e-2 relative."""
    x, _, _ = planted
    res, bics = fit_gmm_bic_cfg(0, x, CANDIDATES, CPU)
    jres, jbics = jax_fit_bic(jax.random.key(0), jnp.asarray(x), CANDIDATES,
                              japi.FitConfig())
    assert res.gmm.n_components == jres.gmm.n_components == 3, (bics, jbics)
    assert list(bics) == list(jbics) == list(CANDIDATES)
    for k in CANDIDATES:
        rtol = 1e-3 if k <= 3 else 1e-2
        assert abs(bics[k] - jbics[k]) <= rtol * abs(jbics[k]), (k, bics,
                                                                 jbics)
    assert bics[3] == min(bics.values())


def test_estimator_with_candidates(planted):
    x, _, _ = planted
    est = api.GMMEstimator(k_candidates=(2, 3, 4), config=CPU).fit(x)
    jest = japi.GMMEstimator(k_candidates=(2, 3, 4)).fit(jnp.asarray(x))
    assert est.gmm_.n_components == jest.gmm_.n_components == 3
    assert set(est.bics_) == {2, 3, 4}
    assert abs(est.bics_[3] - jest.bics_[3]) <= 1e-3 * abs(jest.bics_[3])
    assert float(est.bic(x)) == pytest.approx(est.bics_[3], rel=1e-6)
    with pytest.raises(ValueError, match="exactly one"):
        api.GMMEstimator(3, k_candidates=(2, 3), device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        est.fit(x, init_gmm=est.gmm_)


@pytest.fixture(scope="module")
def hetero():
    """Three planted components; Dirichlet(0.3) over 5 clients, so some
    clients hold fewer components than others."""
    x, y, mus = planted_gmm_data(np.random.default_rng(4), n=1500, d=3,
                                 k=3, spread=6.0, std=0.4, min_sep_sigma=8.0)
    return x, partition(np.random.default_rng(1), x, y, 5, "dirichlet", 0.3)


def test_batched_selection_equals_a_per_client_loop(hetero):
    """All clients of a candidate as one batch against a loop of single
    fits, each client's padded rows masked as in the batch: the same K_c,
    BICs within 1e-5 relative. Fitted on its real rows alone, each client
    selects the same K_c too."""
    _, split = hetero
    cands = (1, 2, 3, 4)
    data = torch.as_tensor(split.data)
    mask = torch.as_tensor(split.mask)
    best, bics = train_locals_bic_cfg(5, data, mask, cands, CPU)
    for c in range(split.data.shape[0]):
        res, loop = fit_gmm_bic_cfg(derive_seed(5, c), data[c], cands, CPU,
                                    sample_weight=mask[c])
        assert best[c].gmm.n_components == res.gmm.n_components
        for k in cands:
            assert abs(bics[c][k] - loop[k]) <= 1e-5 * abs(loop[k]), (
                c, k, bics[c], loop)
        n = int(split.sizes[c])
        alone, _ = fit_gmm_bic_cfg(derive_seed(5, c), split.data[c, :n],
                                   cands, CPU)
        assert alone.gmm.n_components == res.gmm.n_components
    assert len({g.gmm.n_components for g in best}) > 1, bics


def test_fedgen_with_candidates_merges_ragged_locals(hetero):
    x, split = hetero
    fed = api.FedGenGMM(k_candidates=(1, 2, 3), k_global=3, h=20,
                        config=CPU).run(split)
    ks = [g.n_components for g in fed.local_gmms]
    assert set(ks) <= {1, 2, 3} and len(set(ks)) > 1, ks
    d = x.shape[1]
    assert fed.comm.rounds == 1
    assert fed.comm.uplink_floats == sum(gmm_payload_floats(k, d, True) + 1
                                         for k in ks)
    assert fed.synthetic.shape == (20 * sum(ks), d)
    assert fed.global_gmm.n_components == 3
    central = api.GMMEstimator(3, config=CPU).fit(x)
    assert float(api.score(fed.global_gmm, x, config=CPU)) > \
        float(central.score(x)) - 0.3
    server = api.FedGenGMM(k_candidates=(2, 3, 4), h=20,
                           config=CPU).run(split)
    assert server.global_gmm.n_components == 3


def test_facade_validation():
    with pytest.raises(ValueError, match="k_clients"):
        api.FedGenGMM(k_global=3, device="cpu")
    with pytest.raises(ValueError, match="k_global"):
        api.FedGenGMM(k_clients=3, device="cpu")
    with pytest.raises(ValueError, match="synthetic"):
        api.FedGenGMM(k_clients=3, k_global=3, synthetic="disk",
                      device="cpu")
    assert api.FedGenGMM(k_clients=3, k_global=3, synthetic="source",
                         device="cpu").synthetic == "source"
    with pytest.raises(ValueError, match="k-means"):
        api.FedGenGMM(k_clients=3, k_global=3, init="pilot", device="cpu")


# ----------------------------------------------------------------------
# k-means
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_init", [1, 3])
def test_kmeans_estimator_matches_jax(planted, n_init):
    x, _, mus = planted
    est = api.KMeansEstimator(3, n_init=n_init, config=CPU).fit(x)
    jest = japi.KMeansEstimator(3, n_init=n_init).fit(jnp.asarray(x))
    np.testing.assert_allclose(np.sort(est.centers_.numpy(), axis=0),
                               np.sort(np.asarray(jest.centers_), axis=0),
                               atol=1e-4)
    np.testing.assert_allclose(float(est.inertia_), float(jest.inertia_),
                               rtol=1e-4)
    assert est.assignments_.shape == (len(x),)
    with pytest.raises(RuntimeError):
        api.KMeansEstimator(3, device="cpu").centers_


def test_federated_kmeans_close_to_centralized():
    x, y, mus = planted_gmm_data(np.random.default_rng(5), n=2000, k=3,
                                 spread=7.0, std=0.4, min_sep_sigma=8.0)
    split = partition(np.random.default_rng(0), x, y, 4, "dirichlet", 0.3)
    got = federated_kmeans(0, torch.as_tensor(split.data), 3,
                           client_weights=torch.as_tensor(split.mask))
    exp = jax_federated_kmeans(jax.random.key(0), jnp.asarray(split.data), 3,
                               client_weights=jnp.asarray(split.mask))
    np.testing.assert_allclose(np.sort(got.numpy(), axis=0),
                               np.sort(mus, axis=0), atol=0.4)
    np.testing.assert_allclose(np.sort(got.numpy(), axis=0),
                               np.sort(np.asarray(exp), axis=0), atol=1e-3)
