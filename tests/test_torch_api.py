"""The port's facades (``repro_torch.api``) against ``repro.api`` on the
same numpy inputs (CPU): scorers at rtol/atol 1e-4, a warm-started fit at
1e-4 in final avg log-likelihood, and config validation."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.core.gmm import GMM as JaxGMM
from repro_torch import api
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy

from conftest import planted_gmm_data

CPU = api.FitConfig(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x, _, mus = planted_gmm_data(rng, n=900, d=3, k=3, spread=5.0, std=0.5,
                                 min_sep_sigma=8.0)
    model = (np.full(3, 1 / 3, np.float32),
             (mus + rng.normal(0, 0.5, mus.shape)).astype(np.float32),
             np.full((3, 3), 0.5, np.float32))
    return x, model


@pytest.mark.parametrize("chunk", ["auto", 100])
def test_scorers_match(data, chunk):
    x, model = data
    jg = JaxGMM(*map(jnp.asarray, model))
    g = gmm_from_numpy(*model, device="cpu")
    cfg, jcfg = CPU.replace(chunk_size=chunk), japi.FitConfig(chunk_size=chunk)
    w = np.linspace(0, 1, len(x)).astype(np.float32)
    np.testing.assert_allclose(
        api.log_prob(g, x, cfg).numpy(),
        np.asarray(japi.log_prob(jg, jnp.asarray(x), jcfg)),
        rtol=1e-4, atol=1e-4)
    for name in ("score", "bic"):
        np.testing.assert_allclose(
            float(getattr(api, name)(g, x, w, cfg)),
            float(getattr(japi, name)(jg, jnp.asarray(x), jnp.asarray(w),
                                      jcfg)), rtol=1e-4, atol=1e-4)


def test_warm_started_estimator_matches(data):
    x, model = data
    got = api.GMMEstimator(3, config=CPU, tol=1e-5).fit(
        x, init_gmm=gmm_from_numpy(*model, device="cpu"))
    exp = japi.GMMEstimator(3, tol=1e-5).fit(
        jnp.asarray(x), init_gmm=JaxGMM(*map(jnp.asarray, model)))
    assert abs(float(got.result_.log_likelihood)
               - float(exp.result_.log_likelihood)) <= 1e-4
    np.testing.assert_allclose(gmm_to_numpy(got.gmm_)[1],
                               np.asarray(exp.gmm_.means), atol=1e-3)
    np.testing.assert_allclose(float(got.score(x)), float(exp.score(x)),
                               rtol=1e-4)


def test_config_validation():
    with pytest.raises(ValueError):
        api.FitConfig(backend="pallas")
    with pytest.raises(ValueError):
        api.FitConfig(chunk_size=0)
    with pytest.raises(ValueError):
        api.FitConfig(tol=-1.0)
    with pytest.raises(ValueError):
        api.FitConfig(max_iter=2.5)
    with pytest.raises(TypeError):
        api.GMMEstimator(3, nonsense=1)
    with pytest.raises(RuntimeError):
        api.GMMEstimator(3, device="cpu").score(np.zeros((2, 3)))


def test_every_public_name_is_a_name_of_repro_api():
    """The port's facades take no name that ``repro.api`` lacks."""
    assert set(api.__all__) <= set(japi.__all__)
    for name in api.__all__:
        assert hasattr(japi, name), name
    for name in ("DEM", "FedEM", "FedKMeans", "fit_federated",
                 "KMeansEstimator"):
        assert name in api.__all__
    for facade in (api.GMMEstimator(2), api.KMeansEstimator(2),
                   api.DEM(2), api.FedEM(2), api.FedKMeans(2),
                   api.FedGenGMM(k_candidates=(2, 3))):
        assert facade.config.device == "cuda"
