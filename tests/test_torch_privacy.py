"""The port's DP release (``repro_torch.core.privacy``) on the CPU, mirroring
the JAX package's ``tests/test_privacy.py``: a released model is a valid
GMM, its noise shrinks as epsilon grows, and a FedGenGMM pipeline on
released client models still learns. The port's draws are torch's, so its
noise is held to the JAX package's statistically: the mean absolute error
of the released means over 20 seeds, within a factor 1.3 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gmm import GMM as JaxGMM
from repro.core.privacy import DPConfig as JaxDPConfig
from repro.core.privacy import gaussian_sigma as jax_sigma
from repro.core.privacy import privatize_gmm as jax_privatize_gmm
from repro_torch.api import FedGenGMM, FitConfig, GMMEstimator, score
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core.config import derive_seed
from repro_torch.core.fedgen import aggregate_cfg
from repro_torch.core.partition import partition
from repro_torch.core.privacy import (DPConfig, gaussian_sigma,
                                      privatize_clients, privatize_gmm)
from repro_torch.fed.transforms import GaussianDP

from conftest import planted_gmm_data

CPU = FitConfig(device="cpu")


@pytest.fixture(scope="module")
def planted_norm():
    """Planted mixture normalized to [0,1] (DP sensitivity assumption)."""
    rng = np.random.default_rng(5)
    x, y, _ = planted_gmm_data(rng, n=3000, d=4, k=3, spread=4.0, std=0.4)
    lo, hi = x.min(0), x.max(0)
    return ((x - lo) / (hi - lo)).astype(np.float32), y


@pytest.fixture(scope="module")
def fitted(planted_norm):
    x, _ = planted_norm
    return GMMEstimator(3, config=CPU).fit(x, seed=0).gmm_


def test_privatized_gmm_valid(planted_norm, fitted):
    x, _ = planted_norm
    priv = privatize_gmm(1, fitted, len(x), DPConfig(epsilon=1.0))
    np.testing.assert_allclose(float(priv.weights.sum()), 1.0, rtol=1e-5)
    assert bool((priv.covs > 0).all())
    assert bool(((priv.means >= 0) & (priv.means <= 1)).all())
    assert priv.device == fitted.device


def test_noise_decreases_with_epsilon(planted_norm, fitted):
    x, _ = planted_norm

    def dist(eps, seed):
        priv = privatize_gmm(seed, fitted, len(x), DPConfig(epsilon=eps))
        return float(torch.mean(torch.abs(priv.means - fitted.means)))

    loose = np.mean([dist(10.0, s) for s in range(5)])
    tight = np.mean([dist(0.05, s) for s in range(5)])
    assert tight > loose


def test_dp_pipeline_still_learns(planted_norm):
    """End to end: a DP uplink at moderate epsilon still yields a usable
    global model (it degrades gracefully against the non-private one)."""
    x, y = planted_norm
    split = partition(np.random.default_rng(0), x, y, 5, "dirichlet", 1.0)
    fr = FedGenGMM(k_clients=3, k_global=3, h=60, config=CPU).run(split,
                                                                  seed=0)
    priv = privatize_clients(1, fr.local_gmms, split.sizes,
                             DPConfig(epsilon=5.0))
    res, _ = aggregate_cfg(2, priv, split.sizes, CPU, k_global=3, h=60)
    xt = torch.as_tensor(x)
    ll_priv = float(score(res.gmm, xt, config=CPU))
    ll_nonpriv = float(score(fr.global_gmm, xt, config=CPU))
    ll_central = float(GMMEstimator(3, config=CPU).fit(x, seed=3).score(xt))
    assert ll_priv > ll_central - 2.0, (ll_priv, ll_nonpriv, ll_central)
    assert ll_priv <= ll_nonpriv + 0.2  # noise should not help


def test_privatize_clients_seeds_each_client():
    """Client i is released from ``derive_seed(seed, i)``, alone."""
    g = gmm_from_numpy(np.array([0.3, 0.7], np.float32),
                       np.array([[0.2, 0.4], [0.6, 0.9]], np.float32),
                       np.array([[0.01, 0.02], [0.03, 0.04]], np.float32),
                       "cpu")
    dp = DPConfig(epsilon=2.0)
    rel = privatize_clients(7, [g, g, g], [100.0, 50.0, 100.0], dp)
    for i, n in enumerate([100.0, 50.0, 100.0]):
        want = privatize_gmm(derive_seed(7, i), g, n, dp)
        for a, b in zip(gmm_to_numpy(rel[i]), gmm_to_numpy(want)):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(rel[0].means.numpy(), rel[2].means.numpy())


def test_dpconfig_transform_is_one_shot():
    t = DPConfig(epsilon=3.0, delta=1e-6, min_count=4.0).transform(seed=5)
    assert isinstance(t, GaussianDP)
    assert (t.epsilon, t.delta, t.rounds, t.min_count, t.seed) == \
        (3.0, 1e-6, 1, 4.0, 5)
    assert t.epsilon_per_round() == 3.0


def test_fedgen_dp_equals_its_transform(planted_norm):
    x, y = planted_norm
    split = partition(np.random.default_rng(1), x, y, 4, "dirichlet", 1.0)
    dp = DPConfig(epsilon=2.0)
    a = FedGenGMM(k_clients=3, k_global=3, h=20, dp=dp, config=CPU).run(
        split, seed=0)
    b = FedGenGMM(k_clients=3, k_global=3, h=20, transform=dp.transform(),
                  config=CPU).run(split, seed=0)
    for u, v in zip(gmm_to_numpy(a.global_gmm), gmm_to_numpy(b.global_gmm)):
        np.testing.assert_array_equal(u, v)
    assert a.comm == b.comm and a.comm.epsilon_spent == 2.0


@pytest.mark.parametrize("sens,eps,delta", [(1.0, 1.0, 1e-5),
                                            (2.0, 0.25, 1e-6),
                                            (0.5, 4.0, 0.1)])
def test_sigma_equals_jax(sens, eps, delta):
    assert gaussian_sigma(sens, eps, delta) == jax_sigma(sens, eps, delta)


@pytest.mark.parametrize("eps", [0.5, 2.0])
def test_noise_scale_matches_jax(fitted, eps):
    """Both packages' releases of one model, 20 seeds each: the mean
    absolute error of the released means agrees within a factor 1.3."""
    w, mu, var = gmm_to_numpy(fitted)
    jg = JaxGMM(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var))

    def err_port(s):
        rel = privatize_gmm(s, fitted, 400.0, DPConfig(epsilon=eps))
        return float(torch.mean(torch.abs(rel.means - fitted.means)))

    def err_jax(s):
        rel = jax_privatize_gmm(jax.random.key(s), jg, 400.0,
                                JaxDPConfig(epsilon=eps))
        return float(jnp.mean(jnp.abs(rel.means - jg.means)))

    port = np.mean([err_port(s) for s in range(20)])
    ref = np.mean([err_jax(s) for s in range(20)])
    assert 1 / 1.3 < port / ref < 1.3, (port, ref)
