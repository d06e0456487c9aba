"""The port's one-shot FedGenGMM against ``repro.core.fedgen`` (CPU).

Deterministic stages are compared on injected state: the same split, the
same initial models, the same synthetic set S; final avg log-likelihoods
within 1e-4 (DESIGN.md §6). The whole pipeline draws from torch
generators, so it is held to the JAX package's result by a bound in
avg log-likelihood written in the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import FedGenGMM as JaxFedGen
from repro.core.config import FitConfig as JaxConfig
from repro.core.em import fit_gmm_cfg as jax_fit
from repro.core.gmm import GMM as JaxGMM
from repro.core.partition import ClientSplit as JaxSplit
from repro.core.partition import partition as jax_partition
from repro_torch.api import FedGenGMM
from repro_torch.convert import gmm_from_numpy, split_to_clients
from repro_torch.core.config import FitConfig
from repro_torch.core.em import fit_gmm_cfg
from repro_torch.core.metrics import average_log_likelihood
from repro_torch.core.partition import partition

from conftest import planted_gmm_data

K = 4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    x, y, mus = planted_gmm_data(rng, n=2400, d=4, k=K, spread=5.0, std=0.6,
                                 min_sep_sigma=8.0)
    split = partition(np.random.default_rng(0), x, y, 5, "dirichlet", 0.5)
    return x, y, mus, split


@pytest.mark.parametrize("scheme,alpha", [("dirichlet", 0.5),
                                          ("dirichlet", 100.0),
                                          ("quantity", 2)])
def test_partition_copy_gives_identical_splits(setup, scheme, alpha):
    x, y, _, _ = setup
    a = partition(np.random.default_rng(3), x, y, 6, scheme, alpha)
    b = jax_partition(np.random.default_rng(3), x, y, 6, scheme, alpha)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def _client_inits(split, mus, rng):
    c, d = split.data.shape[0], split.data.shape[2]
    w = np.full((c, K), 1 / K, np.float32)
    mu = (mus[None] + rng.normal(0, 0.7, (c, K, d))).astype(np.float32)
    var = np.ones((c, K, d), np.float32)
    return w, mu, var


def test_local_fits_from_injected_inits_match_jax(setup):
    """The batched local fits (all clients in one stacked run, padding
    masked) equal the JAX package's per-client fits."""
    _, _, mus, split = setup
    inits = _client_inits(split, mus, np.random.default_rng(1))
    cfg = dict(tol=1e-5, max_iter=80)
    clients = split_to_clients(split, "cpu")
    got = fit_gmm_cfg(0, clients.data, K, FitConfig(device="cpu", **cfg),
                      clients.mask, init_gmm=gmm_from_numpy(*inits, "cpu"))
    for c in range(split.data.shape[0]):
        exp = jax_fit(jax.random.key(c), jnp.asarray(split.data[c]), K,
                      JaxConfig(**cfg), jnp.asarray(split.mask[c]),
                      init_gmm=JaxGMM(*(jnp.asarray(a[c]) for a in inits)))
        assert abs(float(got.log_likelihood[c])
                   - float(exp.log_likelihood)) <= 1e-4
        np.testing.assert_allclose(got.gmm.means[c].numpy(),
                                   np.asarray(exp.gmm.means), atol=1e-3)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_refit_on_injected_synthetic_set_matches_jax(setup, backend):
    """Server refit on one S (drawn once by the JAX package) from one
    injected init."""
    _, _, mus, _ = setup
    rng = np.random.default_rng(2)
    merged = JaxGMM(jnp.full(K, 1 / K), jnp.asarray(mus),
                    jnp.full((K, 4), 0.36))
    s = np.array(merged.sample(jax.random.key(5), 2000))
    init = (np.full(K, 1 / K, np.float32),
            (mus + rng.normal(0, 0.7, mus.shape)).astype(np.float32),
            np.ones((K, 4), np.float32))
    exp = jax_fit(jax.random.key(0), jnp.asarray(s), K,
                  JaxConfig(tol=1e-5, max_iter=80),
                  init_gmm=JaxGMM(*map(jnp.asarray, init)))
    got = fit_gmm_cfg(0, s, K, FitConfig(backend=backend, tol=1e-5,
                                         max_iter=80, device="cpu"),
                      init_gmm=gmm_from_numpy(*init, "cpu"))
    assert abs(float(got.log_likelihood) - float(exp.log_likelihood)) <= 1e-4


def test_pipeline_tracks_jax_and_ledger_matches(setup):
    """End to end on a planted mixture 8 sigma apart: the port's global
    model scores within 0.1 nats/row of the JAX package's (the two draw
    different S and k-means seeds), and the communication ledger is
    identical."""
    x, _, _, split = setup
    got = FedGenGMM(k_clients=K, k_global=K, h=50, device="cpu").run(split)
    exp = JaxFedGen(k_clients=K, k_global=K, h=50,
                    synthetic="resident").run(JaxSplit(*split),
                                              key=jax.random.key(0))
    ll_port = average_log_likelihood(got.global_gmm, x)
    ll_jax = float(exp.global_gmm.score(jnp.asarray(x)))
    assert abs(ll_port - ll_jax) <= 0.1, (ll_port, ll_jax)
    assert got.synthetic.shape == exp.synthetic.shape
    assert (got.comm.rounds, got.comm.uplink_floats, got.comm.downlink_floats,
            got.comm.itemsize) == (exp.comm.rounds, exp.comm.uplink_floats,
                                   exp.comm.downlink_floats,
                                   exp.comm.itemsize)
    assert got.comm.payload_bytes == exp.comm.payload_bytes
    assert len(got.local_gmms) == len(exp.local_gmms)
