"""The port's split-merge EM (``repro_torch.core.splitmerge``) on the CPU,
mirroring ``tests/test_splitmerge.py`` at its bounds, and its two moves held
to the JAX package's on the same numpy GMM: the same slots chosen, the
parameters within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gmm import GMM as JaxGMM
from repro.core.splitmerge import _merge_weakest as jax_merge_weakest
from repro.core.splitmerge import _split_strongest as jax_split_strongest
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core.em import fit_gmm
from repro_torch.core.fedgen import aggregate
from repro_torch.core.partition import partition
from repro_torch.core.splitmerge import (_merge_weakest, _split_strongest,
                                         split_merge_fit)

from conftest import planted_gmm_data


def score(gmm, x):
    return float(gmm.score(torch.as_tensor(x)))


def test_split_merge_never_worse():
    x, _, _ = planted_gmm_data(np.random.default_rng(3), n=2000, k=4,
                               spread=5.0, std=0.5)
    base = fit_gmm(0, x, 4, device="cpu")
    sm = split_merge_fit(0, x, 4, device="cpu")
    assert float(sm.log_likelihood) >= float(base.log_likelihood) - 1e-5


def test_split_merge_escapes_bad_init():
    """Overlapping clusters and one tiny far one: split-merge matches or
    beats standard EM across seeds on average."""
    rng = np.random.default_rng(11)
    a = rng.normal([0, 0], 0.4, (900, 2))
    b = rng.normal([1.2, 0], 0.4, (900, 2))
    c = rng.normal([8, 8], 0.3, (60, 2))
    x = np.concatenate([a, b, c]).astype(np.float32)
    base_ll, sm_ll = [], []
    for s in range(4):
        base_ll.append(float(fit_gmm(s, x, 3, device="cpu").log_likelihood))
        sm_ll.append(float(split_merge_fit(s, x, 3,
                                           device="cpu").log_likelihood))
    assert np.mean(sm_ll) >= np.mean(base_ll) - 1e-6


def test_drop_in_for_federated_local_training():
    """Split-merge locals feed the unchanged aggregation path."""
    x, y, _ = planted_gmm_data(np.random.default_rng(5), n=1600, k=3)
    split = partition(np.random.default_rng(0), x, y, 4, "dirichlet", 0.5)
    gmms, sizes = [], []
    for c in range(4):
        n = int(split.sizes[c])
        gmms.append(split_merge_fit(c, split.data[c][:n], 3,
                                    device="cpu").gmm)
        sizes.append(n)
    res, _ = aggregate(9, gmms, sizes, h=50, k_global=3, device="cpu")
    bench = fit_gmm(10, x, 3, device="cpu")
    assert score(res.gmm, x) > score(bench.gmm, x) - 0.4


@pytest.mark.parametrize("seed", range(4))
def test_moves_match_jax(seed):
    """A random diagonal GMM (K = 6, d = 5) through both packages' merge,
    then split on the merged model at the merge's slot."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(6)).astype(np.float32)
    mu = rng.normal(0, 3, (6, 5)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, (6, 5)).astype(np.float32)
    jm, jslot = jax_merge_weakest(JaxGMM(*map(jnp.asarray, (w, mu, var))))
    pm, pslot = _merge_weakest(gmm_from_numpy(w, mu, var, "cpu"))
    assert int(pslot) == int(jslot)
    for a, b in zip(gmm_to_numpy(pm), (jm.weights, jm.means, jm.covs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    js = jax_split_strongest(jm, jslot)
    ps = _split_strongest(pm, pslot)
    for a, b in zip(gmm_to_numpy(ps), (js.weights, js.means, js.covs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    # the split leaves a valid mixture: the halves' weights sum back to one
    assert abs(float(ps.weights.sum()) - 1.0) <= 1e-6
