"""The port's continual one-shot FL (``repro_torch.core.continual``) on the
CPU, mirroring ``tests/test_continual.py`` at its bounds, plus one check
against the JAX package: on the same windows, both packages' continual
models score the same held-out rows within 0.2 nats a row. The two draw
from different generators (threefry and Philox: the k-means seeding and
the synthetic set differ), so the bound is on quality, not bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.continual import continual_round as jax_continual_round
from repro.core.continual import init_state as jax_init_state
from repro_torch.core.continual import continual_round, init_state
from repro_torch.core.em import fit_gmm
from repro_torch.core.partition import partition


def make_window(rng, mus, active, n=900):
    """Data drawn only from the ``active`` subset of components."""
    y = rng.choice(active, size=n)
    x = (mus[y] + rng.normal(0, 0.5, (n, mus.shape[1]))).astype(np.float32)
    return x, y.astype(np.int64)


@pytest.fixture(scope="module")
def drift_setup():
    rng = np.random.default_rng(0)
    mus = rng.normal(0, 6, (4, 4)).astype(np.float32)
    return rng, mus


def windows(rng, mus, actives):
    """Each window's 4-client Dirichlet(1.0) split."""
    out = []
    for i, active in enumerate(actives):
        x, y = make_window(rng, mus, active)
        out.append(partition(np.random.default_rng(i), x, y, 4, "dirichlet",
                             1.0))
    return out


def run_windows(rng, mus, actives, memory, k_clients=3, h=50):
    state = init_state()
    for i, split in enumerate(windows(rng, mus, actives)):
        state = continual_round(i, state, split.data, split.mask,
                                split.sizes, k_clients=k_clients, k_global=4,
                                h=h, memory=memory, device="cpu")
    return state


def score(gmm, x):
    return float(gmm.score(torch.as_tensor(x)))


def test_one_round_per_window(drift_setup):
    rng, mus = drift_setup
    state = run_windows(rng, mus, [[0, 1], [2, 3]], memory=0.5)
    assert state.rounds_total == 2 and state.window == 2


def test_memory_retains_old_modes(drift_setup):
    """After drift from modes {0,1} to {2,3}, memory>0 keeps the old modes
    in the global model; memory=0 (stateless) forgets them."""
    _, mus = drift_setup
    old = make_window(np.random.default_rng(7), mus, [0, 1])[0]
    remember = run_windows(np.random.default_rng(1), mus,
                           [[0, 1], [2, 3], [2, 3]], memory=0.6)
    forget = run_windows(np.random.default_rng(1), mus,
                         [[0, 1], [2, 3], [2, 3]], memory=0.0)
    ll_mem = score(remember.global_gmm, old)
    ll_forget = score(forget.global_gmm, old)
    assert ll_mem > ll_forget + 2.0, (ll_mem, ll_forget)


def test_stationary_converges_to_batch(drift_setup):
    """On a stationary stream the continual model approaches the batch
    (all-data, centralized) fit."""
    _, mus = drift_setup
    state = run_windows(np.random.default_rng(2), mus,
                        [[0, 1, 2, 3]] * 3, memory=0.5, k_clients=4, h=80)
    x_all = make_window(np.random.default_rng(9), mus, [0, 1, 2, 3],
                        n=3000)[0]
    bench = fit_gmm(9, x_all, 4, device="cpu")
    ll_cont = score(state.global_gmm, x_all)
    ll_batch = score(bench.gmm, x_all)
    assert ll_cont > ll_batch - 0.5, (ll_cont, ll_batch)


def test_matches_jax_package_on_held_out_rows(drift_setup):
    """A drift from modes {0, 1} to {2, 3} at memory 0.5, the same three
    windows in both packages; each model scores held-out rows of every
    mode."""
    _, mus = drift_setup
    splits = windows(np.random.default_rng(3), mus,
                     [[0, 1], [2, 3], [2, 3]])
    port, ref = init_state(), jax_init_state()
    for i, split in enumerate(splits):
        port = continual_round(i, port, split.data, split.mask, split.sizes,
                               k_clients=3, k_global=4, h=50, memory=0.5,
                               device="cpu")
        ref = jax_continual_round(
            jax.random.key(i), ref, jnp.asarray(split.data),
            jnp.asarray(split.mask), split.sizes, k_clients=3, k_global=4,
            h=50, memory=0.5)
    held = make_window(np.random.default_rng(11), mus, [0, 1, 2, 3],
                       n=2000)[0]
    ll_port = score(port.global_gmm, held)
    ll_jax = float(ref.global_gmm.score(jnp.asarray(held)))
    assert port.rounds_total == ref.rounds_total == 3
    assert abs(ll_port - ll_jax) <= 0.2, (ll_port, ll_jax)
