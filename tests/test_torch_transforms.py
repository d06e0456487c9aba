"""The port's uplink transforms (``repro_torch.fed.transforms``) and their
seam on the round loop, on the CPU, mirroring the JAX package's
``tests/test_fed_transforms.py``.

The port draws from torch generators seeded by ``derive_seed``, so where
the reference tests a value that depends on its draws, the port is handed
the reference's own draws (rebuilt with ``jax.random`` on the reference's
key path): the DP releases are held to JAX's within rtol 1e-6 and atol 1e-6,
quantization grids, the int32 lattice (saturation edges included), the pair
masks and the masked channel exactly. The bit-identity anchors (Identity
and PairwiseMask leave a fit's bits alone) hold the port to itself with
``torch.equal``, on the split and the source backends. The reference's
sharded subprocess case has its counterpart at 4 gloo ranks in
``tests/test_torch_distributed.py::test_transform_seam_at_four_ranks``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as hst

from repro.core.dem import DEMStrategy as JaxDEMStrategy
from repro.core.em import SufficientStats as JaxStats
from repro.core.gmm import GMM as JaxGMM
from repro.core.partition import ClientSplit as JaxSplit
from repro.fed import transforms as jt
from repro.fed.runtime import run_rounds as jax_run_rounds
from repro_torch import api
from repro_torch.api import (DEM, DPConfig, FedEM, FedGenGMM, FedKMeans,
                             FitConfig, fit_federated)
from repro_torch.convert import gmm_from_numpy, split_to_clients
from repro_torch.core.dem import DEMStrategy
from repro_torch.core.em import SufficientStats, wrap_int32
from repro_torch.core.gmm import GMM
from repro_torch.core.partition import partition
from repro_torch.core.privacy import privatize_clients, privatize_gmm
from repro_torch.data.sources import ArraySource
from repro_torch.fed import (Compose, GaussianDP, Identity, PairwiseMask,
                             PayloadTransform, StochasticQuantize)
from repro_torch.fed.runtime import (SourceClients, _validate_transform,
                                     run_rounds)
from repro_torch.fed.transforms import (VAR_MAX, VAR_MIN, UplinkKey,
                                        clip_variances, gaussian_sigma,
                                        project_simplex, uplink_key)

CPU = FitConfig(device="cpu")


@pytest.fixture(scope="module")
def split():
    # features in [0,1]^d, the normalization the DP sensitivities assume
    rng = np.random.default_rng(7)
    x = rng.uniform(0.05, 0.95, size=(600, 3)).astype(np.float32)
    y = rng.integers(0, 2, size=600)
    return partition(rng, x, y, 4, "dirichlet", 100.0)


@pytest.fixture(scope="module")
def sources(split):
    parts = [split.data[i][split.mask[i] > 0.0]
             for i in range(split.data.shape[0])]
    assert all(len(p) for p in parts)
    return [ArraySource(p) for p in parts]


def assert_same_gmm(g1, g2):
    for f in ("weights", "means", "covs"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f


def _gmm_arrays(k=2, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(k)).astype(np.float32),
            rng.uniform(0.1, 0.9, (k, d)).astype(np.float32),
            rng.uniform(0.01, 0.2, (k, d)).astype(np.float32))


def _gmm(k=2, d=3, seed=0):
    return gmm_from_numpy(*_gmm_arrays(k, d, seed), "cpu")


def _stats_arrays(k=2, d=3, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1, 50, batch + (k,)).astype(np.float32),
            rng.uniform(0, 30, batch + (k, d)).astype(np.float32),
            rng.uniform(0, 20, batch + (k, d)).astype(np.float32),
            np.full(batch, -123.5, np.float32),
            np.full(batch, 100.0, np.float32))


def _stats(k=2, d=3, seed=0, batch=()):
    return SufficientStats(*(torch.as_tensor(a) for a in
                             _stats_arrays(k, d, seed, batch)))


KEY = UplinkKey(3, 0)


def _np(t):
    return np.asarray(t)


# ----------------------------------------------------------------------
# Bit-identity anchors: Identity and PairwiseMask leave fits untouched
# ----------------------------------------------------------------------

class TestBitIdentity:
    @pytest.mark.parametrize("transform", [Identity(), PairwiseMask()],
                             ids=["identity", "mask"])
    def test_dem_split_backend(self, split, transform):
        base = DEM(2, max_iter=4, config=CPU).run(split, seed=0)
        got = DEM(2, max_iter=4, transform=transform, config=CPU).run(
            split, seed=0)
        assert_same_gmm(base.global_gmm, got.global_gmm)
        assert base.n_rounds == got.n_rounds

    @pytest.mark.parametrize("transform", [Identity(), PairwiseMask()],
                             ids=["identity", "mask"])
    def test_dem_source_backend(self, sources, transform):
        base = DEM(2, max_iter=4, config=CPU).run(sources, seed=0)
        got = DEM(2, max_iter=4, transform=transform, config=CPU).run(
            sources, seed=0)
        assert_same_gmm(base.global_gmm, got.global_gmm)

    @pytest.mark.parametrize("transform", [Identity(), PairwiseMask()],
                             ids=["identity", "mask"])
    def test_fedem_split_backend(self, split, transform):
        kw = dict(participation=0.5, local_epochs=2, cohort="cyclic")
        base = FedEM(2, max_iter=6, config=CPU, **kw).run(split, seed=1)
        got = FedEM(2, max_iter=6, transform=transform, config=CPU,
                    **kw).run(split, seed=1)
        assert_same_gmm(base.global_gmm, got.global_gmm)

    def test_fedkmeans_identity(self, split):
        base = FedKMeans(2, max_iter=4, config=CPU).run(split, seed=2)
        got = FedKMeans(2, max_iter=4, transform=Identity(),
                        config=CPU).run(split, seed=2)
        assert torch.equal(base.centers, got.centers)

    def test_fedkmeans_mask(self, split):
        # FedKMeans' label statistics hold a float inertia scalar; the mask
        # channel rides beside every leaf and is stripped before combine
        base = FedKMeans(2, max_iter=4, config=CPU).run(split, seed=2)
        got = FedKMeans(2, max_iter=4, transform=PairwiseMask(),
                        config=CPU).run(split, seed=2)
        assert torch.equal(base.centers, got.centers)

    def test_fedgen_identity(self, split):
        base = FedGenGMM(k_clients=2, k_global=2, config=CPU).run(split,
                                                                  seed=3)
        got = FedGenGMM(k_clients=2, k_global=2, transform=Identity(),
                        config=CPU).run(split, seed=3)
        assert_same_gmm(base.global_gmm, got.global_gmm)


# ----------------------------------------------------------------------
# Mask cancellation: exactly zero through modular integer summation
# ----------------------------------------------------------------------

class TestMaskCancellation:
    def test_masks_sum_to_exact_zero(self):
        t = PairwiseMask(seed=3)
        members = np.arange(5)
        payload = {"a": torch.ones((4, 2)), "b": torch.zeros((3,))}
        total = None
        for i in range(5):
            m = t.mask(KEY, payload, i, members)
            total = m if total is None else {
                k: wrap_int32(total[k].long() + m[k].long()) for k in m}
        for leaf in total.values():
            assert leaf.dtype == torch.int32
            assert torch.equal(leaf, torch.zeros_like(leaf))

    def test_masked_channel_sum_equals_unmasked_lattice_sum(self):
        t = PairwiseMask(seed=9)
        members = np.arange(4)
        rng = np.random.default_rng(1)
        payloads = [torch.as_tensor(rng.normal(0, 1, (3, 2)),
                                    dtype=torch.float32) for _ in range(4)]
        wires = [t.apply(KEY, (), p, i, members)
                 for i, p in enumerate(payloads)]
        masked = wrap_int32(sum(w["secagg"].long() for w in wires))
        plain = wrap_int32(sum(t._lattice(p).long() for p in payloads))
        assert torch.equal(masked, plain)

    def test_single_wire_is_not_the_plain_lattice(self):
        t = PairwiseMask(seed=9)
        p = torch.ones((3, 2))
        w = t.apply(KEY, (), p, 0, np.arange(4))
        assert bool((w["secagg"] != t._lattice(p)).any())

    def test_finish_strips_the_channel(self):
        t = PairwiseMask()
        total = {"payload": torch.arange(3.0),
                 "secagg": torch.zeros(3, dtype=torch.int32)}
        assert torch.equal(t.finish(total), torch.arange(3.0))

    def test_batched_mask_equals_per_client(self):
        """A batch of clients draws each pair stream once; every client's
        mask is the one it derives alone, bit for bit."""
        t = PairwiseMask(seed=4)
        members = np.array([1, 4, 6, 7])
        stats = _stats(batch=(4,))
        batched = t.mask(KEY, stats, members, members)
        for r, i in enumerate(members):
            one = t.mask(KEY, stats._replace(
                **{f: getattr(stats, f)[r] for f in stats._fields}), int(i),
                members)
            for a, b in zip(batched, one):
                assert torch.equal(a[r], b)

    @pytest.mark.parametrize("cohort", [None, [0, 2, 3]],
                             ids=["all", "cohort"])
    @pytest.mark.parametrize("backend", ["split", "sources"])
    def test_channel_through_the_backend_reduce(self, split, sources,
                                                backend, cohort):
        """The secure-aggregation channel summed by a real backend reduce
        (int32, modulo 2^32) equals the sum of the clients' unmasked
        lattices exactly, and the float payload keeps the unmasked bits."""
        t = PairwiseMask(seed=5)
        clients = (split_to_clients(split, "cpu") if backend == "split"
                   else SourceClients(sources, "cpu"))
        gmm = GMM(torch.full((2,), 0.5),
                  torch.tensor([[0.3] * 3, [0.7] * 3]),
                  torch.full((2, 3), 0.05))
        strat = DEMStrategy(k=2, backend="reference")
        state = strat.state_from_gmm(gmm)
        total = clients.reduce_clients(strat.local_step, state, cohort,
                                       transform=t, tparams=(),
                                       tkey=uplink_key(t, 0))
        plain = clients.reduce_clients(strat.local_step, state, cohort)
        ids = range(4) if cohort is None else cohort
        if backend == "split":
            idx = torch.as_tensor(list(ids))
            batch = strat.local_step(state, clients.data[idx],
                                     clients.mask[idx], idx)
            per = [SufficientStats(*(a[r] for a in batch))
                   for r in range(len(idx))]
        else:
            per = [strat.local_step(state, sources[i], None, i) for i in ids]
        for f, leaf in enumerate(total["secagg"]):
            assert leaf.dtype == torch.int32
            want = wrap_int32(sum(t._lattice(p[f]).long() for p in per))
            assert torch.equal(leaf, want), f
        for a, b in zip(total["payload"], plain):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# Against the JAX package on injected draws
# ----------------------------------------------------------------------

def _jax_client_normals(key, idx, shapes):
    k = jax.random.fold_in(key, idx)
    return [np.array(jax.random.normal(kk, s, jnp.float32))
            for kk, s in zip(jax.random.split(k, 3), shapes)]


def _jax_pair_draws(key):
    def draw(lo, hi, t, shape):
        pk = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, lo), hi), t)
        bits = jax.lax.bitcast_convert_type(
            jax.random.bits(pk, shape, jnp.uint32), jnp.int32)
        return torch.as_tensor(np.array(bits))
    return draw


class TestAgainstJax:
    @pytest.mark.parametrize("eps", [0.25, 1.0, 4.0])
    @pytest.mark.parametrize("n", [5.0, 200.0])
    def test_release_gmm(self, eps, n):
        w, mu, var = _gmm_arrays(k=4, d=3, seed=2)
        key, idx = jax.random.key(11), 3
        jtr = jt.GaussianDP(epsilon=eps)
        exp, n_out = jtr.apply(key, jtr.traced(), (JaxGMM(
            jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var)), n), idx,
            None)
        z = _jax_client_normals(key, idx, [(4,), (4, 3), (4, 3)])
        t = GaussianDP(epsilon=eps)
        got, n_got = t.apply(KEY, t.traced(), (gmm_from_numpy(
            w, mu, var, "cpu"), n), idx, None,
            draws=tuple(torch.as_tensor(a) for a in z))
        assert n_got == n
        for f in ("weights", "means", "covs"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       _np(getattr(exp, f)), rtol=1e-6,
                                       atol=1e-6)

    @pytest.mark.parametrize("eps", [0.5, 3.0])
    def test_release_stats(self, eps):
        arrays = _stats_arrays(k=3, d=4, seed=5)
        key, idx = jax.random.key(12), 2
        jtr = jt.GaussianDP(epsilon=eps, rounds=3)
        exp = jtr.apply(key, jtr.traced(),
                        JaxStats(*map(jnp.asarray, arrays)), idx, None)
        z = _jax_client_normals(key, idx, [(3,), (3, 4), (3, 4)])
        t = GaussianDP(epsilon=eps, rounds=3)
        got = t.apply(KEY, t.traced(),
                      SufficientStats(*map(torch.as_tensor, arrays)), idx,
                      None, draws=tuple(map(torch.as_tensor, z)))
        for f in ("s0", "s1", "s2", "loglik", "wsum"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       _np(getattr(exp, f)), rtol=1e-6,
                                       atol=1e-6)

    def test_release_stats_batched_equals_per_client(self):
        """The split releases a batch of clients at once; each row is the
        release of that client alone (its draws are its own)."""
        t = GaussianDP(epsilon=2.0, rounds=4)
        stats = _stats(k=3, d=4, seed=6, batch=(5,))
        ids = np.array([0, 2, 3, 8, 9])
        batched = t.apply(KEY, t.traced(), stats, ids, ids)
        for r, i in enumerate(ids):
            one = t.apply(KEY, t.traced(), SufficientStats(
                *(a[r] for a in stats)), int(i), ids)
            for a, b in zip(batched, one):
                assert torch.equal(a[r], b)

    @pytest.mark.parametrize("bits", [8, 16])
    def test_quantize_grid(self, bits):
        rng = np.random.default_rng(0)
        payload = {"x": rng.normal(0, 1, (64, 8)).astype(np.float32),
                   "s": np.float32(3.5),
                   "z": np.zeros(4, np.float32),
                   "i": np.arange(3, dtype=np.int32)}
        key, idx = jax.random.key(5), 7
        exp = jt.StochasticQuantize(bits=bits).apply(
            key, (), {k: jnp.asarray(v) for k, v in payload.items()}, idx,
            None)
        ck = jax.random.fold_in(key, idx)
        leaves = [payload[k] for k in sorted(payload)]
        draws = [None if v.dtype.kind != "f" else torch.as_tensor(np.array(
            jax.random.uniform(jax.random.fold_in(ck, t), v.shape,
                               jnp.float32)))
                 for t, v in enumerate(leaves)]
        got = StochasticQuantize(bits=bits).apply(
            KEY, (), {k: torch.as_tensor(v) for k, v in payload.items()},
            idx, None, draws=draws)
        for k in payload:
            np.testing.assert_array_equal(got[k].numpy(), _np(exp[k]))
        assert got["i"].dtype == torch.int32

    @pytest.mark.parametrize("fp_bits", [0, 16, 30])
    def test_lattice_saturation_edges(self, fp_bits):
        edge = 2.0 ** 31 / 2.0 ** fp_bits
        vals = np.array([0.0, 0.4, -0.6, 1.5, edge, -edge, edge * 0.999999,
                         -edge * 0.999999, edge * 1.5, -edge * 1.5, 3e9,
                         -3e9, np.float32(np.inf), -np.float32(np.inf)],
                        np.float32)
        exp = jt.PairwiseMask(fp_bits=fp_bits)._lattice(jnp.asarray(vals))
        got = PairwiseMask(fp_bits=fp_bits)._lattice(torch.as_tensor(vals))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _np(exp))
        ints = np.array([5, -7, 2**31 - 1], np.int32)
        np.testing.assert_array_equal(
            PairwiseMask(fp_bits=fp_bits)._lattice(
                torch.as_tensor(ints)).numpy(),
            _np(jt.PairwiseMask(fp_bits=fp_bits)._lattice(
                jnp.asarray(ints))))

    def test_masks_and_channel(self):
        key = jax.random.key(9)
        members = np.array([0, 2, 5, 6])
        rng = np.random.default_rng(3)
        arrays = {"a": rng.normal(0, 1e4, (4, 2)).astype(np.float32),
                  "b": rng.normal(0, 1, (3,)).astype(np.float32)}
        jm, tm = jt.PairwiseMask(), PairwiseMask()
        draws = _jax_pair_draws(key)
        for idx in members:
            exp_mask = jm.mask(key, {k: jnp.asarray(v) for k, v in
                                     arrays.items()}, int(idx),
                               jnp.asarray(members))
            got_mask = tm.mask(KEY, {k: torch.as_tensor(v) for k, v in
                                     arrays.items()}, int(idx), members,
                               draws=draws)
            exp = jm.apply(key, (), {k: jnp.asarray(v) for k, v in
                                     arrays.items()}, int(idx),
                           jnp.asarray(members))
            got = tm.apply(KEY, (), {k: torch.as_tensor(v) for k, v in
                                     arrays.items()}, int(idx), members,
                           draws=draws)
            for k in arrays:
                np.testing.assert_array_equal(got_mask[k].numpy(),
                                              _np(exp_mask[k]))
                np.testing.assert_array_equal(got["secagg"][k].numpy(),
                                              _np(exp["secagg"][k]))
                np.testing.assert_array_equal(got["payload"][k].numpy(),
                                              arrays[k])

    def test_compose_quantize_then_mask(self):
        key, idx = jax.random.key(21), 1
        members = np.arange(3)
        x = np.random.default_rng(4).normal(0, 2, (5, 3)).astype(np.float32)
        jc = jt.Compose((jt.StochasticQuantize(bits=8), jt.PairwiseMask()))
        exp = jc.apply(key, jc.traced(), jnp.asarray(x), idx,
                       jnp.asarray(members))
        k0 = jax.random.fold_in(jax.random.fold_in(key, 0), idx)
        u = torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(k0, 0), x.shape, jnp.float32)))
        c = Compose((StochasticQuantize(bits=8), PairwiseMask()))
        got = c.apply(KEY, c.traced(), torch.as_tensor(x), idx, members,
                      draws=[[u], _jax_pair_draws(jax.random.fold_in(key,
                                                                     1))])
        np.testing.assert_array_equal(got["payload"].numpy(),
                                      _np(exp["payload"]))
        np.testing.assert_array_equal(got["secagg"].numpy(),
                                      _np(exp["secagg"]))

    def test_compose_chains_its_stages(self):
        """Stage t of a pipeline is the member's own apply under
        ``key.stage(t)``, on the previous stage's output."""
        c = Compose((GaussianDP(epsilon=2.0), StochasticQuantize(bits=16)))
        stats = _stats(k=3, d=2, seed=8)
        got = c.apply(KEY, c.traced(), stats, 4, None)
        dp, q = c.transforms
        want = q.apply(KEY.stage(1), (), dp.apply(
            KEY.stage(0), dp.traced(), stats, 4, None), 4, None)
        for a, b in zip(got, want):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("transform", [
        jt.GaussianDP(epsilon=3.0, rounds=4), jt.StochasticQuantize(bits=8),
        jt.StochasticQuantize(bits=16), jt.PairwiseMask(),
        jt.Compose((jt.GaussianDP(epsilon=8.0, rounds=2),
                    jt.StochasticQuantize(bits=16)))],
        ids=["dp", "q8", "q16", "mask", "compose"])
    def test_ledger_matches_jax(self, split, transform):
        """From one injected model at tol 0 both packages run 3 rounds; the
        transform-aware ledgers agree field for field."""
        g0 = _gmm_arrays(k=2, d=3, seed=1)
        jstrat = JaxDEMStrategy(k=2, init="separated", tol=0.0)
        exp = jax_run_rounds(
            jstrat, JaxSplit(*split), key=jax.random.key(0),
            state0=jstrat.state_from_gmm(JaxGMM(*map(jnp.asarray, g0)),
                                         dtype=jnp.float32),
            max_rounds=3, transform=transform)
        port = {jt.GaussianDP: lambda t: GaussianDP(epsilon=t.epsilon,
                                                    rounds=t.rounds),
                jt.StochasticQuantize: lambda t: StochasticQuantize(t.bits),
                jt.PairwiseMask: lambda t: PairwiseMask(),
                jt.Compose: lambda t: Compose((
                    GaussianDP(epsilon=8.0, rounds=2),
                    StochasticQuantize(bits=16)))}[type(transform)](
            transform)
        strat = DEMStrategy(k=2, init="separated", tol=0.0)
        got = run_rounds(strat, split, device="cpu",
                         state0=strat.state_from_gmm(gmm_from_numpy(
                             *g0, "cpu")), max_rounds=3, transform=port)
        assert got.comm._asdict() == exp.comm._asdict()
        assert got.comm.uplink_bytes == exp.comm.uplink_bytes


# ----------------------------------------------------------------------
# GaussianDP mechanics and the epsilon accountant
# ----------------------------------------------------------------------

class TestGaussianDP:
    def test_gmm_release_respects_projections(self):
        t = GaussianDP(epsilon=0.5)
        rel, n = t.apply(KEY, t.traced(), (_gmm(), 200.0), 0, None)
        w = rel.weights.numpy()
        assert np.isclose(w.sum(), 1.0, atol=1e-6)
        assert (w > 0).all()
        mu = rel.means.numpy()
        assert (mu >= 0.0).all() and (mu <= 1.0).all()
        var = rel.covs.numpy()
        assert (var >= VAR_MIN).all() and (var <= VAR_MAX).all()
        assert float(n) == 200.0

    def test_noise_shrinks_with_epsilon(self):
        g = _gmm()

        def err(eps):
            t = GaussianDP(epsilon=eps)
            rel, _ = t.apply(UplinkKey(1, 0), t.traced(), (g, 500.0), 0,
                             None)
            return float(torch.mean(torch.abs(rel.means - g.means)))

        assert err(100.0) < err(0.2)

    def test_stats_release_floors_and_telemetry(self):
        t = GaussianDP(epsilon=1.0)
        s = _stats()
        rel = t.apply(UplinkKey(2, 0), t.traced(), s, 0, None)
        assert bool((rel.s0 >= 0.0).all()) and bool((rel.s2 >= 0.0).all())
        assert bool((rel.s1 != s.s1).any())
        # loglik / wsum are convergence telemetry, not model payload
        assert torch.equal(rel.loglik, s.loglik)
        assert torch.equal(rel.wsum, s.wsum)

    def test_unknown_payload_raises(self):
        t = GaussianDP()
        with pytest.raises(TypeError, match="SufficientStats"):
            t.apply(KEY, t.traced(), torch.zeros(3), 0, None)

    def test_accountant_depletes_across_rounds(self, split):
        t = GaussianDP(epsilon=4.0, rounds=4)
        res = DEM(2, max_iter=4, tol=0.0, transform=t, config=CPU).run(
            split, seed=0)
        assert res.n_rounds == 4
        assert np.isclose(res.comm.epsilon_spent, 4.0)
        assert np.isclose(res.comm.epsilon_spent,
                          t.epsilon_per_round() * res.n_rounds)

    def test_one_shot_spends_whole_budget_once(self, split):
        res = FedGenGMM(k_clients=2, k_global=2, dp=DPConfig(epsilon=4.0),
                        config=CPU).run(split, seed=0)
        assert res.comm.rounds == 1
        assert np.isclose(res.comm.epsilon_spent, 4.0)

    def test_one_shot_releases_each_client_under_round_zero(self, split):
        """FedGenGMM's released blocks are each client's model released
        with its own stream of round 0's key."""
        dp = DPConfig(epsilon=2.0)
        res = FedGenGMM(k_clients=2, k_global=2, dp=dp, config=CPU).run(
            split, seed=0)
        t = dp.transform()
        members = np.arange(len(res.local_gmms))
        for i, (r, g) in enumerate(zip(res.local_results, res.local_gmms)):
            want, _ = t.apply(uplink_key(t, 0), t.traced(),
                              (r.gmm, float(split.sizes[i])), i, members)
            assert_same_gmm(g, want)

    def test_dp_perturbs_but_preserves_structure(self, split):
        base = DEM(2, max_iter=4, config=CPU).run(split, seed=0)
        noisy = DEM(2, max_iter=4, config=CPU,
                    transform=GaussianDP(epsilon=2.0, rounds=4)).run(
            split, seed=0)
        assert bool((noisy.global_gmm.means != base.global_gmm.means).any())
        assert bool((noisy.global_gmm.covs > 0).all())
        assert np.isclose(float(noisy.global_gmm.weights.sum()), 1.0,
                          atol=1e-5)


# ----------------------------------------------------------------------
# Stochastic quantization
# ----------------------------------------------------------------------

class TestStochasticQuantize:
    def test_seeded_determinism_and_unbiased_grid(self):
        t = StochasticQuantize(bits=8)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            0, 1, (64, 8)).astype(np.float32))
        a = t.apply(UplinkKey(5, 0), (), x, 0, None)
        b = t.apply(UplinkKey(5, 0), (), x, 0, None)
        assert torch.equal(a, b)
        c = t.apply(UplinkKey(6, 0), (), x, 0, None)
        assert bool((a != c).any())
        step = float(torch.max(torch.abs(x))) / 127.0
        assert float(torch.max(torch.abs(a - x))) <= step + 1e-6

    def test_zero_and_int_leaves_pass_through(self):
        t = StochasticQuantize(bits=8)
        payload = {"z": torch.zeros(4),
                   "i": torch.arange(3, dtype=torch.int32)}
        out = t.apply(KEY, (), payload, 0, None)
        assert torch.equal(out["z"], torch.zeros(4))
        assert torch.equal(out["i"], payload["i"])

    def test_ledger_reports_honest_wire_bytes(self, split):
        base = DEM(2, max_iter=4, config=CPU).run(split, seed=0)
        q8 = DEM(2, max_iter=4, transform=StochasticQuantize(bits=8),
                 config=CPU).run(split, seed=0)
        q16 = DEM(2, max_iter=4, transform=StochasticQuantize(bits=16),
                  config=CPU).run(split, seed=0)
        assert q8.comm.uplink_itemsize == 1
        assert q16.comm.uplink_itemsize == 2
        # the broadcast stays float32: the asymmetric wire
        assert q8.comm.downlink_bytes == q8.comm.downlink_floats * 4
        if q8.comm.rounds == base.comm.rounds:
            assert q8.comm.uplink_bytes * 4 == base.comm.uplink_bytes

    def test_bits_is_structural_seed_is_not(self):
        assert StochasticQuantize(bits=8) != StochasticQuantize(bits=16)
        assert StochasticQuantize(seed=0) == StochasticQuantize(seed=9)
        assert hash(StochasticQuantize(seed=0)) == \
            hash(StochasticQuantize(seed=9))

    def test_validates_bits(self):
        with pytest.raises(ValueError, match="bits"):
            StochasticQuantize(bits=12)


# ----------------------------------------------------------------------
# Composition
# ----------------------------------------------------------------------

class TestCompose:
    def test_accounting_folds_through_stages(self):
        c = Compose((GaussianDP(epsilon=2.0, rounds=2),
                     StochasticQuantize(bits=8), PairwiseMask()))
        assert np.isclose(c.epsilon_per_round(), 1.0)
        assert c.wire_itemsize(4) == 4   # the mask's int32 lattice wins
        assert c.additive_only
        c2 = Compose((GaussianDP(), StochasticQuantize(bits=16)))
        assert c2.wire_itemsize(4) == 2
        assert not c2.additive_only

    def test_member_reseed_does_not_change_equality(self):
        a = Compose((GaussianDP(seed=1), StochasticQuantize(bits=8)))
        b = Compose((GaussianDP(seed=2), StochasticQuantize(bits=8)))
        assert a == b and hash(a) == hash(b)
        assert a.seed != b.seed
        # the same combination of member seeds as the JAX package
        assert a.seed == jt.Compose((jt.GaussianDP(seed=1),
                                     jt.StochasticQuantize(bits=8))).seed

    def test_identity_mask_pipeline_is_bit_identical(self, split):
        base = DEM(2, max_iter=4, config=CPU).run(split, seed=0)
        got = DEM(2, max_iter=4, config=CPU,
                  transform=Compose((Identity(), PairwiseMask()))).run(
            split, seed=0)
        assert_same_gmm(base.global_gmm, got.global_gmm)

    def test_dp_then_quantize_runs(self, split):
        t = Compose((GaussianDP(epsilon=8.0, rounds=4),
                     StochasticQuantize(bits=16)))
        res = DEM(2, max_iter=4, transform=t, config=CPU).run(split, seed=0)
        assert res.comm.uplink_itemsize == 2
        assert res.comm.epsilon_spent > 0.0

    def test_rejects_non_transform_members(self):
        with pytest.raises(TypeError, match="Compose members"):
            Compose((GaussianDP(), 42))


# ----------------------------------------------------------------------
# Property tests
# ----------------------------------------------------------------------

class TestProperties:
    @settings(max_examples=25, deadline=None)
    @given(w=hst.lists(hst.floats(min_value=-2.0, max_value=2.0,
                                  allow_nan=False),
                       min_size=2, max_size=8))
    def test_project_simplex(self, w):
        out = project_simplex(torch.tensor(w, dtype=torch.float32)).numpy()
        assert np.isclose(out.sum(), 1.0, atol=1e-5)
        assert (out > 0.0).all()
        np.testing.assert_allclose(out, _np(jt.project_simplex(
            jnp.asarray(w, jnp.float32))), rtol=1e-6, atol=1e-7)

    @settings(max_examples=25, deadline=None)
    @given(v=hst.lists(hst.floats(min_value=-10.0, max_value=10.0,
                                  allow_nan=False),
                       min_size=1, max_size=8))
    def test_clip_variances(self, v):
        out = clip_variances(torch.tensor(v, dtype=torch.float32)).numpy()
        assert (out >= VAR_MIN).all() and (out <= VAR_MAX).all()

    @settings(max_examples=10, deadline=None)
    @given(seed=hst.integers(min_value=0, max_value=2**31 - 1),
           eps=hst.floats(min_value=0.1, max_value=50.0))
    def test_seeded_release_is_deterministic(self, seed, eps):
        t = GaussianDP(epsilon=eps)
        key = UplinkKey(seed, 0)
        a, _ = t.apply(key, t.traced(), (_gmm(), 100.0), 0, None)
        b, _ = t.apply(key, t.traced(), (_gmm(), 100.0), 0, None)
        assert_same_gmm(a, b)

    def test_sigma_matches_host_closed_form(self):
        got = gaussian_sigma(2.0, 0.5, 1e-5)
        want = math.sqrt(2.0 * math.log(1.25 / 1e-5)) * 2.0 / 0.5
        assert np.isclose(got, want, rtol=1e-12)
        assert np.isclose(got, float(jt.gaussian_sigma(2.0, 0.5, 1e-5)),
                          rtol=1e-6)


# ----------------------------------------------------------------------
# Validation and rejection
# ----------------------------------------------------------------------

class TestValidation:
    @pytest.mark.parametrize("kw,msg", [
        (dict(epsilon=0.0), "epsilon"),
        (dict(epsilon=-1.0), "epsilon"),
        (dict(delta=0.0), "delta"),
        (dict(delta=1.0), "delta"),
        (dict(min_count=0.0), "min_count"),
    ])
    def test_dpconfig_validates_at_construction(self, kw, msg):
        with pytest.raises(ValueError, match=msg):
            DPConfig(**kw)

    @pytest.mark.parametrize("kw,msg", [
        (dict(epsilon=0.0), "epsilon"),
        (dict(delta=2.0), "delta"),
        (dict(rounds=0), "rounds"),
        (dict(min_count=-1.0), "min_count"),
    ])
    def test_gaussian_dp_validates_at_construction(self, kw, msg):
        with pytest.raises(ValueError, match=msg):
            GaussianDP(**kw)

    def test_numeric_knobs_are_not_structural(self):
        assert GaussianDP(epsilon=1.0) == GaussianDP(epsilon=9.0, seed=3,
                                                     rounds=7)
        assert hash(GaussianDP(epsilon=1.0)) == \
            hash(GaussianDP(epsilon=9.0, seed=3, rounds=7))
        assert PairwiseMask(seed=1) == PairwiseMask(seed=2)
        assert PairwiseMask(fp_bits=8) != PairwiseMask(fp_bits=16)

    def test_full_covariance_release_raises_named_error(self):
        g = GMM(torch.full((2,), 0.5), torch.zeros((2, 3)),
                torch.eye(3).repeat(2, 1, 1))
        with pytest.raises(ValueError, match="full"):
            privatize_gmm(0, g, 100.0, DPConfig())

    def test_privatize_clients_matches_transform(self):
        g = _gmm()
        dp = DPConfig(epsilon=2.0)
        [rel] = privatize_clients(4, [g], [150.0], dp)
        t = GaussianDP(epsilon=2.0, rounds=1)
        from repro_torch.core.config import derive_seed
        want, _ = t.apply(UplinkKey(derive_seed(4, 0), 0), t.traced(),
                          (g, 150.0), 0, None)
        assert_same_gmm(rel, want)

    def test_run_rounds_rejects_non_transform(self, split):
        with pytest.raises(TypeError, match="PayloadTransform"):
            DEM(2, max_iter=2, transform=object(), config=CPU).run(
                split, seed=0)
        _validate_transform(Identity())  # and the real thing passes

    def test_one_shot_rejects_additive_only(self, split):
        with pytest.raises(ValueError, match="additive"):
            FedGenGMM(k_clients=2, k_global=2, transform=PairwiseMask(),
                      config=CPU).run(split, seed=0)
        with pytest.raises(ValueError, match="additive"):
            fit_federated(split, strategy="fedgen", k_clients=2,
                          k_global=2, transform=Compose((PairwiseMask(),)),
                          config=CPU, seed=0)

    def test_dp_and_transform_are_exclusive(self):
        with pytest.raises(ValueError, match="not both"):
            FedGenGMM(k_clients=2, k_global=2, dp=DPConfig(),
                      transform=Identity())
        with pytest.raises(TypeError, match="DPConfig"):
            FedGenGMM(k_clients=2, k_global=2, dp=1.0)

    def test_builtins_satisfy_the_protocol(self):
        for t in (Identity(), GaussianDP(), StochasticQuantize(),
                  PairwiseMask(), Compose((Identity(),))):
            assert isinstance(t, PayloadTransform)
            assert dataclasses.is_dataclass(t)
            hash(t)

    def test_dpconfig_is_in_the_api(self):
        assert "DPConfig" in api.__all__ and api.DPConfig is DPConfig


# ----------------------------------------------------------------------
# The api seam end to end
# ----------------------------------------------------------------------

class TestApiSeam:
    def test_fit_federated_named_with_transform(self, split):
        cfg = CPU.replace(max_iter=4)
        base = fit_federated(split, strategy="dem", k=2, config=cfg, seed=0)
        got = fit_federated(split, strategy="dem", k=2, config=cfg,
                            transform=Identity(), seed=0)
        assert_same_gmm(base.global_gmm, got.global_gmm)

    def test_fit_federated_custom_with_transform(self, split):
        strat = DEMStrategy(k=2, tol=1e-3)
        base = fit_federated(split, strategy=strat, max_rounds=4,
                             config=CPU, seed=0)
        got = fit_federated(split, strategy=strat, max_rounds=4,
                            transform=PairwiseMask(), config=CPU, seed=0)
        assert_same_gmm(base.global_gmm, got.global_gmm)

    def test_same_seed_same_noise_across_backends(self, split, sources):
        # the per-client seed path is backend-independent, so the same DP
        # draws land on split and source runs (their float reductions may
        # round differently; the model must agree to f32 tolerance)
        t = GaussianDP(epsilon=3.0, rounds=4, seed=42)
        rs = DEM(2, max_iter=4, transform=t, config=CPU).run(split, seed=0)
        ro = DEM(2, max_iter=4, transform=t, config=CPU).run(sources,
                                                             seed=0)
        np.testing.assert_allclose(rs.global_gmm.means.numpy(),
                                   ro.global_gmm.means.numpy(), atol=1e-4)

    def test_reseed_changes_noise(self, split):
        a = DEM(2, max_iter=4, config=CPU,
                transform=GaussianDP(epsilon=2.0, seed=0)).run(split, seed=0)
        b = DEM(2, max_iter=4, config=CPU,
                transform=GaussianDP(epsilon=2.0, seed=1)).run(split, seed=0)
        assert bool((a.global_gmm.means != b.global_gmm.means).any())
