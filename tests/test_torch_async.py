"""The port's asynchronous driver and client executor
(``repro_torch.fed.async_runtime``) on the CPU, mirroring the JAX package's
``tests/test_fed_async.py``.

Sync parity: ``run_async`` with ``buffer_size = cohort size`` and
``lookahead = 0`` equals ``run_rounds`` bit for bit on the split and source
backends, with and without a sampler, stragglers and each transform. A
buffered run from one injected model is held to the JAX package's
``run_async``: the same combines, the same staleness histogram, final avg
log-likelihood within 1e-4 (DESIGN.md §6) and the same ledger.
"""
import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import planted_gmm_data
from repro.core.dem import DEMStrategy as JaxDEMStrategy
from repro.core.gmm import GMM as JaxGMM
from repro.core.partition import ClientSplit as JaxSplit
from repro.fed import CyclicSampler as JaxCyclic
from repro.fed import StochasticQuantize as JaxQuantize
from repro.fed.async_runtime import run_async as jax_run_async
from repro_torch.api import DEM, FedEM, FitConfig, fit_federated
from repro_torch.convert import gmm_from_numpy
from repro_torch.core.dem import DEMStrategy
from repro_torch.core.partition import partition
from repro_torch.data.sources import ArraySource
from repro_torch.fed import (ArrivalStragglers, AsyncPolicy, ClientExecutor,
                             CyclicSampler, GaussianDP, PairwiseMask,
                             PolynomialStaleness, RoundPayload,
                             StochasticQuantize, UniformSampler, run_async,
                             run_rounds)
from repro_torch.fed.async_runtime import _resolve_staleness

CPU = FitConfig(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x, y, mus = planted_gmm_data(rng, n=2400, d=4, k=3, spread=5.0,
                                 std=0.5, min_sep_sigma=8.0)
    return x, y, mus


@pytest.fixture(scope="module")
def split(data):
    x, y, _ = data
    return partition(np.random.default_rng(0), x, y, 8, "dirichlet", 0.5)


@pytest.fixture(scope="module")
def shards(data):
    x, _, _ = data
    return [ArraySource(x[:700]), ArraySource(x[700:1500]),
            ArraySource(x[1500:])]


def assert_same_gmm(a, b):
    for f in ("weights", "means", "covs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


STRAT = DEMStrategy(k=3, init="separated", tol=1e-6)
KW = dict(seed=7, device="cpu")


class TestSyncEquivalence:
    def test_split_backend_bit_identical(self, split):
        rs = run_rounds(STRAT, split, max_rounds=6, **KW)
        ra = run_async(STRAT, split, max_rounds=6, **KW)
        assert_same_gmm(rs.global_gmm, ra.global_gmm)
        assert rs.n_rounds == ra.n_rounds
        assert rs.converged == ra.converged

    def test_source_backend_bit_identical(self, shards):
        rs = run_rounds(STRAT, shards, max_rounds=6, **KW)
        ra = run_async(STRAT, shards, max_rounds=6, **KW)
        assert_same_gmm(rs.global_gmm, ra.global_gmm)
        assert rs.n_rounds == ra.n_rounds

    @pytest.mark.parametrize("sampler_cls", [CyclicSampler, UniformSampler])
    def test_sampled_cohorts_bit_identical(self, split, sampler_cls):
        sampler = sampler_cls(8, 4)
        rs = run_rounds(STRAT, split, max_rounds=5, sampler=sampler, **KW)
        ra = run_async(STRAT, split, max_rounds=5, sampler=sampler, **KW)
        assert_same_gmm(rs.global_gmm, ra.global_gmm)

    @pytest.mark.parametrize("backend", ["split", "sources"])
    def test_stragglers_bit_identical(self, split, shards, backend):
        clients, n = (split, 8) if backend == "split" else (shards, 3)
        kw = dict(max_rounds=5, sampler=UniformSampler(n, 2, seed=3),
                  stragglers=ArrivalStragglers(0.25, seed=9), **KW)
        assert_same_gmm(run_rounds(STRAT, clients, **kw).global_gmm,
                        run_async(STRAT, clients, **kw).global_gmm)

    @pytest.mark.parametrize("transform", [
        GaussianDP(epsilon=5.0, rounds=5, seed=5),
        StochasticQuantize(bits=16, seed=5),
        PairwiseMask(seed=11),
    ], ids=lambda t: type(t).__name__)
    @pytest.mark.parametrize("backend", ["split", "sources"])
    def test_transforms_bit_identical(self, split, shards, transform,
                                      backend):
        clients = split if backend == "split" else shards
        kw = dict(max_rounds=5, transform=transform, **KW)
        rs = run_rounds(STRAT, clients, **kw)
        ra = run_async(STRAT, clients, **kw)
        assert_same_gmm(rs.global_gmm, ra.global_gmm)
        assert rs.comm == ra.comm._replace(staleness=())

    def test_zero_staleness_recorded(self, split):
        ra = run_async(STRAT, split, max_rounds=4, **KW)
        assert ra.comm.staleness == ((0, 4 * 8),)
        assert ra.comm.mean_staleness == 0.0


class TestClientExecutor:
    def test_reduction_bit_identical_to_serial_loop(self, shards):
        serial = run_rounds(STRAT, shards, max_rounds=6, **KW)
        with ClientExecutor(max_workers=3) as ex:
            pooled = run_rounds(STRAT, shards, max_rounds=6, executor=ex,
                                **KW)
            pooled_async = run_async(STRAT, shards, max_rounds=6,
                                     executor=ex, **KW)
        assert_same_gmm(serial.global_gmm, pooled.global_gmm)
        assert_same_gmm(serial.global_gmm, pooled_async.global_gmm)

    def test_transformed_reduction_on_the_pool(self, shards):
        """Workers draw their clients' noise and masks from the clients'
        own streams: no generator is shared, the bits are the serial
        loop's."""
        t = GaussianDP(epsilon=4.0, rounds=4, seed=1)
        serial = run_rounds(STRAT, shards, max_rounds=4, transform=t, **KW)
        with ClientExecutor(max_workers=3) as ex:
            pooled = run_rounds(STRAT, shards, max_rounds=4, transform=t,
                                executor=ex, **KW)
        assert_same_gmm(serial.global_gmm, pooled.global_gmm)

    def test_map_ordered_is_submission_order(self):
        with ClientExecutor(max_workers=4) as ex:
            # later items finish first; results must not be reordered
            got = ex.map_ordered(
                lambda i: (time.sleep(0.02 * (4 - i)), i)[1], range(4))
        assert got == [0, 1, 2, 3]

    def test_map_ordered_under_contention(self):
        """More workers than cores and a short switch interval: every
        result lands in its own slot, none lost."""
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with ClientExecutor(max_workers=16) as ex:
                got = ex.map_ordered(lambda i: sum(range(i)) + i,
                                     list(range(400)))
        finally:
            sys.setswitchinterval(old)
        assert got == [sum(range(i)) + i for i in range(400)]

    def test_run_async_owns_pool_via_max_workers(self, shards):
        before = threading.active_count()
        serial = run_async(STRAT, shards, max_rounds=4, **KW)
        pooled = run_async(STRAT, shards, max_rounds=4, max_workers=2, **KW)
        assert_same_gmm(serial.global_gmm, pooled.global_gmm)
        deadline = time.time() + 5.0
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= before   # the pool was shut down

    def test_rejects_zero_workers(self):
        with pytest.raises(ValueError, match="max_workers"):
            ClientExecutor(max_workers=0)


class TestStalenessWeighting:
    def test_polynomial_rule_values(self):
        rule = PolynomialStaleness(alpha=0.5)
        assert rule.weight(0) == 1.0
        assert rule.weight(3) == (1.0 + 3) ** -0.5
        assert PolynomialStaleness(alpha=0.0).weight(9) == 1.0
        with pytest.raises(ValueError):
            PolynomialStaleness(alpha=-1.0)
        with pytest.raises(ValueError):
            rule.weight(-1)

    def test_staleness_weights_sum_to_surviving_wsum(self, split):
        """The combined payload's wsum is exactly the staleness-weighted
        sum of the consumed clients' row counts."""
        sizes = split.mask.sum(axis=1)

        @dataclasses.dataclass(frozen=True)
        class WsumProbe:
            """Minimal strategy whose state is the combined wsum."""
            one_shot: bool = False

            def init_state(self, seed, backend):
                return torch.zeros(())

            def local_step(self, state, x, w, idx):
                return torch.sum(w, dim=-1)       # each client's row count

            def server_combine(self, state, total):
                return total

            def converged(self, state):
                return False

            def round_payload(self, backend, state):
                return RoundPayload(uplink_floats=backend.num_clients,
                                    downlink_floats=1)

            def finalize(self, state, n_rounds, converged, comm):
                return state

        rule = PolynomialStaleness(alpha=0.5)
        seen = []
        run_async(WsumProbe(), split, max_rounds=6, buffer_size=4,
                  lookahead=8, staleness=rule,
                  progress=lambda v, s, st: seen.append(
                      (float(s), tuple(st))), **KW)
        consumed = 0
        for combined, stales in seen:
            members = [(consumed + j) % 8 for j in range(4)]
            want = sum(rule.weight(s) * sizes[m]
                       for m, s in zip(members, stales))
            np.testing.assert_allclose(combined, want, rtol=1e-6)
            consumed += 4

    def test_staleness_histogram_in_ledger(self, split):
        ra = run_async(STRAT, split, max_rounds=6, buffer_size=4,
                       lookahead=8, **KW)
        hist = dict(ra.comm.staleness)
        assert sum(hist.values()) == 6 * 4
        assert max(hist) > 0
        assert ra.comm.mean_staleness > 0.0

    def test_steady_state_staleness_is_lookahead_over_buffer(self, split):
        seen = []
        run_async(STRAT, split, max_rounds=8, buffer_size=4, lookahead=8,
                  sampler=CyclicSampler(8, 4),
                  progress=lambda v, s, st: seen.append(st), **KW)
        assert set(seen[-1]) == {2}               # k = 8 / 4

    def test_stale_states_are_pruned(self, split):
        """Only the models of versions still in flight are kept: with
        lookahead = k * buffer, at most k + 1 versions at once."""
        import repro_torch.fed.async_runtime as ar
        kept = []
        real = ar._group_consumed

        def spy(consumed):
            frame = sys._getframe(1)
            kept.append(len(frame.f_locals["states"]))
            return real(consumed)

        ar._group_consumed = spy
        try:
            run_async(STRAT, split, max_rounds=10, buffer_size=4,
                      lookahead=8, sampler=CyclicSampler(8, 4), **KW)
        finally:
            ar._group_consumed = real
        assert max(kept) <= 3 and kept[-1] == 3

    def test_dropped_stragglers_excluded_from_histogram(self, split):
        ra = run_async(STRAT, split, max_rounds=4,
                       sampler=UniformSampler(8, 4, seed=3),
                       stragglers=ArrivalStragglers(0.25, seed=9), **KW)
        surviving = 4 * ArrivalStragglers(0.25).n_keep(4)
        assert sum(n for _, n in ra.comm.staleness) == surviving


def _gmm0(split, mus):
    w = np.full(3, 1 / 3, np.float32)
    mu = (mus + np.random.default_rng(1).normal(0, 1.0, mus.shape)
          ).astype(np.float32)
    var = np.tile(split.data[split.mask > 0].var(0), (3, 1)).astype(
        np.float32)
    return w, mu, var


class TestAgainstJax:
    @pytest.mark.parametrize("buffer,lookahead,cyclic,alpha", [
        (4, 8, False, 0.5), (2, 4, True, 0.5), (3, 5, False, 1.0),
        (4, 8, True, 0.0)])
    def test_buffered_run_matches_jax(self, data, split, buffer, lookahead,
                                      cyclic, alpha):
        _, _, mus = data
        g0 = _gmm0(split, mus)
        jstrat = JaxDEMStrategy(k=3, init="separated", tol=1e-6)
        exp = jax_run_async(
            jstrat, JaxSplit(*split), key=jax.random.key(0),
            state0=jstrat.state_from_gmm(JaxGMM(*map(jnp.asarray, g0)),
                                         dtype=jnp.float32),
            max_rounds=12, buffer_size=buffer, lookahead=lookahead,
            staleness=alpha, sampler=JaxCyclic(8, 4) if cyclic else None)
        got = run_async(
            STRAT, split, state0=STRAT.state_from_gmm(gmm_from_numpy(
                *g0, "cpu")), max_rounds=12, buffer_size=buffer,
            lookahead=lookahead, staleness=alpha,
            sampler=CyclicSampler(8, 4) if cyclic else None, **KW)
        assert got.n_rounds == int(exp.n_rounds)
        assert got.comm.staleness == exp.comm.staleness
        assert abs(float(got.log_likelihood)
                   - float(exp.log_likelihood)) <= 1e-4
        np.testing.assert_allclose(got.global_gmm.means.numpy(),
                                   np.asarray(exp.global_gmm.means),
                                   rtol=2e-4, atol=2e-4)

    def test_ledger_matches_jax(self, data, split):
        _, _, mus = data
        g0 = _gmm0(split, mus)
        jstrat = JaxDEMStrategy(k=3, init="separated", tol=0.0)
        exp = jax_run_async(
            jstrat, JaxSplit(*split), key=jax.random.key(0),
            state0=jstrat.state_from_gmm(JaxGMM(*map(jnp.asarray, g0)),
                                         dtype=jnp.float32),
            max_rounds=7, buffer_size=4, lookahead=4,
            transform=JaxQuantize(bits=8))
        strat = DEMStrategy(k=3, init="separated", tol=0.0)
        got = run_async(
            strat, split, state0=strat.state_from_gmm(gmm_from_numpy(
                *g0, "cpu")), max_rounds=7, buffer_size=4, lookahead=4,
            transform=StochasticQuantize(bits=8), **KW)
        assert got.comm._asdict() == exp.comm._asdict()
        assert got.comm.uplink_bytes == exp.comm.uplink_bytes
        assert got.comm.mean_staleness == exp.comm.mean_staleness


class TestValidationAndPolicy:
    def test_one_shot_rejected(self, split):
        from repro_torch.core.fedgen import FedGenStrategy
        strat = FedGenStrategy(config=CPU, k_clients=2, k_global=2, h=10)
        with pytest.raises(ValueError, match="one-shot"):
            run_async(strat, split, **KW)

    def test_buffer_bounds_enforced(self, split):
        with pytest.raises(ValueError, match="buffer_size"):
            run_async(STRAT, split, buffer_size=0, **KW)
        with pytest.raises(ValueError, match="buffer_size"):
            run_async(STRAT, split, buffer_size=9, **KW)
        with pytest.raises(ValueError, match="lookahead"):
            run_async(STRAT, split, lookahead=-1, **KW)

    def test_additive_only_transform_needs_sync_equivalence(self, split):
        with pytest.raises(ValueError, match="whole cohort"):
            run_async(STRAT, split, transform=PairwiseMask(),
                      buffer_size=4, **KW)
        with pytest.raises(ValueError, match="whole cohort"):
            run_async(STRAT, split, transform=PairwiseMask(), lookahead=4,
                      **KW)
        with pytest.raises(ValueError, match="whole cohort"):
            DEM(3, config=CPU, transform=PairwiseMask(),
                async_policy=AsyncPolicy(buffer_size=2)).run(split)

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            AsyncPolicy(buffer_size=0)
        with pytest.raises(ValueError):
            AsyncPolicy(lookahead=-1)
        with pytest.raises(ValueError):
            AsyncPolicy(staleness_alpha=-0.5)
        with pytest.raises(ValueError):
            AsyncPolicy(max_workers=-1)
        kw = AsyncPolicy(buffer_size=4, lookahead=8,
                         staleness_alpha=0.25).driver_kwargs()
        assert kw["buffer_size"] == 4 and kw["lookahead"] == 8
        assert kw["staleness"] == PolynomialStaleness(0.25)

    def test_staleness_argument_forms(self, split):
        a = run_async(STRAT, split, max_rounds=3, buffer_size=4,
                      lookahead=4, staleness=0.5, **KW)
        b = run_async(STRAT, split, max_rounds=3, buffer_size=4,
                      lookahead=4, staleness=PolynomialStaleness(0.5), **KW)
        assert_same_gmm(a.global_gmm, b.global_gmm)
        with pytest.raises(TypeError, match="weight"):
            run_async(STRAT, split, staleness="fast", **KW)
        assert _resolve_staleness(None) == PolynomialStaleness()


class TestFacadeRouting:
    def test_dem_facade_sync_policy_bit_identical(self, split):
        cfg = CPU.replace(init="separated", max_iter=5)
        plain = DEM(3, config=cfg).run(split, seed=7)
        routed = DEM(3, config=cfg, async_policy=AsyncPolicy()).run(
            split, seed=7)
        assert_same_gmm(plain.global_gmm, routed.global_gmm)

    def test_fedem_facade_sync_policy_bit_identical(self, split):
        cfg = CPU.replace(init="separated", max_iter=5)
        kw = dict(participation=0.5, cohort="cyclic", config=cfg)
        plain = FedEM(3, **kw).run(split, seed=7)
        routed = FedEM(3, async_policy=AsyncPolicy(), **kw).run(split,
                                                                seed=7)
        assert_same_gmm(plain.global_gmm, routed.global_gmm)

    def test_fedem_async_policy_runs_buffered(self, split):
        cfg = CPU.replace(init="separated", max_iter=8)
        r = FedEM(3, participation=0.5, cohort="cyclic", config=cfg,
                  async_policy=AsyncPolicy(buffer_size=2, lookahead=4)).run(
            split, seed=7)
        assert dict(r.comm.staleness) and max(dict(r.comm.staleness)) > 0

    def test_fit_federated_named_and_custom(self, split):
        cfg = CPU.replace(init="separated", max_iter=4)
        named = fit_federated(split, strategy="dem", seed=7, config=cfg,
                              k=3, async_policy=AsyncPolicy())
        custom = fit_federated(split, strategy=STRAT, seed=7, max_rounds=4,
                               config=CPU, async_policy=AsyncPolicy())
        assert_same_gmm(named.global_gmm, custom.global_gmm)

    def test_fit_federated_rejects_async_for_one_shot_names(self, split):
        with pytest.raises(TypeError, match="iterative"):
            fit_federated(split, strategy="fedgen", seed=7, k=3,
                          async_policy=AsyncPolicy())
        with pytest.raises(TypeError, match="iterative"):
            fit_federated(split, strategy="fedkmeans", seed=7, k=3,
                          async_policy=AsyncPolicy())
