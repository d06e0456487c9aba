"""The port's CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a card. The file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels.py (see test_torch_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import FitConfig, fit_federated, log_prob
from repro_torch.core import em
from repro_torch.core.dem import DEMStrategy
from repro_torch.core.gmm import GMM
from repro_torch.fed.runtime import SplitClients, run_rounds
from repro_torch.fed.strategies import FedKMeansState, FedKMeansStrategy
from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign
from repro_torch.kernels import ops, ref
from repro_torch.serve import (ModelStore, ScoreConfig, ScoreRequest,
                               ScoringEngine)
from repro_torch.serve import engine as serve_engine

SHAPES = [  # (N, d, K), as tests/test_kernels.py
    (64, 4, 2),
    (256, 24, 30),
    (1000, 11, 15),
    (513, 84, 10),
    (100, 38, 10),
    (2048, 128, 64),
    (17, 3, 1),
]


def make_inputs(rng, n, d, k):
    x = rng.normal(0, 2, (n, d)).astype(np.float32)
    mu = rng.normal(0, 2, (k, d)).astype(np.float32)
    var = rng.uniform(0.05, 3.0, (k, d)).astype(np.float32)
    lw = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    return x, mu, var, lw


def t(a):
    return torch.as_tensor(a)


def assert_assign(idx, d2, x, centers, eidx, ed2):
    """Equal indices wherever the nearest two centers are > 1e-4 apart."""
    np.testing.assert_allclose(d2, ed2, rtol=1e-4, atol=1e-4)
    dist = np.maximum((x * x).sum(1, keepdims=True) - 2 * x @ centers.T
                      + (centers * centers).sum(1)[None], 0)
    part = np.sort(dist, axis=1)
    clear = (part[:, 1] - part[:, 0] > 1e-4) if dist.shape[1] > 1 \
        else np.ones(len(x), bool)
    assert np.all((idx == eidx) | ~clear)


@pytest.mark.cuda
class TestKernelLaunch:
    """The CUDA kernels against their plain versions on the card (run by
    ``python -m pytest -m cuda tests/test_torch_cuda.py`` there)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.mark.parametrize("n,d,k", SHAPES)
    def test_kernels_match_plain(self, n, d, k):
        dev = torch.device("cuda")
        rng = np.random.default_rng(n + k)
        x, mu, var, lw = (t(a).to(dev) for a in make_inputs(rng, n, d, k))
        w = t(rng.uniform(0, 1, (1, n)).astype(np.float32)).to(dev)
        a, b, c = ops.pack_params(mu, var, lw)
        before = gmm_logpdf.launches
        np.testing.assert_allclose(
            gmm_logpdf.gmm_logpdf(x, a, b, c).cpu().numpy(),
            ref.gmm_logpdf_packed(x, a, b, c).cpu().numpy(),
            rtol=2e-4, atol=2e-4)
        assert gmm_logpdf.launches == before + 1
        got = estep_stats.estep_stats(x[None], w, a[None], b[None], c[None])
        again = estep_stats.estep_stats(x[None], w, a[None], b[None],
                                        c[None])
        exp = ref.estep_stats_packed(x[None], w, a[None], b[None], c[None])
        for g, h, e, rtol, atol in zip(got, again, exp,
                                       (1e-3, 1e-3, 1e-3, 1e-4),
                                       (1e-4, 1e-3, 1e-3, 0.0)):
            assert torch.equal(g, h)
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                       rtol=rtol, atol=atol)
        ct = mu.T.contiguous()[None]
        c2 = (mu * mu).sum(-1)[None]
        idx, d2 = kmeans_assign.kmeans_assign(x[None], ct, c2)
        eidx, ed2 = ref.kmeans_assign_packed(x[None], ct, c2)
        assert_assign(idx[0].cpu().numpy(), d2[0].cpu().numpy(),
                      x.cpu().numpy(), mu.cpu().numpy(),
                      eidx[0].cpu().numpy(), ed2[0].cpu().numpy())

    @pytest.mark.parametrize("cl,n,d,k", [
        (1, 30000, 24, 30),      # the refit's E-step
        (2, 64 * 70, 24, 30),    # 64-row tiles, N on a tile edge
        (3, 64 * 70 + 1, 24, 30),
        (1, 3000, 8, 200),       # K > 128: 16 components a thread
    ])
    def test_estep_main_path_shapes_and_tile_edges(self, cl, n, d, k):
        dev = torch.device("cuda")
        rng = np.random.default_rng(n + k)
        x, mu, var, lw = (t(np.stack(a)).to(dev) for a in zip(
            *(make_inputs(rng, n, d, k) for _ in range(cl))))
        w = t(rng.uniform(0, 1, (cl, n)).astype(np.float32)).to(dev)
        a, b, c = ops.pack_params(mu, var, lw)
        before = estep_stats.launches
        got = estep_stats.estep_stats(x, w, a, b, c)
        again = estep_stats.estep_stats(x, w, a, b, c)
        exp = ref.estep_stats_packed(x, w, a, b, c)
        assert estep_stats.launches == before + 2
        for g, h, e, rtol, atol in zip(got, again, exp,
                                       (1e-3, 1e-3, 1e-3, 1e-4),
                                       (1e-4, 1e-3, 1e-3, 0.0)):
            assert torch.equal(g, h)
            np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                       rtol=rtol, atol=atol)

    @pytest.mark.parametrize("bsz,n,d,k", [
        (80, 7320, 24, 30), (4, 16384, 24, 30), (1, 30000, 24, 30),
        (2, 513, 11, 15), (1, 2048, 128, 64), (1, 17, 3, 1), (1, 900, 8, 200),
    ])
    def test_sweep_matches_onehot_formula(self, bsz, n, d, k):
        """Labels equal to the plain assignment wherever the nearest two
        centers are more than 1e-4 apart, ties to the first index, an empty
        cluster, zero-weight rows; counts, sums and inertia within 2e-4 of
        the one-hot formula on the kernel's own labels; the same bits from
        two launches."""
        dev = torch.device("cuda")
        rng = np.random.default_rng(bsz * n + k)
        x = t(rng.normal(0, 2, (bsz, n, d)).astype(np.float32)).to(dev)
        mu = rng.normal(0, 2, (bsz, k, d)).astype(np.float32)
        if k >= 5:
            mu[:, 0] = 1e3
            mu[:, k - 2:] = mu[:, 1:3]
        mu = t(mu).to(dev)
        w = rng.uniform(0, 1, (bsz, n)).astype(np.float32)
        w[:, ::7] = 0.0
        w = t(w).to(dev)
        ct = mu.transpose(-1, -2).contiguous()
        c2 = (mu * mu).sum(-1).contiguous()
        before = kmeans_assign.sweep_launches
        got = kmeans_assign.kmeans_sweep_stats(x, w, ct, c2, with_idx=True)
        again = kmeans_assign.kmeans_sweep_stats(x, w, ct, c2, with_idx=True)
        assert kmeans_assign.sweep_launches == before + 2
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        counts, sums, inertia, idx = (v.cpu() for v in got)
        eidx, ed2 = (v.cpu() for v in ref.kmeans_assign_packed(x, ct, c2))
        xc, wc, muc = x.cpu(), w.cpu(), mu.cpu()
        for i in range(bsz):
            assert_assign(idx[i].numpy(), ed2[i].numpy(), xc[i].numpy(),
                          muc[i].numpy(), eidx[i].numpy(), ed2[i].numpy())
        if k >= 5:
            assert int(idx.max()) < k - 2 and bool((counts[:, 0] == 0).all())
        oh = (idx.long().unsqueeze(-1) == torch.arange(k)).float() \
            * wc.unsqueeze(-1)
        dist = torch.clamp((xc * xc).sum(-1, keepdim=True)
                           - 2.0 * (xc @ ct.cpu()) + c2.cpu().unsqueeze(-2),
                           min=0.0)
        d2 = torch.gather(dist, -1, idx.long().unsqueeze(-1)).squeeze(-1)
        for g, e in ((counts, oh.sum(-2)), (sums, oh.transpose(-1, -2) @ xc),
                     (inertia, (d2 * wc).sum(-1))):
            np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=2e-4,
                                       atol=2e-4)

    @pytest.mark.parametrize("n,d,k", SHAPES + [
        (700, 24, 64),    # two 32-component chunks merged
        (700, 24, 100),   # four, the last of 4
        (300, 128, 100),  # d = 128: 96 dims from shared memory
        (1, 24, 30),      # one row
        (300, 128, 512),  # panels staged 160 components at a time
        (257, 600, 40),   # 16 at a time
    ])
    def test_log_prob_matches_plain(self, n, d, k):
        """Both entries of csrc/gmm_logpdf.cu against their plain versions;
        one launch counted a call; two launches give the same bits."""
        dev = torch.device("cuda")
        rng = np.random.default_rng(3 * n + k)
        x, mu, var, lw = (t(a).to(dev) for a in make_inputs(rng, n, d, k))
        a, b, c = ops.pack_params(mu, var, lw)
        before = (gmm_logpdf.launches, gmm_logpdf.log_prob_launches)
        lp = gmm_logpdf.gmm_logpdf(x, a, b, c)
        got = gmm_logpdf.gmm_log_prob(x, a, b, c)
        again = gmm_logpdf.gmm_log_prob(x, a, b, c)
        assert (gmm_logpdf.launches, gmm_logpdf.log_prob_launches) == (
            before[0] + 1, before[1] + 2)
        assert got.shape == (n,) and torch.equal(got, again)
        np.testing.assert_allclose(
            lp.cpu().numpy(), ref.gmm_logpdf_packed(x, a, b, c).cpu().numpy(),
            rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(
            got.cpu().numpy(),
            ref.gmm_log_prob_packed(x, a, b, c).cpu().numpy(),
            rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("k", [30, 100])
    def test_log_prob_rows_are_stable(self, k):
        """A row's fused log density has the same bits scored alone, in
        128-row requests, inside one 60,000-row call, and through
        ``log_prob_chunked`` at chunk 4096 (a ragged last chunk) and None;
        at K = 100 across merged 32-component chunks too."""
        dev = torch.device("cuda")
        rng = np.random.default_rng(60000 + k)
        x, mu, var, lw = (t(a).to(dev)
                          for a in make_inputs(rng, 60000, 24, k))
        g = GMM(torch.exp(lw), mu, var)
        full = ops.gmm_log_prob(x, g.means, g.covs, torch.log(g.weights))
        requests = torch.cat([
            ops.gmm_log_prob(x[i:i + 128], g.means, g.covs,
                             torch.log(g.weights))
            for i in range(0, 60000, 128)])
        assert torch.equal(requests, full)
        for i in [0, 1, 127, 128, 255, 256, 59999] + list(
                rng.integers(0, 60000, 20)):
            alone = ops.gmm_log_prob(x[i:i + 1], g.means, g.covs,
                                     torch.log(g.weights))
            assert torch.equal(alone, full[i:i + 1])
        for chunk in (None, 4096):
            assert torch.equal(
                em.log_prob_chunked(g, x, chunk, backend="fused"), full)

    def test_dem_round_matches_reference(self):
        """One DEM round at the main path's width (20 padded clients of
        7,320 rows, d = 24, K = 30): on the fused backend one
        ``estep_stats`` launch for all clients against the broadcast model,
        within 2e-4 of the reference round from the same model."""
        dev = torch.device("cuda")
        rng = np.random.default_rng(14)
        c, n, d, k = 20, 7320, 24, 30
        mu = rng.normal(0, 3, (k, d))
        var = rng.uniform(0.2, 1.0, (k, d))
        lab = rng.integers(0, k, (c, n))
        x = mu[lab] + rng.normal(0, 1, (c, n, d)) * np.sqrt(var[lab])
        sizes = rng.integers(900, n + 1, c)
        mask = (np.arange(n)[None] < sizes[:, None]).astype(np.float32)
        clients = SplitClients(t((x * mask[..., None]).astype(np.float32))
                               .to(dev), t(mask).to(dev), sizes)
        g0 = GMM(torch.full((k,), 1.0 / k, device=dev),
                 t((mu + rng.normal(0, 0.3, mu.shape)).astype(np.float32))
                 .to(dev), torch.ones(k, d, device=dev))
        res, launches = {}, {}
        for backend in ("fused", "reference"):
            strat = DEMStrategy(k=k, init="separated", backend=backend)
            before = estep_stats.launches
            res[backend] = run_rounds(strat, clients, device=dev,
                                      state0=strat.state_from_gmm(g0),
                                      max_rounds=1)
            launches[backend] = estep_stats.launches - before
        assert launches == {"fused": 1, "reference": 0}
        got, exp = res["fused"], res["reference"]
        assert got.n_rounds == exp.n_rounds == 1
        assert abs(float(got.log_likelihood)
                   - float(exp.log_likelihood)) <= 2e-4
        for a, b in zip((got.global_gmm.weights, got.global_gmm.means,
                         got.global_gmm.covs),
                        (exp.global_gmm.weights, exp.global_gmm.means,
                         exp.global_gmm.covs)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=2e-4, atol=2e-4)

    def test_fedkmeans_strategy_launches_the_sweep(self):
        """A ``FedKMeansStrategy`` built directly, with its default
        backend, runs each round and the rescore as one
        ``kmeans_sweep_stats`` launch, and from injected centers ends
        within 2e-4 of the reference strategy, which launches none. Through
        ``fit_federated`` it launches the sweep too."""
        dev = torch.device("cuda")
        rng = np.random.default_rng(3)
        c, n, d, k = 4, 600, 6, 5
        mu = rng.normal(0, 4, (k, d))
        x = (mu[rng.integers(0, k, (c, n))]
             + rng.normal(0, 0.5, (c, n, d))).astype(np.float32)
        sizes = np.array([600, 450, 300, 520])
        mask = (np.arange(n)[None] < sizes[:, None]).astype(np.float32)
        clients = SplitClients(t(x * mask[..., None]).to(dev),
                               t(mask).to(dev), sizes)
        c0 = t((mu + rng.normal(0, 0.5, mu.shape)).astype(np.float32)).to(dev)
        inf = torch.tensor(float("inf"), device=dev)
        res, launches = {}, {}
        for name, strat in (("auto", FedKMeansStrategy(k=k)),
                            ("reference", FedKMeansStrategy(
                                k=k, assign_backend="reference"))):
            before = kmeans_assign.sweep_launches
            res[name] = run_rounds(strat, clients, device=dev, max_rounds=50,
                                   state0=FedKMeansState(c0, inf, inf, 1e-4))
            launches[name] = kmeans_assign.sweep_launches - before
        assert launches == {"auto": res["auto"].n_rounds + 1,
                            "reference": 0}
        assert res["auto"].n_rounds == res["reference"].n_rounds
        np.testing.assert_allclose(res["auto"].centers.cpu().numpy(),
                                   res["reference"].centers.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
        before = kmeans_assign.sweep_launches
        fit_federated(clients, strategy=FedKMeansStrategy(k=k), seed=0,
                      config=FitConfig(device="cuda"), max_rounds=50)
        assert kmeans_assign.sweep_launches > before

    def test_wrapper_rejects_bad_operands(self):
        with pytest.raises(ValueError):  # K beyond the E-step's 512
            z = torch.zeros(1, 8, 4, device="cuda")
            big = torch.zeros(1, 4, 513, device="cuda")
            estep_stats.estep_stats(z, z[..., 0], big, big,
                                    torch.zeros(1, 513, device="cuda"))
        x = torch.zeros(8, 4, device="cuda")
        a = torch.zeros(4, 3, device="cuda")
        with pytest.raises(ValueError):
            gmm_logpdf.gmm_logpdf(x, a, a, torch.zeros(2, device="cuda"))
        with pytest.raises(ValueError):
            gmm_logpdf.gmm_logpdf(x.double(), a, a,
                                  torch.zeros(3, device="cuda"))
        with pytest.raises(ValueError):
            gmm_logpdf.gmm_log_prob(x, a, a, torch.zeros(2, device="cuda"))


def serving_model(rng, k, d):
    """A diagonal model of k components in d dimensions, as numpy arrays."""
    return (rng.dirichlet(np.ones(k)).astype(np.float32),
            rng.normal(0, 2, (k, d)).astype(np.float32),
            rng.uniform(0.2, 2.0, (k, d)).astype(np.float32))


def device_logpdf_launches(fn) -> int:
    """Launches of the log-density kernel (either entry) that
    ``torch.profiler`` sees on the device while ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "logpdf_kernel" in ev.name)


@pytest.mark.cuda
class TestServingOnCard:
    """The serving engine on the card: one CUDA graph captured per model
    install, one replay per micro-batch that runs the kernel once on the
    device and calls no launch wrapper, replayed results equal to the eager
    step and to ``api.log_prob`` bit for bit."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the engine captures CUDA graphs "
                        "of the kernels, which have no CPU mode")

    def test_one_capture_per_install_and_one_replay_per_step(self):
        rng = np.random.default_rng(40)
        g_a = GMM(*(t(a).cuda() for a in serving_model(rng, 30, 24)))
        g_b = GMM(*(t(a).cuda() for a in serving_model(rng, 30, 24)))
        reqs = [ScoreRequest(i, rng.normal(0, 2, (n, 24)))
                for i, n in enumerate((16, 3000, 200, 512, 64, 1, 0, 700))]
        captures = serve_engine.captures
        eng = ScoringEngine(g_a, ScoreConfig(mode="anomaly", slots=3,
                                             rows_per_slot=256), version=1)
        assert serve_engine.captures == captures + 1
        assert eng.graph is not None and eng.backend == "fused"
        for req in reqs:
            eng.submit(req)
        results, steps = [], 0

        def serve():
            nonlocal results, steps
            while eng.pending_requests:
                before = (gmm_logpdf.log_prob_launches, eng.replays)
                results += eng.step()
                steps += 1
                assert (gmm_logpdf.log_prob_launches, eng.replays) == (
                    before[0], before[1] + 1)
        assert device_logpdf_launches(serve) == steps
        assert serve_engine.captures == captures + 1
        assert torch.equal(eng._out, eng._score())  # replay == eager
        cfg = FitConfig(backend="fused")
        for res in results:
            rows = reqs[res.rid].rows
            if len(rows):
                want = -log_prob(g_a, rows, cfg).cpu().numpy()
                np.testing.assert_array_equal(res.scores, want)
        eng.install(g_b, 2)
        assert serve_engine.captures == captures + 2 and eng.version == 2

    def test_responsibilities_launch_gmm_logpdf(self):
        rng = np.random.default_rng(41)
        w, mu, var = serving_model(rng, 30, 24)
        g = GMM(t(w).cuda(), t(mu).cuda(), t(var).cuda())
        eng = ScoringEngine(g, ScoreConfig(mode="responsibilities", slots=2,
                                           rows_per_slot=128))
        reqs = [ScoreRequest(i, rng.normal(0, 2, (n, 24)))
                for i, n in enumerate((300, 5, 0))]
        for req in reqs:
            eng.submit(req)
        results, steps = [], 0

        def serve():
            nonlocal results, steps
            while eng.pending_requests:
                before = (gmm_logpdf.launches, eng.replays)
                results += eng.step()
                steps += 1
                assert (gmm_logpdf.launches, eng.replays) == (
                    before[0], before[1] + 1)
        assert device_logpdf_launches(serve) == steps
        for res in results:
            rows = reqs[res.rid].rows
            assert res.scores.shape == (len(rows), 30)
            if len(rows):
                want = g.responsibilities(t(rows.astype(np.float32)).cuda())
                np.testing.assert_allclose(res.scores, want.cpu().numpy(),
                                           atol=1e-5)
                np.testing.assert_allclose(res.scores.sum(1), 1.0,
                                           atol=1e-5)

    def test_store_restores_onto_the_card(self, tmp_path):
        rng = np.random.default_rng(42)
        w, mu, var = serving_model(rng, 4, 6)
        ModelStore(tmp_path).publish(GMM(t(w), t(mu), t(var)))
        published = ModelStore(tmp_path).latest()
        assert published.gmm.means.device.type == "cuda"
        np.testing.assert_array_equal(published.gmm.covs.cpu().numpy(), var)


@pytest.mark.cuda
class TestOutOfCoreOnCard:
    """The out-of-core path on the card: the pinned copy-stream prefetch
    gives the inline loop's bits, every source engine launches its kernel
    once a block, and a large synthetic fit holds no O(N) tensor."""

    CHUNK = 4096

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    @pytest.fixture
    def rows_file(self, tmp_path):
        rng = np.random.default_rng(3)
        x = (rng.normal(0, 1, (20_000, 24))
             + rng.integers(0, 3, (20_000, 1)) * 4.0).astype(np.float32)
        np.save(tmp_path / "rows.npy", x)
        return tmp_path / "rows.npy", x

    @staticmethod
    def _model(x, k=5):
        mu = torch.as_tensor(x[:k], device="cuda")
        var = torch.as_tensor(np.tile(x.var(0), (k, 1)), device="cuda")
        return GMM(torch.full((k,), 1.0 / k, device="cuda"), mu, var)

    def test_prefetch_depths_give_the_same_blocks_and_fits(self, rows_file,
                                                           monkeypatch):
        from repro_torch.data import sources
        from repro_torch.data.sources import (NpyFileSource,
                                              SyntheticGMMSource,
                                              prefetch_blocks)
        path, x = rows_file
        g0 = self._model(x)
        for src in (NpyFileSource(path), SyntheticGMMSource(
                g0, 50_000, seed=1, cache_rows=0)):
            pairs = {d: [(b.clone(), m.clone()) for b, m in prefetch_blocks(
                src, self.CHUNK, depth=d, device="cuda")] for d in (0, 2)}
            assert len(pairs[0]) == len(pairs[2]) == src.num_blocks(
                self.CHUNK)
            for (b0, m0), (b2, m2) in zip(pairs[0], pairs[2]):
                assert b0.is_cuda and b2.is_cuda
                assert torch.equal(b0, b2) and torch.equal(m0, m2)
            fits = {}
            for depth in (0, 2):
                monkeypatch.setattr(sources, "PREFETCH_DEPTH", depth)
                fits[depth] = em.fit_gmm_cfg(
                    0, src, 5, FitConfig(chunk_size=self.CHUNK, max_iter=8,
                                         tol=0.0), init_gmm=g0)
            for a, b in zip((fits[0].gmm.weights, fits[0].gmm.means,
                             fits[0].gmm.covs, fits[0].log_likelihood),
                            (fits[2].gmm.weights, fits[2].gmm.means,
                             fits[2].gmm.covs, fits[2].log_likelihood)):
                assert torch.equal(a, b)

    def test_source_engines_launch_their_kernels(self, rows_file):
        from repro_torch.core import kmeans
        from repro_torch.data.sources import NpyFileSource
        path, x = rows_file
        src = NpyFileSource(path)
        blocks = src.num_blocks(self.CHUNK)
        g0 = self._model(x)

        def launched(fn):
            before = (estep_stats.launches, kmeans_assign.sweep_launches,
                      kmeans_assign.launches, gmm_logpdf.log_prob_launches)
            fn()
            torch.cuda.synchronize()
            after = (estep_stats.launches, kmeans_assign.sweep_launches,
                     kmeans_assign.launches, gmm_logpdf.log_prob_launches)
            return tuple(a - b for a, b in zip(after, before))

        assert launched(lambda: em.e_step_stats(
            g0, src, chunk_size=self.CHUNK)) == (blocks, 0, 0, 0)
        assert launched(lambda: kmeans.lloyd_round_stats(
            g0.means, src, chunk_size=self.CHUNK)) == (0, blocks, 0, 0)
        assert launched(lambda: em.score_streaming(
            g0, src, chunk_size=self.CHUNK)) == (0, 0, 0, blocks)
        est, sweep, assign, _ = launched(lambda: em.init_from_kmeans(
            0, src, 5, chunk_size=self.CHUNK))
        assert (est, assign) == (0, blocks) and sweep > blocks

    def test_a_2_20_row_synthetic_fit_holds_no_o_n_tensor(self):
        """Every tensor the fit creates is at most 4 blocks long, and the
        peak memory above the start stays under 64 blocks' worth."""
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.api import GMMEstimator
        from repro_torch.data.sources import SyntheticGMMSource

        chunk = 65536

        class NoLargeTensors(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in (out if isinstance(out, (list, tuple)) else (out,)):
                    if isinstance(t, torch.Tensor) and t.ndim:
                        assert max(t.shape) <= 4 * chunk, (func, t.shape)
                return out

        truth = GMM(torch.tensor([0.4, 0.6], device="cuda"),
                    torch.tensor([[-4.0] * 8, [4.0] * 8], device="cuda"),
                    torch.full((2, 8), 0.3, device="cuda"))
        src = SyntheticGMMSource(truth, 1 << 20, seed=2)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with NoLargeTensors():
            res = GMMEstimator(2, chunk_size=chunk, max_iter=5).fit(
                src, seed=0).result_
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert peak < 64 * chunk * 8 * 4, peak
        got = np.sort(res.gmm.means[:, 0].cpu().numpy())
        np.testing.assert_allclose(got, [-4.0, 4.0], atol=0.1)
