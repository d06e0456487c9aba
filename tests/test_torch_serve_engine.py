"""The port's serving engine (``repro_torch.serve``, ``repro_torch.api.Scorer``)
against its contract, class by class as tests/test_serve_engine.py, on the
CPU at d = 5 with the same request sizes.

The models are the JAX package's fits, carried across as numpy arrays
(``convert.gmm_from_numpy``), so the two packages serve the same model.
Tolerances:

- engine against the port's ``api.log_prob``: the same bits, both on
  ``backend="fused"`` (on the CPU the kernels' plain versions, through the
  same packing; a row's packed log density does not depend on its peers);
- engine against the JAX package's ``repro.api.log_prob`` on the same
  numpy model: rtol and atol 2e-4, as tests/test_torch_logprob.py;
- responsibilities against the port's ``GMM.responsibilities``: atol 1e-6
  on the reference backend (as tests/test_serve_engine.py), 1e-5 on the
  fused one, whose per-component densities come from the packed identity
  ``x²@A + x@B + c`` rather than ``GMM``'s own arrangement of the same
  terms (1.2e-6 apart at these inputs); against the JAX package's
  ``GMM.responsibilities``: atol 1e-5; rows sum to 1 within 1e-5;
- ``backend="reference"`` on the CPU is not row-stable: ``GMM.log_prob``
  over a 64-row slab rounds a row of a 5-row request otherwise than over
  the request alone (the port's counterpart of ROADMAP Queue C, R1). It is
  held to rtol 1e-6 and atol 1e-5 against ``api.log_prob`` there.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import GMMEstimator as JaxGMMEstimator
from repro.api import log_prob as jax_log_prob
from repro_torch.api import FitConfig, Scorer, log_prob
from repro_torch.checkpoint import (latest_version, load_checkpoint,
                                    load_published, publish_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import gmm_from_numpy
from repro_torch.core.gmm import GMM
from repro_torch.kernels import ops
from repro_torch.serve import (ModelStore, ScoreConfig, ScoreRequest,
                               ScoringEngine, SlotPool)
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.slots import InFlight

DIM = 5
FUSED = FitConfig(backend="fused", device="cpu")


def cfg(**kw) -> ScoreConfig:
    """A CPU engine config on the fused route unless ``kw`` says otherwise."""
    kw.setdefault("backend", "fused")
    return ScoreConfig(device="cpu", **kw)


def api_lp(gmm, rows) -> np.ndarray:
    return log_prob(gmm, rows, FUSED).numpy()


def to_port(jax_gmm) -> GMM:
    return gmm_from_numpy(np.array(jax_gmm.weights), np.array(jax_gmm.means),
                          np.array(jax_gmm.covs), device="cpu")


@pytest.fixture(scope="module")
def fitted():
    """Two distinct fitted models over the same feature space (the swap's
    before and after), as port models and as the JAX package's, plus a
    held-out scoring stream."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(m, 1.0, (400, DIM))
                        for m in (0.0, 5.0, 9.0)]).astype(np.float32)
    jax_a = JaxGMMEstimator(k=3, seed=0).fit(x).gmm_
    jax_b = JaxGMMEstimator(k=3, seed=7).fit(x[::2] + 0.25).gmm_
    return to_port(jax_a), to_port(jax_b), x, jax_a, jax_b


def _requests(rng, sizes):
    return [ScoreRequest(i, rng.normal(2.0, 3.0, (n, DIM)))
            for i, n in enumerate(sizes)]


# ----------------------------------------------------------------------
# Correctness: engine scores == api scores, bit for bit
# ----------------------------------------------------------------------

class TestEngineScores:
    # 130/700 stream across micro-batches (> rows_per_slot), 64 fills a
    # slot exactly, 1 and 5 pad, 0 never occupies a slot.
    SIZES = (130, 5, 64, 700, 1, 0)

    def test_bit_identical_to_api_log_prob(self, fitted):
        gmm, _, _, _, _ = fitted
        reqs = _requests(np.random.default_rng(11), self.SIZES)
        eng = ScoringEngine(gmm, cfg(slots=3, rows_per_slot=64))
        got = {r.rid: r for r in eng.run(reqs)}
        assert len(got) == len(reqs)
        for req in reqs:
            res = got[req.rid]
            assert res.scores.shape == (req.num_rows,)
            assert res.scores.dtype == np.float32
            if req.num_rows:
                np.testing.assert_array_equal(res.scores,
                                              api_lp(gmm, req.rows))

    def test_within_tolerance_of_jax_log_prob(self, fitted):
        gmm, _, _, jax_gmm, _ = fitted
        reqs = _requests(np.random.default_rng(11), self.SIZES)
        for backend in ("fused", "reference"):
            eng = ScoringEngine(gmm, cfg(slots=3, rows_per_slot=64,
                                         backend=backend))
            for res in eng.run(reqs):
                rows = reqs[res.rid].rows
                if len(rows):
                    np.testing.assert_allclose(
                        res.scores, np.asarray(jax_log_prob(jax_gmm, rows)),
                        rtol=2e-4, atol=2e-4)

    def test_slot_geometry_invariant(self, fitted):
        """Scores cannot depend on pool geometry: (3 slots x 64 rows) and
        (1 slot x 256 rows) give the same bits."""
        gmm, _, _, _, _ = fitted
        reqs = _requests(np.random.default_rng(12), self.SIZES)
        a = {r.rid: r.scores for r in ScoringEngine(
            gmm, cfg(slots=3, rows_per_slot=64)).run(reqs)}
        b = {r.rid: r.scores for r in ScoringEngine(
            gmm, cfg(slots=1, rows_per_slot=256)).run(reqs)}
        for rid in a:
            np.testing.assert_array_equal(a[rid], b[rid])

    def test_anomaly_is_negated_log_prob(self, fitted):
        gmm, _, _, _, _ = fitted
        reqs = _requests(np.random.default_rng(13), (40, 3))
        eng = ScoringEngine(gmm, cfg(mode="anomaly", slots=2,
                                     rows_per_slot=32))
        for res in eng.run(reqs):
            np.testing.assert_array_equal(
                res.scores, -api_lp(gmm, reqs[res.rid].rows))

    @pytest.mark.parametrize("backend,atol", [("reference", 1e-6),
                                              ("fused", 1e-5)])
    def test_responsibilities_mode(self, fitted, backend, atol):
        gmm, _, _, jax_gmm, _ = fitted
        reqs = _requests(np.random.default_rng(14), (70, 0, 9))
        eng = ScoringEngine(gmm, cfg(mode="responsibilities", slots=2,
                                     rows_per_slot=32, backend=backend))
        for res in eng.run(reqs):
            rows = reqs[res.rid].rows
            assert res.scores.shape == (len(rows), 3)
            if len(rows):
                ref = gmm.responsibilities(torch.as_tensor(rows)).numpy()
                np.testing.assert_allclose(res.scores, ref, atol=atol)
                np.testing.assert_allclose(
                    res.scores, np.asarray(jax_gmm.responsibilities(
                        jnp.asarray(rows))), atol=1e-5)
                np.testing.assert_allclose(res.scores.sum(axis=1), 1.0,
                                           atol=1e-5)

    def test_reference_backend_is_not_row_stable(self, fitted):
        """On the CPU the reference route scores a slab, and ``GMM.log_prob``
        over 64 rows need not round a row as over a 1- or 5-row request: it
        is held to a tolerance where the fused route keeps the bits."""
        gmm, _, _, _, _ = fitted
        reqs = _requests(np.random.default_rng(11), self.SIZES)
        ref_cfg = FitConfig(backend="reference", device="cpu")
        eng = ScoringEngine(gmm, cfg(slots=3, rows_per_slot=64,
                                     backend="reference"))
        fused = {r.rid: r.scores for r in ScoringEngine(
            gmm, cfg(slots=3, rows_per_slot=64)).run(reqs)}
        for res in eng.run(reqs):
            rows = reqs[res.rid].rows
            if len(rows) in (1, 5):
                np.testing.assert_allclose(
                    res.scores, log_prob(gmm, rows, ref_cfg).numpy(),
                    rtol=1e-6, atol=1e-5)
                np.testing.assert_array_equal(fused[res.rid],
                                              api_lp(gmm, rows))

    def test_continuous_admission_mid_flight(self, fitted):
        """A request submitted while another streams through its slot is
        admitted into a free slot at once: no lockstep waves."""
        gmm, _, _, _, _ = fitted
        eng = ScoringEngine(gmm, cfg(slots=2, rows_per_slot=16))
        rng = np.random.default_rng(15)
        long = ScoreRequest(0, rng.normal(size=(100, DIM)))  # 7 steps
        eng.submit(long)
        eng.step()
        late = ScoreRequest(1, rng.normal(size=(8, DIM)))
        eng.submit(late)
        finished = eng.step()  # late rides the free slot this very step
        assert [r.rid for r in finished] == [1]
        (rest,) = eng.drain()
        assert rest.rid == 0 and rest.scores.shape == (100,)

    def test_packs_once_per_install(self, fitted, monkeypatch):
        """The model is packed at install only: admitting, streaming and
        retiring requests runs no packing, and on the CPU no graph is
        captured (the counterpart of the JAX package's single compile)."""
        gmm, gmm_b, _, _, _ = fitted
        calls = []
        pack = ops.pack_params
        monkeypatch.setattr(ops, "pack_params",
                            lambda *a: calls.append(1) or pack(*a))
        captures = engine_mod.captures
        eng = ScoringEngine(gmm, cfg(slots=2, rows_per_slot=32))
        assert len(calls) == 1 and eng.graph is None
        eng.run(_requests(np.random.default_rng(16), (100, 10, 33, 1)))
        eng.run(_requests(np.random.default_rng(17), (64, 2, 90)))
        assert len(calls) == 1
        eng.install(gmm_b, 2)
        eng.run(_requests(np.random.default_rng(18), (40,)))
        assert len(calls) == 2 and engine_mod.captures == captures
        ref = ScoringEngine(gmm, cfg(backend="reference"))
        ref.run(_requests(np.random.default_rng(19), (40,)))
        assert len(calls) == 2

    def test_submit_validates(self, fitted):
        gmm, _, _, _, _ = fitted
        eng = ScoringEngine(gmm, cfg())
        with pytest.raises(TypeError, match="ScoreRequest"):
            eng.submit(np.zeros((3, DIM)))
        with pytest.raises(ValueError, match="dim"):
            eng.submit(ScoreRequest(0, np.zeros((3, DIM + 1))))

    def test_config_validation(self):
        with pytest.raises(ValueError, match="mode"):
            ScoreConfig(mode="density")
        with pytest.raises(ValueError, match="backend"):
            ScoreConfig(backend="pallas")
        with pytest.raises(ValueError, match="slots"):
            ScoreConfig(slots=0)
        with pytest.raises(ValueError, match="device"):
            ScoreConfig(device="tpu")
        with pytest.raises(ValueError, match="rows must be"):
            ScoreRequest(0, np.zeros(DIM))
        assert ScoreConfig().device == "cuda"

    def test_engine_defaults_to_the_card(self, fitted):
        """Without ``device="cpu"`` the engine runs on CUDA, and raises where
        there is none rather than serving from the CPU."""
        gmm, _, _, _, _ = fitted
        if torch.cuda.is_available():
            assert ScoringEngine(gmm).gmm.device.type == "cuda"
            return
        with pytest.raises(RuntimeError, match="cuda"):
            ScoringEngine(gmm)
        with pytest.raises(RuntimeError, match="cuda"):
            Scorer(gmm)


# ----------------------------------------------------------------------
# Hot swap: drain-and-install
# ----------------------------------------------------------------------

class TestHotSwap:
    def test_idle_swap_is_immediate(self, fitted):
        gmm_a, gmm_b, _, _, _ = fitted
        eng = ScoringEngine(gmm_a, cfg(), version=1)
        eng.install(gmm_b, 2)
        assert eng.version == 2 and not eng.swap_pending
        assert eng.swaps == 1

    def test_swap_boundary_exact(self, fitted):
        """Mid-stream: every result has the bits of a single-model engine
        holding its tagged version (and of ``api.log_prob`` under it), the
        tag flips at exactly one admission boundary, and no request is
        lost."""
        gmm_a, gmm_b, _, _, _ = fitted
        rng = np.random.default_rng(21)
        sizes = (50, 40, 33, 20, 10, 7, 64, 1)
        reqs = _requests(rng, sizes)
        config = cfg(slots=2, rows_per_slot=16)

        eng = ScoringEngine(gmm_a, config, version=1)
        for req in reqs[:4]:
            eng.submit(req)
        results = eng.step()          # slots busy, cursors mid-request
        eng.install(gmm_b, 2)         # swap lands mid-flight
        assert eng.swap_pending
        for req in reqs[4:]:
            eng.submit(req)           # queued behind the drain
        results += eng.drain()
        assert not eng.swap_pending and eng.version == 2
        assert eng.swaps == 1 and len(eng.swap_pauses) == 1

        assert sorted(r.rid for r in results) == list(range(len(reqs)))
        by_rid = {r.rid: r for r in results}
        models = {1: gmm_a, 2: gmm_b}
        ref = {v: {r.rid: r.scores for r in ScoringEngine(
                   g, config, version=v).run(reqs)}
               for v, g in models.items()}
        for rid, res in by_rid.items():
            np.testing.assert_array_equal(res.scores,
                                          ref[res.model_version][rid])
            np.testing.assert_array_equal(
                res.scores, api_lp(models[res.model_version],
                                   reqs[rid].rows))

        versions = [by_rid[rid].model_version for rid in range(len(reqs))]
        assert versions == sorted(versions)       # 1...1 then 2...2
        assert set(versions) == {1, 2}
        # the two slots' occupants at the install stay on the old model
        assert versions[:2] == [1, 1] and versions[2:] == [2] * 6

    def test_admission_stalls_only_while_draining(self, fitted):
        gmm_a, gmm_b, _, _, _ = fitted
        eng = ScoringEngine(gmm_a, cfg(slots=1, rows_per_slot=8), version=1)
        rng = np.random.default_rng(22)
        eng.submit(ScoreRequest(0, rng.normal(size=(24, DIM))))
        eng.step()
        eng.install(gmm_b, 2)
        eng.submit(ScoreRequest(1, rng.normal(size=(4, DIM))))
        stalled = eng.step()          # old request still draining
        assert [r.rid for r in stalled] == []
        assert eng.queued == 1 and eng.swap_pending
        rest = eng.drain()
        assert [r.model_version for r in rest] == [1, 2]
        assert eng.swap_pauses[0] >= 0.0

    def test_latest_wins_while_pending(self, fitted):
        gmm_a, gmm_b, _, _, _ = fitted
        eng = ScoringEngine(gmm_a, cfg(slots=1, rows_per_slot=4), version=1)
        eng.submit(ScoreRequest(0, np.zeros((9, DIM), np.float32)))
        eng.step()
        eng.install(gmm_b, 2)
        eng.install(gmm_a, 3)         # replaces the pending install
        eng.drain()
        assert eng.version == 3 and eng.swaps == 1

    def test_swap_rejects_dim_change(self, fitted):
        gmm_a, _, _, _, _ = fitted
        other = GMM(torch.ones(2) / 2, torch.zeros(2, DIM + 1),
                    torch.ones(2, DIM + 1))
        eng = ScoringEngine(gmm_a, cfg())
        with pytest.raises(ValueError, match="feature"):
            eng.install(other, 2)

    def test_full_covariance_model_runs_the_reference(self, fitted):
        """A full-covariance model has no kernel: "auto" and "fused" both
        resolve to the reference route for it, which scores within f32
        rounding of ``GMM.log_prob``."""
        gmm_a, _, _, _, _ = fitted
        full = GMM(gmm_a.weights, gmm_a.means, torch.diag_embed(gmm_a.covs))
        rows = np.random.default_rng(23).normal(size=(20, DIM))
        eng = ScoringEngine(gmm_a, cfg(slots=2, rows_per_slot=16))
        assert eng.backend == "fused"
        eng.install(full, 2)
        assert eng.backend == "reference"
        (res,) = eng.run([ScoreRequest(0, rows)])
        np.testing.assert_allclose(
            res.scores, full.log_prob(torch.as_tensor(rows,
                                                      dtype=torch.float32)),
            rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------------------
# ModelStore: versioned publish/subscribe
# ----------------------------------------------------------------------

def _leaves(g: GMM):
    return [t.numpy() for t in (g.weights, g.means, g.covs)]


class TestModelStore:
    def test_publish_poll_roundtrip(self, fitted, tmp_path):
        gmm_a, _, _, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        assert store.latest() is None and store.poll() is None
        v = store.publish(gmm_a, {"round": 0})
        assert v == 1 and store.latest_version() == 1
        published = store.poll()
        assert published.version == 1
        assert published.metadata["round"] == 0
        for got, want in zip(_leaves(published.gmm), _leaves(gmm_a)):
            np.testing.assert_array_equal(got, want)
        assert store.poll() is None   # seen: fires once

    def test_poll_jumps_to_latest(self, fitted, tmp_path):
        gmm_a, gmm_b, _, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        store.publish(gmm_a)
        store.publish(gmm_b)
        store.publish(gmm_a)
        assert store.poll().version == 3  # intermediates skipped
        assert store.poll() is None

    def test_subscriber_cursors_are_independent(self, fitted, tmp_path):
        gmm_a, _, _, _, _ = fitted
        pub = ModelStore(tmp_path, device="cpu")
        sub = ModelStore(tmp_path, device="cpu")
        pub.publish(gmm_a)
        assert pub.poll() is not None
        assert sub.poll() is not None  # its own cursor

    def test_load_errors(self, fitted, tmp_path):
        gmm_a, _, _, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        with pytest.raises(FileNotFoundError):
            store.load(None)
        store.publish(gmm_a)
        with pytest.raises(ValueError, match="never published"):
            store.load(5)
        with pytest.raises(TypeError, match="GMM"):
            store.publish(np.zeros(3))

    def test_engine_follows_store(self, fitted, tmp_path):
        """Publish round 1, serve, publish round 2 mid-stream: the engine
        hot-swaps and tags results correctly."""
        gmm_a, gmm_b, _, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        store.publish(gmm_a)
        eng = ScoringEngine.from_store(
            ModelStore(tmp_path, device="cpu"), cfg(slots=1, rows_per_slot=8))
        assert eng.version == 1
        rng = np.random.default_rng(31)
        rows0 = rng.normal(size=(20, DIM)).astype(np.float32)
        rows1 = rng.normal(size=(4, DIM)).astype(np.float32)
        eng.submit(ScoreRequest(0, rows0))
        eng.step()
        store.publish(gmm_b)          # a new round lands mid-request
        eng.submit(ScoreRequest(1, rows1))
        results = {r.rid: r for r in eng.drain()}
        assert results[0].model_version == 1
        assert results[1].model_version == 2
        np.testing.assert_array_equal(results[0].scores, api_lp(gmm_a, rows0))
        np.testing.assert_array_equal(results[1].scores, api_lp(gmm_b, rows1))

    def test_from_store_empty_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no published"):
            ScoringEngine.from_store(ModelStore(tmp_path, device="cpu"))


# ----------------------------------------------------------------------
# Scorer facade
# ----------------------------------------------------------------------

class TestScorerFacade:
    def test_from_checkpoint_and_follow(self, fitted, tmp_path):
        gmm_a, gmm_b, x, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        store.publish(gmm_a)
        scorer = Scorer.from_checkpoint(tmp_path, "anomaly", slots=2,
                                        backend="fused", device="cpu")
        assert scorer.model_version == 1
        np.testing.assert_array_equal(scorer.score(x[:33]),
                                      -api_lp(gmm_a, x[:33]))
        store.publish(gmm_b)          # next batch served by round 2
        got2 = scorer.score(x[:33])
        assert scorer.model_version == 2
        np.testing.assert_array_equal(got2, -api_lp(gmm_b, x[:33]))
        assert scorer.gmm.device.type == "cpu"
        assert scorer.engine.config.device == "cpu"

    def test_pinned_version_never_follows(self, fitted, tmp_path):
        gmm_a, gmm_b, x, _, _ = fitted
        store = ModelStore(tmp_path, device="cpu")
        store.publish(gmm_a)
        store.publish(gmm_b)
        scorer = Scorer.from_checkpoint(tmp_path, version=1, device="cpu")
        store.publish(gmm_b)
        scorer.score(x[:5])
        assert scorer.model_version == 1

    def test_empty_store_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no published"):
            Scorer.from_checkpoint(tmp_path, device="cpu")


# ----------------------------------------------------------------------
# Checkpoint store: loader errors, dtype round trip, atomicity
# ----------------------------------------------------------------------

class TestCheckpointStore:
    def test_missing_leaf_names_key(self, tmp_path):
        tree = {"w": torch.ones(3), "mu": torch.zeros(3, 2)}
        path = tmp_path / "ckpt"
        save_checkpoint(path, {"w": tree["w"]})
        with pytest.raises(ValueError, match=r"missing pytree leaf 'mu'"):
            load_checkpoint(path, tree)

    def test_shape_mismatch_names_key(self, tmp_path):
        path = tmp_path / "ckpt"
        save_checkpoint(path, {"w": torch.ones(3)})
        with pytest.raises(ValueError, match=r"leaf 'w' has shape \(3,\)"):
            load_checkpoint(path, {"w": torch.ones(4)})

    def test_bf16_roundtrip_exact(self, tmp_path):
        """bf16 -> f32 npz -> bf16 is exact, and the restored leaf keeps the
        template's dtype."""
        rng = np.random.default_rng(5)
        w = torch.as_tensor(rng.normal(0, 3, (4, 7)).astype(np.float32)
                            ).to(torch.bfloat16)
        path = tmp_path / "ckpt"
        save_checkpoint(path, {"w": w})
        restored, _ = load_checkpoint(
            path, {"w": torch.zeros(4, 7, dtype=torch.bfloat16)})
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"], w)

    def test_publish_is_versioned_and_atomic(self, fitted, tmp_path):
        gmm_a, _, _, _, _ = fitted
        assert latest_version(tmp_path) is None
        v1 = publish_checkpoint(tmp_path, gmm_a, {"round": 1})
        v2 = publish_checkpoint(tmp_path, gmm_a, {"round": 2})
        assert (v1, v2) == (1, 2)
        names = sorted(p.name for p in tmp_path.iterdir())
        assert names == ["LATEST", "model-000001.json", "model-000001.npz",
                         "model-000002.json", "model-000002.npz"]
        gmm, meta, v = load_published(tmp_path, gmm_a)
        assert v == 2 and meta["round"] == 2 and meta["version"] == 2
        assert set(meta["leaves"]) == {"0", "1", "2"}
        with pytest.raises(ValueError, match="never published"):
            load_published(tmp_path, gmm_a, version=9)

    def test_publish_survives_stale_latest(self, fitted, tmp_path):
        """A torn LATEST pointer (a stop between renames) does not wedge the
        stream: the next publish scans and moves past it."""
        gmm_a, _, _, _, _ = fitted
        publish_checkpoint(tmp_path, gmm_a)
        os.remove(tmp_path / "LATEST")
        v = publish_checkpoint(tmp_path, gmm_a)
        assert v == 2
        assert json.loads((tmp_path / "LATEST").read_text())["version"] == 2


# ----------------------------------------------------------------------
# SlotPool bookkeeping
# ----------------------------------------------------------------------

class TestSlotPool:
    def test_admit_overflow_raises(self):
        pool = SlotPool(1, 4, DIM)
        pool.admit(InFlight(ScoreRequest(0, np.zeros((2, DIM))), 0.0, 1))
        assert pool.free == 0
        with pytest.raises(RuntimeError, match="full"):
            pool.admit(InFlight(ScoreRequest(1, np.zeros((2, DIM))),
                                0.0, 1))

    def test_geometry_validation(self):
        with pytest.raises(ValueError, match="positive"):
            SlotPool(0, 4, DIM)

    def test_slab_and_mask_share_one_buffer(self):
        """The slab and mask are views of one host tensor (what one copy
        carries to the card), and harvest copies out of the step output,
        which the engine reuses."""
        pool = SlotPool(2, 3, DIM)
        rows = np.arange(4 * DIM, dtype=np.float32).reshape(4, DIM)
        pool.admit(InFlight(ScoreRequest(7, rows), 0.0, 1))
        assert pool.stage() == [0]
        flat = pool.buffer.numpy()
        np.testing.assert_array_equal(flat[:3 * DIM], rows[:3].ravel())
        np.testing.assert_array_equal(flat[6 * DIM:], [1, 1, 1, 0, 0, 0])
        out = np.ones((2, 3), np.float32)
        assert pool.harvest(out, [0]) == []
        out[:] = 5.0
        assert pool.stage() == [0]
        (res,) = pool.harvest(out, [0])
        np.testing.assert_array_equal(res.scores, [1, 1, 1, 5])
        assert res.rid == 7 and res.model_version == 1
