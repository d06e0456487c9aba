"""``repro_torch.data.sources`` against ``repro.data.sources`` on the CPU.

The deterministic sources (arrays, ``.npy`` files, concatenations) and the
loader's padding and masks must give the JAX package's blocks bit for bit,
a float64 file included (both hand over float32). The random ones draw
from the port's generators, so they are held to their properties:
``SyntheticGMMSource`` gives the same rows at every chunk size, on every
pass, cached or not, with moments within a stated number of standard
errors of its mixture; ``ShuffledSource`` passes epoch 0 through and
permutes each window of later epochs.
"""
import threading

import numpy as np
import pytest
import torch

from repro.data import sources as jsrc
from repro_torch.core import em, kmeans
from repro_torch.core.config import FitConfig, resolve_source_chunk
from repro_torch.core.gmm import GMM
from repro_torch.data import sources
from repro_torch.data.sources import (ArraySource, ConcatSource, DataSource,
                                      NpyFileSource, ShuffledSource,
                                      SyntheticGMMSource, as_source,
                                      pad_target, prefetch_blocks)

CPU = "cpu"


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).normal(size=(1000, 5)).astype(np.float32)


def blocks_of(source, chunk):
    return [np.asarray(b) for b in source.iter_blocks(chunk)]


def assert_same_blocks(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def mixture():
    return GMM(torch.tensor([0.25, 0.75]),
               torch.tensor([[-4.0, 0.0, 1.0], [4.0, 2.0, -1.0]]),
               torch.tensor([[0.5, 1.0, 0.25], [1.5, 0.5, 1.0]]))


class TestArraySource:
    def test_protocol(self, rows):
        s = ArraySource(rows)
        assert (s.num_rows, s.dim, len(s)) == (1000, 5, 1000)
        assert s.dtype == torch.float32
        assert s.device == torch.device("cpu")

    def test_block_shapes_ragged_tail(self, rows):
        shapes = [tuple(b.shape) for b in blocks_of(ArraySource(rows), 256)]
        assert shapes == [(256, 5)] * 3 + [(232, 5)]

    @pytest.mark.parametrize("chunk", [97, 256, 1000, 7000])
    def test_blocks_equal_jax(self, rows, chunk):
        assert_same_blocks(blocks_of(ArraySource(rows), chunk),
                           blocks_of(jsrc.ArraySource(rows), chunk))

    def test_materialize_round_trip(self, rows):
        np.testing.assert_array_equal(
            ArraySource(rows).materialize(256).numpy(), rows)

    def test_restartable(self, rows):
        s = ArraySource(rows)
        assert_same_blocks(blocks_of(s, 300), blocks_of(s, 300))

    def test_num_blocks(self, rows):
        s = ArraySource(rows)
        assert s.num_blocks(256) == 4
        assert s.num_blocks(1000) == 1
        assert s.num_blocks(7000) == 1

    def test_rejects_bad_shapes(self, rows):
        with pytest.raises(ValueError):
            ArraySource(rows[:, 0])
        with pytest.raises(ValueError):
            ArraySource(rows[:0])
        with pytest.raises(ValueError):
            list(ArraySource(rows).iter_blocks(0))

    def test_as_source(self, rows):
        assert isinstance(as_source(rows), ArraySource)
        s = ArraySource(rows)
        assert as_source(s) is s

    def test_tensor_rows_stay_on_their_device_and_canonicalize(self, rows):
        t = torch.as_tensor(rows.astype(np.float64))
        s = ArraySource(t)
        assert s.dtype == torch.float32 and s.device == t.device
        got = blocks_of(s, 256)
        assert_same_blocks(got, blocks_of(jsrc.ArraySource(
            rows.astype(np.float64)), 256))


class TestNpyFileSource:
    def test_mmap_round_trip(self, rows, tmp_path):
        path = tmp_path / "rows.npy"
        np.save(path, rows)
        s = NpyFileSource(path)
        assert (s.num_rows, s.dim) == rows.shape
        np.testing.assert_array_equal(s.materialize(300).numpy(), rows)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_blocks_equal_jax(self, rows, tmp_path, dtype):
        """A float64 file gives float32 blocks, as JAX without x64 does."""
        path = tmp_path / "rows.npy"
        np.save(path, rows.astype(dtype) * 1.1)
        got = blocks_of(NpyFileSource(path), 256)
        assert_same_blocks(got, blocks_of(jsrc.NpyFileSource(path), 256))
        assert got[0].dtype == np.float32
        assert NpyFileSource(path).dtype == torch.float32

    def test_blocks_match_array_source(self, rows, tmp_path):
        path = tmp_path / "rows.npy"
        np.save(path, rows)
        assert_same_blocks(blocks_of(NpyFileSource(path), 256),
                           blocks_of(ArraySource(rows), 256))

    def test_writing_a_block_never_reaches_the_file(self, rows, tmp_path):
        path = tmp_path / "rows.npy"
        np.save(path, rows)
        block = next(NpyFileSource(path).iter_blocks(256))
        block += 1.0
        np.testing.assert_array_equal(np.load(path), rows)

    def test_rejects_non_2d(self, tmp_path):
        path = tmp_path / "bad.npy"
        np.save(path, np.zeros((4, 3, 2), np.float32))
        with pytest.raises(ValueError):
            NpyFileSource(path)


class TestConcatSource:
    def test_ragged_shards_rechunk_to_array_partition(self, rows):
        """Blocks bit-identical to an ArraySource over the concatenated
        rows, whatever the shard boundaries, and to JAX's ConcatSource."""
        cuts = [(0, 311), (311, 312), (312, 700), (700, 1000)]
        c = ConcatSource([ArraySource(rows[a:b]) for a, b in cuts])
        assert c.num_rows == 1000
        got = blocks_of(c, 256)
        assert_same_blocks(got, blocks_of(ArraySource(rows), 256))
        assert_same_blocks(got, blocks_of(jsrc.ConcatSource(
            [jsrc.ArraySource(rows[a:b]) for a, b in cuts]), 256))

    def test_nested_and_mixed_children(self, rows, tmp_path):
        path = tmp_path / "tail.npy"
        np.save(path, rows[600:])
        c = ConcatSource([
            ConcatSource([ArraySource(rows[:100]),
                          ArraySource(rows[100:600])]),
            NpyFileSource(path)])
        np.testing.assert_array_equal(c.materialize(128).numpy(), rows)

    def test_rejects_dim_mismatch_and_empty(self, rows):
        with pytest.raises(ValueError):
            ConcatSource([ArraySource(rows), ArraySource(rows[:, :3])])
        with pytest.raises(ValueError):
            ConcatSource([])

    def test_rejects_dtype_mismatch(self, rows):
        ints = np.ones((10, 5), np.int32)
        with pytest.raises(ValueError, match="dtype"):
            ConcatSource([ArraySource(rows), ArraySource(ints)])


class TestLoader:
    """``pad_target``, the masks and ``prefetch_blocks`` against JAX's."""

    @pytest.mark.parametrize("n", [1, 63, 64, 65, 999, 1000, 1001, 5000])
    @pytest.mark.parametrize("chunk", [64, 100, 1000, 4096])
    def test_pad_target_equals_jax(self, n, chunk):
        assert pad_target(n, chunk) == jsrc.pad_target(n, chunk)

    @pytest.mark.parametrize("n,chunk", [(1000, 256), (1000, 1000),
                                         (999, 4096), (333, 97)])
    def test_prefetch_pairs_equal_jax(self, rows, n, chunk):
        x = rows[:n]
        want = [(np.asarray(b), np.asarray(m)) for b, m in
                jsrc.prefetch_blocks(jsrc.ArraySource(x), chunk, depth=0)]
        for depth in (0, 2):
            got = [(b.numpy(), m.numpy()) for b, m in prefetch_blocks(
                ArraySource(x), chunk, depth=depth, device=CPU)]
            assert len(got) == len(want)
            for (gb, gm), (wb, wm) in zip(got, want):
                np.testing.assert_array_equal(gb, wb)
                np.testing.assert_array_equal(gm, wm)
                assert gm.dtype == wm.dtype

    def test_full_blocks_share_one_mask(self, rows):
        masks = [m for _, m in prefetch_blocks(ArraySource(rows), 256,
                                               depth=0, device=CPU)]
        assert masks[0] is masks[1] is masks[2]
        assert float(masks[3].sum()) == 232.0

    def test_producer_error_reaches_the_consumer(self, rows):
        class Broken(DataSource):
            num_rows, dim = 1000, 5

            def iter_blocks(self, chunk_size):
                yield torch.zeros(chunk_size, 5)
                raise OSError("disk gone")

        it = prefetch_blocks(Broken(), 256, depth=2, device=CPU)
        next(it)
        with pytest.raises(OSError, match="disk gone"):
            next(it)

    def test_dropping_the_consumer_stops_the_producer(self, rows):
        before = {t for t in threading.enumerate()
                  if t.name == "prefetch_blocks"}
        it = prefetch_blocks(ArraySource(rows), 100, depth=2, device=CPU)
        next(it)
        it.close()
        for t in threading.enumerate():
            if t.name == "prefetch_blocks" and t not in before:
                t.join(timeout=5)
                assert not t.is_alive()


class TestSyntheticGMMSource:
    def test_chunk_invariance(self):
        """Row i depends on i, never on the block it falls in: one fixed
        virtual dataset whatever the chunking."""
        s = SyntheticGMMSource(mixture(), 20000, seed=7)
        m64 = s.materialize(64)
        for chunk in (97, 8192, 20000):
            assert torch.equal(m64, s.materialize(chunk))

    def test_cached_equals_uncached_and_restartable(self):
        cached = SyntheticGMMSource(mixture(), 3000, seed=4)
        fresh = SyntheticGMMSource(mixture(), 3000, seed=4, cache_rows=0)
        first = blocks_of(cached, 500)
        assert_same_blocks(first, blocks_of(cached, 500))
        assert_same_blocks(first, blocks_of(fresh, 500))
        assert_same_blocks(blocks_of(fresh, 500), blocks_of(fresh, 500))

    def test_deterministic_per_seed(self):
        a = SyntheticGMMSource(mixture(), 200, seed=1).materialize(64)
        b = SyntheticGMMSource(mixture(), 200, seed=1).materialize(64)
        c = SyntheticGMMSource(mixture(), 200, seed=2).materialize(64)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)

    def test_rows_follow_the_model_device(self):
        s = SyntheticGMMSource(mixture(), 100, seed=0)
        assert s.device == torch.device("cpu")
        assert s.dtype == torch.float32
        numpy_model = GMM(*(t.numpy() for t in (mixture().weights,
                                                mixture().means,
                                                mixture().covs)))
        assert SyntheticGMMSource(numpy_model, 10, 0, device=CPU).device \
            == torch.device("cpu")

    def test_moments_match_mixture(self):
        """Mean within 5 standard errors (sqrt(var / n)) of the mixture's,
        variance within 5 standard errors (sqrt((m4 - var²) / n), from the
        sample's fourth central moment) of the law of total variance."""
        g = mixture()
        n = 40000
        x = SyntheticGMMSource(g, n, seed=3).materialize(4096).double()
        w, mu, var = (t.double() for t in (g.weights, g.means, g.covs))
        want_mean = w @ mu
        want_var = w @ var + w @ (mu - want_mean) ** 2
        mean = x.mean(0)
        dev = x - mean
        s2 = (dev ** 2).mean(0)
        m4 = (dev ** 4).mean(0)
        assert torch.all((mean - want_mean).abs()
                         <= 5 * torch.sqrt(want_var / n))
        assert torch.all((s2 - want_var).abs()
                         <= 5 * torch.sqrt((m4 - s2 ** 2) / n))

    def test_full_covariance(self):
        """Sample covariance within 5 standard errors of the model's."""
        cov = torch.tensor([[[1.0, 0.8], [0.8, 1.0]]])
        g = GMM(torch.tensor([1.0]), torch.zeros((1, 2)), cov)
        n = 20000
        x = SyntheticGMMSource(g, n, seed=5).materialize(4096).double()
        x = x - x.mean(0)
        prods = x[:, :, None] * x[:, None, :]
        se = prods.std(0) / n ** 0.5
        assert torch.all((prods.mean(0) - cov[0].double()).abs() <= 5 * se)

    def test_rejects_zero_rows(self):
        with pytest.raises(ValueError):
            SyntheticGMMSource(mixture(), 0, seed=0)


class TestShuffledSource:
    CHUNK = 128  # 1000 rows -> 7 full blocks + a 104-row ragged tail

    def test_protocol_passthrough(self, rows):
        src = ShuffledSource(ArraySource(rows), seed=1)
        assert (src.num_rows, src.dim) == (1000, 5)
        assert src.dtype == torch.float32
        assert src.epoch == 0

    def test_epoch_zero_is_a_bit_exact_passthrough(self, rows):
        base = ArraySource(rows)
        assert_same_blocks(blocks_of(ShuffledSource(base, 3), self.CHUNK),
                           blocks_of(base, self.CHUNK))

    @pytest.mark.parametrize("window_blocks", [1, 2, 8])
    def test_each_window_holds_the_inner_windows_rows(self, rows,
                                                      window_blocks):
        src = ShuffledSource(ArraySource(rows), seed=5, epoch=1,
                             window_blocks=window_blocks)
        plain = blocks_of(ArraySource(rows), self.CHUNK)
        shuf = blocks_of(src, self.CHUNK)
        assert [b.shape for b in shuf] == [b.shape for b in plain]
        win = window_blocks * self.CHUNK
        flat = np.concatenate(shuf)
        for start in range(0, 1000, win):
            np.testing.assert_array_equal(
                np.sort(flat[start:start + win], axis=0),
                np.sort(rows[start:start + win], axis=0))
        assert not all(np.array_equal(a, b) for a, b in zip(plain, shuf))

    def test_epochs_are_deterministic_and_distinct(self, rows):
        base = ArraySource(rows)
        src = ShuffledSource(base, seed=1, epoch=2)
        again = ShuffledSource(base, seed=1).with_epoch(2)
        assert_same_blocks(blocks_of(src, self.CHUNK),
                           blocks_of(again, self.CHUNK))
        other = blocks_of(src.with_epoch(3), self.CHUNK)
        assert not all(np.array_equal(a, b) for a, b in
                       zip(blocks_of(src, self.CHUNK), other))

    def test_validation(self, rows):
        with pytest.raises(ValueError, match="epoch"):
            ShuffledSource(ArraySource(rows), 0, epoch=-1)
        with pytest.raises(ValueError, match="window_blocks"):
            ShuffledSource(ArraySource(rows), 0, window_blocks=0)


class TestEngineValidation:
    def test_sample_weight_rejected_with_source(self, rows):
        g = GMM(torch.full((2,), 0.5), torch.zeros((2, 5)), torch.ones((2, 5)))
        s = ArraySource(rows)
        w = torch.ones(1000)
        with pytest.raises(ValueError, match="sample_weight"):
            em.e_step_stats(g, s, w)
        with pytest.raises(ValueError, match="sample_weight"):
            em.fit_gmm_cfg(0, s, 2, FitConfig(device=CPU), sample_weight=w)

    def test_weight_error_text_equals_jax(self):
        from repro.core.config import require_array_weights as jax_rule
        from repro_torch.core.config import require_array_weights
        with pytest.raises(ValueError) as got:
            require_array_weights(1, "x")
        with pytest.raises(ValueError) as want:
            jax_rule(1, "x")
        assert str(got.value) == str(want.value)

    def test_zero_chunk_rejected_not_defaulted(self, rows):
        with pytest.raises(ValueError, match="positive"):
            resolve_source_chunk(0)
        with pytest.raises(ValueError, match="positive"):
            kmeans.kmeans_source(0, ArraySource(rows), 2, chunk_size=0,
                                 device=CPU)
        assert resolve_source_chunk(None) == 65536

    def test_empty_iteration_guard(self):
        class Hollow(DataSource):
            num_rows = 4
            dim = 2

            def iter_blocks(self, chunk_size):
                return iter(())

        with pytest.raises(ValueError, match="no blocks"):
            em.streaming_reduce(lambda xb, wb: (torch.sum(xb),), Hollow(), 2,
                                device=CPU)

    def test_resolve_chunk_by_input_type(self):
        assert FitConfig().resolve_chunk(source=False) is None
        assert FitConfig().resolve_chunk(source=True) == 65536
        assert FitConfig(chunk_size=512).resolve_chunk(source=True) == 512


class TestPrefetchDepthDefault:
    """PREFETCH_DEPTH is read at import: 0 (the inline loop) at any core
    count, unlike the JAX package's core-count heuristic;
    REPRO_PREFETCH_DEPTH overrides."""

    def test_heuristic_tracks_core_count(self, monkeypatch):
        monkeypatch.delenv("REPRO_PREFETCH_DEPTH", raising=False)
        for cpus in (1, 2, 3, 16, None):
            monkeypatch.setattr(sources.os, "cpu_count", lambda c=cpus: c)
            assert sources.default_prefetch_depth() == 0

    def test_env_override_wins(self, monkeypatch):
        monkeypatch.setattr(sources.os, "cpu_count", lambda: 16)
        monkeypatch.setenv("REPRO_PREFETCH_DEPTH", "0")
        assert sources.default_prefetch_depth() == 0
        monkeypatch.setenv("REPRO_PREFETCH_DEPTH", "5")
        assert sources.default_prefetch_depth() == 5

    def test_negative_override_rejected(self, monkeypatch):
        monkeypatch.setenv("REPRO_PREFETCH_DEPTH", "-1")
        with pytest.raises(ValueError, match="REPRO_PREFETCH_DEPTH"):
            sources.default_prefetch_depth()
