"""The frozen copies of the generators and the partition give the arrays
the program's own give, for the same seed."""
import numpy as np
import pytest

from perfbench import data


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3_000_000_019])
@pytest.mark.parametrize("name,rows,test_rows", [
    ("mnist_like", 2500, 10), ("mnist_like", 1200, 300),
    ("smd_like", 3000, 0), ("smd_like", 2000, 500)])
def test_copies_match_the_program(seed, name, rows, test_rows):
    from repro_torch.core.partition import partition_dirichlet
    from repro_torch.data.datasets import mnist_like, smd_like
    orig = {"mnist_like": mnist_like, "smd_like": smd_like}[name]
    r1 = np.random.default_rng(seed)
    ds = orig(r1, n_train=rows, n_test=test_rows)
    want = partition_dirichlet(r1, ds.x_train, ds.y_train, 20, 0.5)
    r2 = np.random.default_rng(seed)
    x, y, _ = data.GENERATORS[name](r2, rows, test_rows)
    got = data.partition_dirichlet(r2, x, y, 20, 0.5)
    assert np.array_equal(x, ds.x_train) and np.array_equal(y, ds.y_train)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_every_seed_gives_the_federation_the_same_sizes():
    """The clients' shares come from the configuration and every client is
    padded to its ``pad_rows``: one shape for every seed, other rows."""
    cfg = {"generator": "smd_like", "rows": 20000, "test_rows": 0,
           "clients": 20, "alpha": 0.5, "partition_seed": 0, "pad_rows": 21000}
    splits = [data.make_split(cfg, s) for s in (1, 2, 2**31 + 3)]
    assert {s.data.shape for s in splits} == {(20, 21000, 38)}
    biggest = [int(s.sizes.max()) for s in splits]
    assert max(biggest) - min(biggest) < 0.03 * min(biggest)
    assert not np.array_equal(splits[0].data, splits[1].data)
    again = data.make_split(cfg, 2)
    assert all(np.array_equal(a, b) for a, b in zip(again, splits[1]))
