"""The padded split's upload onto a card: ``fed.upload`` in
``fed/runtime.py::make_backend``, through
``repro_torch.data.sources.stage_to_device``'s ring of pinned buffers.

The CPU cases hold the chunk plan (every element once, in order), the
staged path's host cast against numpy's (bit for bit), and that on the CPU
the split still arrives as ``torch.as_tensor`` makes it, with
``staged_bytes`` 0 noted on ``fed.upload``. The ``cuda`` cases skip without
a card; the file imports no JAX, so on a card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_upload.py

and hold the staged tensors bit for bit against ``torch.as_tensor``, two
uploads back to back with no synchronize between them, the caller's arrays
free to change once the upload returns, ``staged_bytes``, and no device
memory beyond the two destination tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.partition import ClientSplit
from repro_torch.data import sources
from repro_torch.fed.runtime import make_backend, split_to_clients

# a chunk small enough that a split of a few thousand rows is many chunks
SMALL_CHUNK = 4096


def plain(a) -> torch.Tensor:
    """The unstaged upload, on the CPU: what ``split_to_clients`` made
    before the ring."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def host_array(rng, shape, kind: str) -> np.ndarray:
    """Values of ``shape`` in the layout ``kind`` names. The float64 values
    span float32's range, its subnormals and beyond its largest value, so
    the cast rounds, goes subnormal and overflows."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-44, 40, size=shape)
    if kind == "float32":
        return np.clip(x, -1e30, 1e30).astype(np.float32)
    if kind == "float64":
        return x
    if kind == "transposed":     # a strided float64 view
        return np.ascontiguousarray(np.swapaxes(x, 0, -1)).swapaxes(0, -1)
    if kind == "reversed":       # negative strides
        return x[::-1]
    if kind == "big-endian":
        return x.astype(">f8")
    if kind == "int64":
        return rng.integers(-2**40, 2**40, size=shape)
    if kind == "bool":
        return rng.random(shape) < 0.5
    raise ValueError(kind)


def make_split(rng, clients, rows, d, kind) -> ClientSplit:
    data = host_array(rng, (clients, rows, d), kind)
    mask = host_array(rng, (clients, rows), kind)
    return ClientSplit(data, mask, np.full(clients, rows, np.int64),
                       np.zeros((clients, 1), np.int64))


# ----------------------------------------------------------------------
# CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("numel", [0, 1, SMALL_CHUNK, SMALL_CHUNK + 1,
                                   7 * SMALL_CHUNK + 123])
def test_chunk_plan_covers_every_element_once(numel):
    plan = sources.upload_chunks(numel, SMALL_CHUNK)
    covered = np.zeros(numel, np.int64)
    for o, n in plan:
        assert 0 < n <= SMALL_CHUNK
        covered[o:o + n] += 1
    assert (covered == 1).all()
    assert [o for o, _ in plan] == list(range(0, numel, SMALL_CHUNK))
    assert len(plan) == -(-numel // SMALL_CHUNK)


@pytest.mark.parametrize("kind", ["float32", "float64", "transposed",
                                  "reversed", "big-endian", "int64", "bool"])
def test_staged_host_cast_is_numpys(rng, kind):
    a = host_array(rng, (3, 50, 7), kind)
    src = sources._host_elements(a).reshape(-1)
    out = torch.empty(a.size, dtype=torch.float32)
    for o, n in sources.upload_chunks(a.size, 64):
        out[o:o + n].copy_(src[o:o + n])
    want = np.asarray(a, np.float32).reshape(-1)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("kind", ["float32", "float64", "transposed"])
@pytest.mark.parametrize("entry", ["split_to_clients", "make_backend"])
def test_cpu_split_is_as_tensor_and_stages_nothing(rng, kind, entry,
                                                   monkeypatch):
    monkeypatch.setattr(sources, "UPLOAD_CHUNK", SMALL_CHUNK)
    split = make_split(rng, 3, 2000, 5, kind)
    with tracing.recording() as rec, tracing.span("api.run"):
        clients = (split_to_clients(split, "cpu")
                   if entry == "split_to_clients"
                   else make_backend(split, "cpu"))
    for got, a in ((clients.data, split.data), (clients.mask, split.mask)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert torch.equal(got, plain(a))
    assert clients.split is split
    np.testing.assert_array_equal(clients.sizes, split.sizes)
    noted = [s.info for s in rec.spans if "staged_bytes" in s.info]
    assert noted == [{"staged_bytes": 0}]
    if entry == "make_backend":
        assert [s.name for s in rec.spans] == ["api.run", "fed.upload"]


def test_resident_split_clients_pass_through(rng):
    clients = split_to_clients(make_split(rng, 2, 100, 3, "float32"), "cpu")
    assert make_backend(clients, "cpu") is clients


# ----------------------------------------------------------------------
# On a card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring's buffers are page-locked")
    torch.cuda.synchronize()
    return torch.device("cuda")


def small_chunk(monkeypatch, chunk: str):
    """``chunk`` "small": a ring of SMALL_CHUNK-element buffers; "module":
    the module's own."""
    if chunk == "small":
        monkeypatch.setattr(sources, "UPLOAD_CHUNK", SMALL_CHUNK)
    return sources.UPLOAD_CHUNK


def rows_for(chunk: int, d: int, clients: int, chunks: float) -> int:
    """Rows a client so that ``data`` is about ``chunks`` chunks and
    ``mask`` more than one."""
    return max(int(chunks * chunk / (clients * d)) + 1,
               chunk // clients + 7)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "float64", "transposed",
                                  "reversed"])
@pytest.mark.parametrize("chunk", ["small", "module"])
def test_staged_upload_is_bit_for_bit(card, rng, monkeypatch, kind, chunk):
    n = small_chunk(monkeypatch, chunk)
    clients, d = 4, 6
    split = make_split(rng, clients, rows_for(n, d, clients, 3.5), d, kind)
    assert split.data.size % n and split.mask.size % n   # partial last
    got = split_to_clients(split, card)
    for t, a in ((got.data, split.data), (got.mask, split.mask)):
        assert t.device.type == "cuda" and t.dtype == torch.float32
        assert torch.equal(t.cpu(), plain(a))


@pytest.mark.cuda
def test_back_to_back_uploads_each_read_back(card, rng, monkeypatch):
    small_chunk(monkeypatch, "small")
    a = host_array(rng, (5, 3001, 7), "float32")
    b = host_array(rng, (5, 3001, 7), "float64")
    want_a, want_b = plain(a).clone(), plain(b)   # plain(a) views a
    ta, staged_a = sources.stage_to_device(a, card)
    tb, staged_b = sources.stage_to_device(b, card)
    a[...] = np.nan           # the caller's arrays are free on return
    b[...] = np.nan
    assert staged_a == staged_b == a.size * 4
    assert torch.equal(ta.cpu(), want_a) and torch.equal(tb.cpu(), want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", ["small", "module"])
@pytest.mark.parametrize("large", [True, False])
def test_fed_upload_notes_staged_bytes(card, rng, monkeypatch, chunk, large):
    n = small_chunk(monkeypatch, chunk)
    clients, d = 4, 6
    rows = rows_for(n, d, clients, 2.5) if large else n // (clients * d)
    split = make_split(rng, clients, rows, d, "float32")
    with tracing.recording() as rec:
        got = make_backend(split, card)
    (upload,) = [s for s in rec.spans if s.name == "fed.upload"]
    want = split.data.nbytes + split.mask.nbytes if large else 0
    assert upload.info == {"staged_bytes": want}
    assert torch.equal(got.data.cpu(), plain(split.data))
    assert torch.equal(got.mask.cpu(), plain(split.mask))


@pytest.mark.cuda
def test_no_device_temporary(card, rng):
    n = sources.UPLOAD_CHUNK
    clients, d = 4, 8          # float32 bytes of both arrays: multiples of 512
    rows = -(-rows_for(n, d, clients, 2.5) // 128) * 128
    split = make_split(rng, clients, rows, d, "float32")
    split_to_clients(split, card)        # the ring's first pinned blocks
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = split_to_clients(split, card)
    torch.cuda.synchronize()
    assert (torch.cuda.max_memory_allocated() - base
            == split.data.nbytes + split.mask.nbytes)
    assert torch.equal(got.data.cpu(), plain(split.data))
