"""The port's checkpoint store (``repro_torch.checkpoint``) writes the JAX
package's format: a stream one package publishes loads in the other with
equal arrays, versions and metadata, in both directions, so a model the
JAX package trains can be served by the port. Arrays cross exactly (f32
stays f32, bf16 is stored as f32 and restored as bf16), so every
comparison here is equality. Also: the flat keys of nested containers, the
``leaves`` table, loader errors that name the flat key, and a stale
``LATEST`` pointer, each across the two packages.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import log_prob as jax_log_prob
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import publish_checkpoint as jax_publish
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.core.gmm import GMM as JaxGMM
from repro.serve import ModelStore as JaxModelStore
from repro_torch.api import FitConfig, Scorer, log_prob
from repro_torch.checkpoint import (latest_version, leaf_spec,
                                    load_checkpoint, load_published,
                                    publish_checkpoint, save_checkpoint)
from repro_torch.core.gmm import GMM
from repro_torch.serve import ModelStore

K, D = 4, 6


def arrays(seed):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(K)).astype(np.float32)
    mu = rng.normal(0, 2, (K, D)).astype(np.float32)
    var = rng.uniform(0.2, 2.0, (K, D)).astype(np.float32)
    return w, mu, var


def jax_gmm(seed, dtype=jnp.float32):
    return JaxGMM(*(jnp.asarray(a).astype(dtype) for a in arrays(seed)))


def port_gmm(seed, dtype=torch.float32):
    return GMM(*(torch.as_tensor(a).to(dtype) for a in arrays(seed)))


def as_f32(leaves):
    return [np.asarray(jnp.asarray(t).astype(jnp.float32))
            if not isinstance(t, torch.Tensor) else t.float().numpy()
            for t in leaves]


def gmm_leaves(g):
    return (g.weights, g.means, g.covs)


def test_jax_stream_loads_in_the_port(tmp_path):
    jstore = JaxModelStore(tmp_path)
    assert jstore.publish(jax_gmm(0), {"round": 1}) == 1
    assert jstore.publish(jax_gmm(1), {"round": 2}) == 2
    store = ModelStore(tmp_path, device="cpu")
    assert store.latest_version() == 2
    first, latest = store.load(1), store.poll()
    assert (first.version, latest.version) == (1, 2)
    assert latest.metadata["round"] == 2 and first.metadata["version"] == 1
    for got, seed in ((first, 0), (latest, 1)):
        assert all(t.dtype == torch.float32 and t.device.type == "cpu"
                   for t in gmm_leaves(got.gmm))
        for a, b in zip(as_f32(gmm_leaves(got.gmm)), arrays(seed)):
            np.testing.assert_array_equal(a, b)
    assert store.poll() is None


def test_port_stream_loads_in_the_jax_package(tmp_path):
    store = ModelStore(tmp_path, device="cpu")
    assert store.publish(port_gmm(2), {"round": 7}) == 1
    published = JaxModelStore(tmp_path).latest()
    assert published.version == 1 and published.metadata["round"] == 7
    for a, b in zip(as_f32(gmm_leaves(published.gmm)), arrays(2)):
        np.testing.assert_array_equal(a, b)
    assert published.gmm.weights.dtype == jnp.float32


def test_one_stream_two_publishers(tmp_path):
    """Versions count on across the two packages, the json metadata of a
    version is the same whichever package wrote it, and each reads the
    other's newest."""
    assert jax_publish(tmp_path, jax_gmm(0), {"by": "jax"}) == 1
    assert publish_checkpoint(tmp_path, port_gmm(0), {"by": "port"}) == 2
    meta = [json.loads((tmp_path / f"model-00000{v}.json").read_text())
            for v in (1, 2)]
    assert meta[0]["leaves"] == meta[1]["leaves"] == leaf_spec(port_gmm(0))
    assert [m["version"] for m in meta] == [1, 2]
    files = [set(np.load(tmp_path / f"model-00000{v}.npz").files)
             for v in (1, 2)]
    assert files[0] == files[1] == {"0", "1", "2"}
    assert JaxModelStore(tmp_path).latest().metadata["by"] == "port"
    assert jax_publish(tmp_path, jax_gmm(1)) == 3
    got, _, v = load_published(tmp_path, port_gmm(9))
    assert v == 3
    for a, b in zip(as_f32(gmm_leaves(got)), arrays(1)):
        np.testing.assert_array_equal(a, b)


def test_leaf_spec_dtype_names_match(tmp_path):
    tree_t = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
              "i": torch.zeros(4, dtype=torch.int32),
              "m": torch.zeros(1, dtype=torch.bool),
              "f": torch.zeros(5)}
    tree_j = {"w": jnp.zeros((2, 3), jnp.bfloat16),
              "i": jnp.zeros(4, jnp.int32), "m": jnp.zeros(1, bool),
              "f": jnp.zeros(5)}
    from repro.checkpoint import leaf_spec as jax_leaf_spec
    assert leaf_spec(tree_t) == jax_leaf_spec(tree_j)
    assert leaf_spec(tree_t)["w"] == {"shape": [2, 3], "dtype": "bfloat16"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_crosses_exactly(tmp_path, writer):
    """A bf16 model published by either package is restored as bf16 by
    both, with the same values."""
    if writer == "jax":
        JaxModelStore(tmp_path).publish(jax_gmm(3, jnp.bfloat16))
    else:
        ModelStore(tmp_path, device="cpu").publish(port_gmm(3,
                                                            torch.bfloat16))
    meta = json.loads((tmp_path / "model-000001.json").read_text())
    assert {v["dtype"] for v in meta["leaves"].values()} == {"bfloat16"}
    want = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for a in arrays(3)]
    port = ModelStore(tmp_path, device="cpu").latest().gmm
    jax_side = JaxModelStore(tmp_path).latest().gmm
    assert all(t.dtype == torch.bfloat16 for t in gmm_leaves(port))
    assert all(t.dtype == jnp.bfloat16 for t in gmm_leaves(jax_side))
    for got in (as_f32(gmm_leaves(port)), as_f32(gmm_leaves(jax_side))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_bf16_roundtrip_exact_in_the_port(tmp_path):
    rng = np.random.default_rng(5)
    w = torch.as_tensor(rng.normal(0, 3, (4, 7)).astype(np.float32)
                        ).to(torch.bfloat16)
    save_checkpoint(tmp_path / "c", {"w": w, "k": torch.arange(3)})
    stored = np.load(tmp_path / "c.npz")
    assert stored["w"].dtype == np.float32 and stored["k"].dtype == np.int64
    back, meta = load_checkpoint(tmp_path / "c", {
        "w": torch.zeros(4, 7, dtype=torch.bfloat16),
        "k": torch.zeros(3, dtype=torch.int64)})
    assert meta == {} and back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], w) and torch.equal(back["k"],
                                                     torch.arange(3))


def nested_port():
    return {"b": [port_gmm(4), (torch.ones(2), None)],
            "a": {"z": torch.arange(3, dtype=torch.float32)}}


def nested_jax():
    return {"b": [jax_gmm(4), (jnp.ones(2), None)],
            "a": {"z": jnp.arange(3, dtype=jnp.float32)}}


def test_nested_containers_have_the_jax_flat_keys(tmp_path):
    save_checkpoint(tmp_path / "p", nested_port(), {"note": 1})
    jax_save_checkpoint(tmp_path / "j", nested_jax())
    keys = set(np.load(tmp_path / "p.npz").files)
    assert keys == set(np.load(tmp_path / "j.npz").files) == {
        "a/z", "b/0/0", "b/0/1", "b/0/2", "b/1/0"}
    # each package restores the other's file into its own structure
    back, meta = load_checkpoint(tmp_path / "j", nested_port())
    assert meta == {} and isinstance(back["b"][0], GMM)
    assert isinstance(back["b"][1], tuple) and back["b"][1][1] is None
    jback, jmeta = jax_load_checkpoint(tmp_path / "p", nested_jax())
    assert jmeta == {"note": 1}
    for a, b in zip(as_f32(gmm_leaves(back["b"][0])),
                    as_f32(gmm_leaves(jback["b"][0]))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["a"]["z"].numpy(),
                                  np.asarray(jback["a"]["z"]))


def test_loader_errors_name_the_flat_key(tmp_path):
    jax_save_checkpoint(tmp_path / "j", {"b": [jax_gmm(4)]})
    with pytest.raises(ValueError, match=r"missing pytree leaf 'a/z'"):
        load_checkpoint(tmp_path / "j", {"b": [port_gmm(4)],
                                         "a": {"z": torch.zeros(3)}})
    wrong = GMM(torch.zeros(K), torch.zeros(K, D + 1), torch.zeros(K, D))
    with pytest.raises(ValueError,
                       match=rf"leaf 'b/0/1' has shape \({K}, {D}\)"):
        load_checkpoint(tmp_path / "j", {"b": [wrong]})


@pytest.mark.parametrize("first", ["jax", "port"])
def test_stale_latest_is_survived_across_packages(tmp_path, first):
    """A stream whose LATEST pointer is missing (a publisher stopped
    between the payload and pointer renames) goes on at the next version,
    whichever package published before and after."""
    publishers = {"jax": lambda: jax_publish(tmp_path, jax_gmm(0)),
                  "port": lambda: publish_checkpoint(tmp_path, port_gmm(0))}
    second = "port" if first == "jax" else "jax"
    assert publishers[first]() == 1
    os.remove(tmp_path / "LATEST")
    assert latest_version(tmp_path) == 1
    assert publishers[second]() == 2
    assert json.loads((tmp_path / "LATEST").read_text())["version"] == 2
    assert ModelStore(tmp_path, device="cpu").latest().version == 2


def test_port_scorer_serves_a_jax_published_model(tmp_path):
    """The JAX package trains and publishes; the port's ``Scorer`` serves:
    the bits of the port's ``api.log_prob`` on the loaded model, within
    2e-4 of the JAX package's ``log_prob``."""
    JaxModelStore(tmp_path).publish(jax_gmm(6))
    rows = np.random.default_rng(6).normal(0, 2, (300, D)).astype(np.float32)
    scorer = Scorer.from_checkpoint(tmp_path, "anomaly", slots=2,
                                    rows_per_slot=64, backend="fused",
                                    device="cpu")
    got = scorer.score(rows)
    want = log_prob(scorer.gmm, rows, FitConfig(backend="fused",
                                                device="cpu")).numpy()
    np.testing.assert_array_equal(got, -want)
    np.testing.assert_allclose(got, -np.asarray(jax_log_prob(jax_gmm(6),
                                                             rows)),
                               rtol=2e-4, atol=2e-4)
