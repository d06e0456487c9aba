"""The port's legacy keyword fronts against their ``*_cfg`` cores on the
CPU: each shim folds its loose knobs into one ``FitConfig`` with
``FitConfig.from_legacy`` (``chunk_size=None`` meaning "auto", as in
``repro/core/config.py``) and gives the core's bits under that config. The
five deprecated forwarders (``fit_gmm_streaming`` and the four
``*_from_sources``) give their facade's bits and warn exactly once, as
``tests/test_api.py``'s ``TestDeprecationShims`` holds the JAX package's."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core.config import FitConfig
from repro_torch.core.dem import _legacy_init_name, dem, dem_cfg
from repro_torch.core.em import (fit_gmm, fit_gmm_bic, fit_gmm_bic_cfg,
                                 fit_gmm_cfg)
from repro_torch.core.fedgen import (aggregate, aggregate_cfg, fedgengmm,
                                     fedgengmm_cfg, train_locals,
                                     train_locals_bic, train_locals_bic_cfg,
                                     train_locals_cfg)
from repro_torch.core.gmm import GMM
from repro_torch.core.kmeans import federated_kmeans_from_sources
from repro_torch.core.partition import partition
from repro_torch.data.sources import ArraySource

from conftest import planted_gmm_data

# knobs off their defaults, so a knob the shim dropped would show
KNOBS = dict(max_iter=40, tol=1e-4, reg_covar=1e-5)
CFG = FitConfig(chunk_size="auto", tol=1e-4, max_iter=40, reg_covar=1e-5,
                device="cpu")


@pytest.fixture(scope="module")
def data():
    x, y, _ = planted_gmm_data(np.random.default_rng(4), n=900, d=3, k=3,
                               spread=5.0, std=0.5)
    split = partition(np.random.default_rng(0), x, y, 4, "dirichlet", 0.5)
    return x, split


def _tensors(out):
    """Every tensor and number of a result, in order: GMMs, NamedTuples,
    lists and dicts walked."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, GMM):
        return [out.weights, out.means, out.covs]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    if out is None:
        return []
    if isinstance(out, (int, float, bool)):
        return [torch.tensor(float(out))]
    raise TypeError(f"no tensors known in {type(out).__name__}")


def _calls(x, split):
    """(shim call, core call) of each of the seven shims."""
    data, mask = torch.as_tensor(split.data), torch.as_tensor(split.mask)
    locals_ = train_locals_cfg(1, data, mask, 3, CFG).gmm
    gmms = [locals_[i] for i in range(4)]
    return {
        "fit_gmm": (lambda: fit_gmm(0, x, 3, device="cpu", **KNOBS),
                    lambda: fit_gmm_cfg(0, x, 3, CFG)),
        "fit_gmm_bic": (
            lambda: fit_gmm_bic(0, x, (2, 3), device="cpu", **KNOBS),
            lambda: fit_gmm_bic_cfg(0, x, (2, 3), CFG)),
        "train_locals": (
            lambda: train_locals(1, data, mask, 3, device="cpu", **KNOBS),
            lambda: train_locals_cfg(1, data, mask, 3, CFG)),
        "train_locals_bic": (
            lambda: train_locals_bic(1, data, mask, (2, 3), device="cpu",
                                     **KNOBS),
            lambda: train_locals_bic_cfg(1, data, mask, (2, 3), CFG)),
        "aggregate": (
            lambda: aggregate(2, gmms, split.sizes, h=20, k_global=3,
                              device="cpu", **KNOBS),
            lambda: aggregate_cfg(2, gmms, split.sizes, CFG, 3, h=20)),
        "fedgengmm": (
            lambda: fedgengmm(3, split, k_clients=3, k_global=3, h=20,
                              device="cpu", **KNOBS),
            lambda: fedgengmm_cfg(3, split, CFG, k_clients=3, k_global=3,
                                  h=20, synthetic="resident")),
        "dem": (
            lambda: dem(4, split, 3, init=3, max_rounds=40, tol=1e-4,
                        reg_covar=1e-5, device="cpu"),
            lambda: dem_cfg(4, split, CFG.replace(init="fed-kmeans"), 3)),
    }


@pytest.mark.parametrize("shim", ["fit_gmm", "fit_gmm_bic", "train_locals",
                                  "train_locals_bic", "aggregate",
                                  "fedgengmm", "dem"])
def test_shim_is_its_cfg_core(data, shim):
    x, split = data
    front, core = _calls(x, split)[shim]
    got, exp = _tensors(front()), _tensors(core())
    assert len(got) == len(exp) > 0
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


@pytest.mark.parametrize("init,name", [(1, "separated"), (2, "pilot"),
                                       (3, "fed-kmeans"),
                                       ("pilot", "pilot")])
def test_legacy_init_name(init, name):
    assert _legacy_init_name(init) == name


@pytest.mark.parametrize("init", [0, 4, "kmeans", "auto"])
def test_legacy_init_name_rejects(init):
    with pytest.raises(ValueError, match="unknown DEM init scheme"):
        _legacy_init_name(init)


def test_from_legacy_folds_chunk_none_to_auto():
    cfg = FitConfig.from_legacy(chunk_size=None, tol=1e-4, max_iter=40,
                                device="cpu")
    assert cfg == CFG.replace(reg_covar=1e-6)
    assert FitConfig.from_legacy(chunk_size=256).chunk_size == 256


# ----------------------------------------------------------------------
# The deprecated forwarders: the facade's bits, one DeprecationWarning
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(data):
    """Three ragged per-client sources of the planted rows."""
    x, _ = data
    return [ArraySource(x[:250]), ArraySource(x[250:610]),
            ArraySource(x[610:])]


def _chip_smoke():
    """``chip_smoke.py``, which holds the forwarder table that its phase 16
    runs on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_forwarders",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


FORWARDERS = ["fit_gmm_streaming", "fedgengmm_from_sources",
              "dem_from_sources", "train_locals_from_sources",
              "federated_kmeans_from_sources"]


@pytest.mark.parametrize("name", FORWARDERS)
def test_forwarder_gives_the_facade_bits_and_warns_once(data, shards, name):
    x, _ = data
    old, new, replacement = SMOKE.forwarder_pairs(x, shards, "cpu")[name]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = old()
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in dep]
    assert name in str(dep[0].message)
    assert replacement in str(dep[0].message)
    assert dep[0].filename == SMOKE.__file__    # blamed on the caller
    exp = new()
    a, b = SMOKE.result_tensors(got), SMOKE.result_tensors(exp)
    assert len(a) == len(b) > 0
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    if hasattr(got, "comm"):
        assert got.comm == exp.comm


@pytest.mark.parametrize("name", FORWARDERS)
def test_forwarder_asked_for_cuda_without_a_card_raises(data, shards, name):
    """No silent fallback: the forwarders' default device is cuda."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.core import (dem_from_sources, fedgengmm_from_sources,
                                  fit_gmm_streaming,
                                  train_locals_from_sources)
    x, _ = data
    calls = {
        "fit_gmm_streaming": lambda: fit_gmm_streaming(0, x, 3),
        "fedgengmm_from_sources": lambda: fedgengmm_from_sources(
            0, shards, k_clients=2, k_global=2),
        "dem_from_sources": lambda: dem_from_sources(0, shards, 2),
        "train_locals_from_sources": lambda: train_locals_from_sources(
            0, shards, k=2),
        "federated_kmeans_from_sources":
            lambda: federated_kmeans_from_sources(0, shards, 2),
    }
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="cuda"):
            calls[name]()
