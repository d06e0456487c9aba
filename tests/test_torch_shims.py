"""The port's legacy keyword fronts against their ``*_cfg`` cores on the
CPU: each shim folds its loose knobs into one ``FitConfig`` with
``FitConfig.from_legacy`` (``chunk_size=None`` meaning "auto", as in
``repro/core/config.py``) and gives the core's bits under that config. The
deprecated ``fit_gmm_streaming`` and the ``*_from_sources`` shims are not
ported; the facades take sources directly."""
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
from repro_torch.core.partition import partition

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
