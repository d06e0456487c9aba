"""The port's package-level surface against the JAX package's: every name
of each subpackage's ``__all__`` resolves in the port's, ``repro_torch.api``
is the reference's frozen snapshot (``tests/test_api_surface.py``), the
``FitConfig`` field table is the reference's plus ``device``, the facades
take ``seed`` where the reference takes ``key``, and no deprecated
forwarder leaks into the facade."""
import dataclasses
import importlib
import inspect
import types

import pytest
import torch

import repro_torch.api as api
from repro_torch.api import FitConfig

from test_api_surface import (EXPECTED_EXPORTS, EXPECTED_FITCONFIG_FIELDS,
                              SHIM_NAMES)

SUBPACKAGES = ["api", "core", "data", "kernels", "configs", "models", "optim",
               "fed", "serve", "distributed", "launch", "monitor",
               "checkpoint"]

# Names of the reference's ``__all__`` that the port leaves out of its own,
# and why. ``repro.core`` binds ``kmeans``, ``dem`` and ``partition`` to
# functions that shadow its submodules of those names (ROADMAP R4); the port
# keeps the three names bound to its submodules, whose functions are
# ``kmeans.kmeans``, ``dem.dem`` and ``partition.partition``. Nothing else.
NOT_EXPORTED = {"core": {"kmeans": "kmeans", "dem": "dem",
                         "partition": "partition"}}

# Names the port exports with another kind of object than the reference.
# ``repro.kernels`` binds its kernels' model-level functions over its
# submodules of the same names, as ``repro.core`` does; the port's names are
# its launch-wrapper modules (each with its ``launches`` count), and the
# functions are ``repro_torch.kernels.ops.<name>``.
EXPORTED_AS_MODULE = {"kernels": ("estep_stats", "gmm_logpdf",
                                  "kmeans_assign")}


def _kind(obj) -> str:
    if isinstance(obj, types.ModuleType):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if callable(obj):
        return "callable"
    return "value"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_reference_name_resolves_in_the_port(sub):
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    skipped = NOT_EXPORTED.get(sub, {})
    as_module = EXPORTED_AS_MODULE.get(sub, ())
    port_all = set(getattr(port, "__all__", ()))
    for name in getattr(ref, "__all__", ()):
        if name in skipped:
            mod = getattr(port, name)
            assert isinstance(mod, types.ModuleType), name
            assert mod.__name__ == f"repro_torch.{sub}.{name}"
            assert callable(getattr(mod, skipped[name]))
            assert name not in port_all
            continue
        assert name in port_all, f"repro_torch.{sub}.__all__ lacks {name}"
        obj = getattr(port, name, None)
        assert obj is not None, f"repro_torch.{sub}.{name} does not resolve"
        if name in as_module:
            assert isinstance(obj, types.ModuleType), name
            ops = importlib.import_module(f"repro_torch.{sub}.ops")
            assert callable(getattr(ops, name))
            continue
        assert _kind(obj) == _kind(getattr(ref, name)), (sub, name)
    for name in port_all:
        assert getattr(port, name, None) is not None, (sub, name)


def test_star_import_of_core_resolves_every_name():
    namespace = {}
    exec("from repro_torch.core import *", namespace)
    import repro.core as ref
    missing = set(ref.__all__) - set(namespace) - set(NOT_EXPORTED["core"])
    assert not missing


def test_api_all_matches_the_reference_snapshot():
    assert sorted(api.__all__) == EXPECTED_EXPORTS
    import repro.api as ref
    assert sorted(api.__all__) == sorted(ref.__all__)
    assert api.DEFAULT_SOURCE_CHUNK == ref.DEFAULT_SOURCE_CHUNK


def test_api_has_no_extra_public_names():
    public = {n for n in dir(api) if not n.startswith("_")
              and n not in ("estimators", "serving")}
    assert public - set(api.__all__) == set()


def test_fitconfig_fields_are_the_reference_table_then_device():
    fields = [(f.name, f.default) for f in dataclasses.fields(FitConfig)]
    assert fields == EXPECTED_FITCONFIG_FIELDS + [("device", "cuda")]


def test_fitconfig_resolved_helpers():
    import repro.core.config as ref
    cfg = FitConfig(device="cpu")
    for algorithm in ("em", "kmeans"):
        got = cfg.resolved_for(algorithm)
        want = ref.FitConfig().resolved_for(algorithm)
        assert (got.tol, got.max_iter) == (want.tol, want.max_iter)
        assert got == got.resolved_for(algorithm)
    assert FitConfig(tol=0.5, device="cpu").resolved_for("kmeans").tol == 0.5
    assert cfg.resolved_backend() == "reference"
    assert cfg.replace(backend="fused").resolved_backend() == "fused"
    assert cfg.replace(backend="fused").resolved_backend(False) == \
        "reference"
    assert cfg.replace(backend="fused").resolved_estep() == "fused"
    full = cfg.replace(backend="fused", covariance_type="full")
    assert full.resolved_estep() == "reference"
    assert full.resolved_estep(is_diagonal=True) == "fused"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FitConfig().resolved_backend()
        with pytest.raises(RuntimeError, match="cuda"):
            FitConfig().resolved_estep()


@pytest.mark.parametrize("cls", ["GMMEstimator", "KMeansEstimator"])
def test_fit_takes_seed_where_the_reference_takes_key(cls):
    import repro.api as ref
    want = [("seed" if p == "key" else p) for p in
            inspect.signature(getattr(ref, cls).fit).parameters]
    assert list(inspect.signature(getattr(api, cls).fit).parameters) == want
    assert "key" not in inspect.signature(getattr(api, cls).fit).parameters


@pytest.mark.parametrize("cls", ["FedGenGMM", "DEM", "FedEM", "FedKMeans"])
def test_run_takes_seed_where_the_reference_takes_key(cls):
    import repro.api as ref
    want = [("seed" if p == "key" else p) for p in
            inspect.signature(getattr(ref, cls).run).parameters]
    assert list(inspect.signature(getattr(api, cls).run).parameters) == want
    assert list(inspect.signature(getattr(api, cls).__init__).parameters) \
        == list(inspect.signature(getattr(ref, cls).__init__).parameters)


def test_fit_federated_takes_seed_where_the_reference_takes_key():
    import repro.api as ref
    want = [("seed" if p == "key" else p) for p in
            inspect.signature(ref.fit_federated).parameters]
    assert list(inspect.signature(api.fit_federated).parameters) == want


@pytest.mark.parametrize("name", SHIM_NAMES)
def test_forwarder_does_not_leak_into_the_facade(name):
    assert name not in api.__all__
    assert not hasattr(api, name)
    assert name not in {f.name for f in dataclasses.fields(FitConfig)}


@pytest.mark.parametrize("name", SHIM_NAMES)
def test_forwarder_keeps_the_reference_keywords(name):
    """The reference's keyword set, ``key`` as ``seed``, plus ``device``."""
    import repro.core as ref
    import repro_torch.core as port
    want = [("seed" if p == "key" else p) for p in
            inspect.signature(getattr(ref, name)).parameters] + ["device"]
    got = list(inspect.signature(getattr(port, name)).parameters)
    assert got == want
    assert inspect.signature(getattr(port, name)).parameters[
        "device"].default == "cuda"
