"""The port held to the rules of ``tools/check_hygiene.py``, by the same AST
walks pointed at ``src/repro_torch``: no module of ``core``, ``fed`` or
``serve`` imports ``repro_torch.api`` at module top (the facade sits above
them; the deprecated forwarders import it inside the function), and every
public def, class and method of ``repro_torch.api`` and
``repro_torch.serve``, and of the user-facing ``fed/transforms.py`` and
``fed/async_runtime.py``, carries a docstring, the re-exported names of the
two packages' ``__init__`` included."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def hygiene(monkeypatch):
    """``tools/check_hygiene.py`` with its package lists pointed at the
    port."""
    spec = importlib.util.spec_from_file_location(
        "check_hygiene_for_port", ROOT / "tools" / "check_hygiene.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "LAYERED_PACKAGES", (
        "src/repro_torch/core", "src/repro_torch/fed", "src/repro_torch/serve"))
    monkeypatch.setattr(mod, "FORBIDDEN_PREFIX", "repro_torch.api")
    monkeypatch.setattr(mod, "DOC_PACKAGES", ("src/repro_torch/api",
                                              "src/repro_torch/serve"))
    monkeypatch.setattr(mod, "DOC_MODULES", (
        "src/repro_torch/fed/transforms.py",
        "src/repro_torch/fed/async_runtime.py"))
    return mod


def test_no_layer_imports_the_facade_at_module_top(hygiene):
    assert hygiene.import_cycle_violations(ROOT) == []


def test_the_walk_sees_a_top_level_facade_import(hygiene, tmp_path):
    """The rule fires on a module-level import, and not on one inside a
    function (the forwarders' pattern)."""
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("from repro_torch.api import DEM\n")
    (pkg / "good.py").write_text(
        "def f():\n    from repro_torch.api import DEM\n    return DEM\n")
    bad = hygiene.import_cycle_violations(tmp_path)
    assert len(bad) == 1 and "bad.py" in bad[0]


def test_forwarders_import_the_facade_inside_the_function():
    import ast
    for rel, fn in (("core/em.py", "fit_gmm_streaming"),
                    ("core/dem.py", "dem_from_sources"),
                    ("core/fedgen.py", "fedgengmm_from_sources")):
        tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
        (node,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                   and n.name == fn]
        mods = [n.module for n in ast.walk(node)
                if isinstance(n, ast.ImportFrom)]
        assert "repro_torch.api" in mods, fn


def test_public_names_carry_docstrings(hygiene):
    assert hygiene.docstring_violations(ROOT) == []
