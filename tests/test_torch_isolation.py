"""The port stands alone: no file of ``src/repro_torch`` imports JAX or the
JAX package, the package imports with ``jax`` blocked, and its entry points
run on CUDA unless asked for the CPU (raising where there is no card)."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import FedGenGMM, GMMEstimator
from repro_torch.core.config import FitConfig, resolve_backend
from repro_torch.kernels import estep_stats, gmm_logpdf, kmeans_assign, ops

PKG = Path(repro_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_file_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    bad = []
    for f in files:
        for mod in _imported_modules(ast.parse(f.read_text(), str(f))):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{f.relative_to(PKG)}: {mod}")
    assert not bad, bad


EXAMPLES = PKG.parents[1] / "examples" / "torch"


def test_examples_import_only_the_port_torch_numpy_and_the_stdlib():
    """``examples/torch/*.py`` import ``repro_torch``, ``torch``, ``numpy``
    and the standard library, never JAX, the JAX package or the JAX
    package's benchmarks."""
    files = sorted(EXAMPLES.glob("*.py"))
    assert len(files) == 7
    allowed = {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    bad = []
    for f in files:
        for mod in _imported_modules(ast.parse(f.read_text(), str(f))):
            if mod.split(".")[0] not in allowed:
                bad.append(f"{f.name}: {mod}")
    assert not bad, bad


def test_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None"
            "\nimport importlib\n"
            f"for m in {names!r}: importlib.import_module(m)\n"
            "assert not [m for m, v in sys.modules.items()\n"
            "            if m.split('.')[0] in ('jax', 'repro') and v]\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(names) >= 15


def test_entry_points_default_to_cuda():
    x = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    assert FitConfig().device == "cuda"
    if torch.cuda.is_available():
        assert FitConfig().resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        FitConfig().resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        GMMEstimator(2).fit(x)
    from repro_torch.core.partition import partition
    split = partition(np.random.default_rng(0), x, np.arange(50) % 2, 2,
                      "dirichlet", 1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        FedGenGMM(k_clients=2, k_global=2).run(split)


def test_backend_resolution():
    cpu = torch.device("cpu")
    assert resolve_backend("auto", cpu) == "reference"
    assert resolve_backend("fused", cpu) == "fused"
    assert resolve_backend("fused", cpu, fused_supported=False) == "reference"
    with pytest.raises(ValueError):
        resolve_backend("pallas", cpu)
    with pytest.raises(ValueError):
        FitConfig(device="tpu")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers compute without launching anything."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(20, 3)), dtype=torch.float32)
    mu = torch.as_tensor(rng.normal(size=(4, 3)), dtype=torch.float32)
    counts = (gmm_logpdf.launches, gmm_logpdf.log_prob_launches,
              estep_stats.launches, kmeans_assign.launches)
    ops.gmm_logpdf(x, mu, torch.ones(4, 3))
    ops.gmm_log_prob(x, mu, torch.ones(4, 3), torch.full((4,), -1.3863))
    ops.estep_stats(x, mu, torch.ones(4, 3), torch.full((4,), -1.3863))
    ops.kmeans_assign(x, mu)
    assert counts == (gmm_logpdf.launches, gmm_logpdf.log_prob_launches,
                      estep_stats.launches, kmeans_assign.launches)


def test_auto_backend_raises_on_a_card_other_than_hopper(monkeypatch):
    """``auto`` gives way to the plain path only on the CPU: a CUDA card
    that is not 9.x raises instead of quietly running eager ops."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="backend='reference'"):
        resolve_backend("auto", cuda)
    assert resolve_backend("reference", cuda) == "reference"
    assert resolve_backend("auto", cuda, fused_supported=False) == "reference"
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    assert resolve_backend("auto", cuda) == "fused"


SUBSTRATE = ("repro_torch.models", "repro_torch.configs",
             "repro_torch.monitor", "repro_torch.launch",
             "repro_torch.data.tokens")


def test_substrate_imports_with_jax_blocked():
    """The transformer substrate's sub-packages are walked by
    test_imports_with_jax_blocked; here each imports alone in a process
    where ``jax`` and ``repro`` cannot be imported."""
    names = [m.name for m in pkgutil.walk_packages([str(PKG)], "repro_torch.")]
    for pkg in SUBSTRATE:
        assert pkg in names
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None"
            "\nimport importlib\n"
            f"for m in {SUBSTRATE!r}: importlib.import_module(m)\n"
            "import repro_torch.launch.serve, "
            "repro_torch.monitor.activation_monitor\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_substrate_entry_points_default_to_cuda():
    """The model, its cache, the serving loop and the monitor run on CUDA
    unless asked for the CPU, and raise where there is no card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models import init_cache, init_params
    from repro_torch.monitor import FedGMMMonitor, feature_projection
    from repro_torch.monitor import MonitorConfig
    cfg = get_config("internlm2-1.8b", "smoke")
    model = init_params(0, cfg, device="cpu")
    if torch.cuda.is_available():
        assert init_params(0, cfg).device.type == "cuda"
        assert FedGMMMonitor(cfg).device.type == "cuda"
        return
    for call in (lambda: init_params(0, cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: ServeEngine(cfg, model),
                 lambda: FedGMMMonitor(cfg),
                 lambda: feature_projection(cfg, MonitorConfig())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
