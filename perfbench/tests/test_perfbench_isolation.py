"""What the harness runs loads neither JAX nor the JAX package, the
reference imports nothing of the program, and nothing reads the JAX
package's ``benchmarks/``. Top-level module names are compared whole:
the port's name, ``repro_torch``, begins with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return [p for p in PKG.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "data.py", "work.py"):
        tops = {n.split(".")[0] for n in _imports(PKG / name)}
        assert "repro_torch" not in tops, name


def test_nothing_reads_the_jax_packages_benchmarks():
    for path in _sources():
        assert "benchmarks" not in path.read_text(), path


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports, in a fresh interpreter."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench import harness, calibrate, faults\n"
        "import importlib, pkgutil, perfbench.entries, perfbench.metrics\n"
        "for pkg in (perfbench.entries, perfbench.metrics):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__):\n"
        "        importlib.import_module(pkg.__name__ + '.' + m.name)\n"
        "from perfbench.entries import fedgen, dem\n"
        "import repro_torch.api, repro_torch.core.fedgen, repro_torch.core.dem\n"
        "print(harness.forbidden_modules())\n" % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
