"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which is loaded with ``ctypes``.
A library is built at its first use, into ``build/repro_torch_kernels/`` at
the root of the checkout (listed in ``.gitignore``), under a name that
hashes the source, the headers it includes and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per source, all at once, and waits for
them. A failed build raises, and so does every launch whose returned
``cudaError_t`` is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gmm_logpdf", "estep_stats", "kmeans_assign")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
# Guards the wrappers' launch counts, which client workers bump from
# several threads (a bare ``+= 1`` can lose an update between threads).
COUNT_LOCK = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly or
    through another header, in the order first met."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists() and dep not in found:
                found.append(dep)
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name hashes
    the source, its headers and the flags."""
    h = hashlib.sha256()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Build every named library that is not built yet, one ``nvcc`` each,
    all started together. Returns the seconds each build took (0.0 for a
    library that was already there). The compiler's resource report
    (``-Xptxas=-v``) is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, path, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, path, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        path.with_suffix(".so.log").write_text(log)
        os.replace(tmp, path)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for one built library ('' if none)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of library ``name``, built and loaded on
    first use, with its argument types set (pointers and the stream as
    ``c_void_p``, so that no 64-bit value is cut to an int)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = _libs[name].kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code}: {msg}")


def require(t: torch.Tensor, what: str, shape: tuple, device: torch.device,
            dtype=torch.float32) -> None:
    """Check one kernel operand: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
