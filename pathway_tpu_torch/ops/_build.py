"""Build the port's CUDA kernels from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``_build/lib<name>-<hash>.so`` (the hash
is of the source, so an edited source never loads a stale library), and
is loaded with ``ctypes``. The build happens at first use; ``build_all``
starts one ``nvcc`` per source at once. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA toolkit is needed to build the kernels"
        )
    return path


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (proc or None, tmp path, final path, log path)."""
    src, out = _target(name)
    log = os.path.join(BUILD_DIR, f"{name}.log")
    if os.path.exists(out):
        return None, None, out, log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=lf, stderr=subprocess.STDOUT,
        )
    return proc, tmp, out, log


def _finish(name: str, proc, tmp: str | None, out: str, log: str) -> str:
    if proc is not None:
        if proc.wait() != 0:
            with open(log) as f:
                raise RuntimeError(f"nvcc failed for {name}:\n{f.read()}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` in parallel; returns name -> library."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, *st) for name, st in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_finish(name, *_start(name)))
        return lib
