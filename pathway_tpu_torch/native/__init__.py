"""Native C++ runtime components — build + ctypes bindings.

The reference's native core is Rust (tantivy BM25, usearch HNSW,
brute-force ndarray KNN — src/external_integration/). Here the host-side
index runtimes are C++ (native/bm25.cpp, native/hnsw.cpp) compiled once
into a shared library and bound via ctypes; the dense brute-force path
stays on the card (pathway_tpu_torch.ops). Pure-Python fallbacks keep
everything working when no toolchain is present.

The sources are the repository's own ``native/`` directory, shared with
the JAX package; this package builds them into its own git-ignored
``pathway_tpu_torch/_build/native/``. Each artifact is compiled under a
temporary name and renamed into place, so processes that build at once
(test workers) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
from typing import Any, Sequence

import numpy as np

_REPO_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
# override point for instrumented builds (PATHWAY_NATIVE_BUILD_DIR, which
# the JAX package reads too): this package builds into a ``torch``
# subdirectory of it, since the two packages' extensions share file names
# but import different engine modules
_OVERRIDE = os.environ.get("PATHWAY_NATIVE_BUILD_DIR")
_BUILD_DIR = os.path.join(_OVERRIDE, "torch") if _OVERRIDE else os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build", "native"
)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _newest_mtime(src_dir: str, src: str) -> float:
    """Staleness input for an extension build: the source file plus any
    shared headers it includes (pw_blake2b.h) — a header-only change must
    trigger a rebuild too."""
    newest = os.path.getmtime(src)
    hdr = os.path.join(src_dir, "pw_blake2b.h")
    if os.path.exists(hdr):
        newest = max(newest, os.path.getmtime(hdr))
    return newest


def _compile(cmd: list[str], out: str, timeout: int) -> None:
    """Run the compiler ``cmd`` into a temporary file beside ``out`` and
    rename it onto ``out`` (atomic on one filesystem)."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            [*cmd, "-o", tmp], check=True, capture_output=True, timeout=timeout
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _package_source(src: str) -> str:
    """A copy of the shared C source ``src`` in the build directory whose
    module imports name this package: the extension looks up the engine's
    Python modules by their dotted names, which in the shared source are
    the JAX package's."""
    with open(src, encoding="utf-8") as f:
        text = f.read()
    text = text.replace('"pathway_tpu.', '"pathway_tpu_torch.')
    dst = os.path.join(_BUILD_DIR, os.path.basename(src))
    tmp = f"{dst}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, dst)
    return dst


def _sources() -> list[str]:
    src_dir = _REPO_NATIVE
    if not os.path.isdir(src_dir):
        # installed layout: sources shipped next to this package
        src_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    return [
        os.path.join(src_dir, "bm25.cpp"),
        os.path.join(src_dir, "hnsw.cpp"),
    ]


def _build() -> str | None:
    sources = _sources()
    if not all(os.path.exists(s) for s in sources):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, "libpathway_native.so")
    stamp = os.path.join(_BUILD_DIR, "build.stamp")
    newest_src = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(out) and os.path.exists(stamp):
        if os.path.getmtime(stamp) >= newest_src:
            return out
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *sources]
    try:
        _compile(cmd, out, 180)
    except Exception:
        return None
    tmp = f"{stamp}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("ok")
    os.replace(tmp, stamp)
    return out


def get_lib() -> ctypes.CDLL | None:
    """Compile-on-first-use; None when no toolchain (callers fall back)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.bm25_new.restype = ctypes.c_void_p
        lib.bm25_new.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.bm25_free.argtypes = [ctypes.c_void_p]
        lib.bm25_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        lib.bm25_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.bm25_len.restype = ctypes.c_int64
        lib.bm25_len.argtypes = [ctypes.c_void_p]
        lib.bm25_search.restype = ctypes.c_int64
        lib.bm25_search.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ]
        lib.hnsw_new.restype = ctypes.c_void_p
        lib.hnsw_new.argtypes = [ctypes.c_int32] * 5
        lib.hnsw_free.argtypes = [ctypes.c_void_p]
        lib.hnsw_add.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
        ]
        if hasattr(lib, "hnsw_add_batch"):
            lib.hnsw_add_batch.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
            ]
        lib.hnsw_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.hnsw_len.restype = ctypes.c_int64
        lib.hnsw_len.argtypes = [ctypes.c_void_p]
        lib.hnsw_search.restype = ctypes.c_int64
        lib.hnsw_search.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


_FASTPATH = None
_FASTPATH_TRIED = False


def get_fastpath():
    """CPython extension with the engine's per-row hot loops
    (native/fastpath.c); None when no toolchain — callers fall back to the
    pure-Python implementations."""
    global _FASTPATH, _FASTPATH_TRIED
    with _LOCK:
        if _FASTPATH_TRIED:
            return _FASTPATH
        _FASTPATH_TRIED = True
        src_dir = _REPO_NATIVE if os.path.isdir(_REPO_NATIVE) else os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "src"
        )
        src = os.path.join(src_dir, "fastpath.c")
        if not os.path.exists(src):
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        out = os.path.join(_BUILD_DIR, "fastpath" + suffix)
        if not (
            os.path.exists(out)
            and os.path.getmtime(out) >= _newest_mtime(src_dir, src)
        ):
            include = sysconfig.get_paths()["include"]
            try:
                src = _package_source(src)
            except OSError:
                return None
            cmd = [
                "gcc", "-O3", "-shared", "-fPIC", f"-I{include}",
                f"-I{src_dir}", src,
            ]
            try:
                _compile(cmd, out, 120)
            except Exception:
                return None
        import importlib.util

        spec = importlib.util.spec_from_file_location("fastpath", out)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception:
            return None
        _FASTPATH = mod
        return _FASTPATH


_PWEXEC = None
_PWEXEC_TRIED = False


def get_pwexec():
    """CPython extension with the sharded native group-by executor
    (native/exec.cpp) — the multi-worker relational engine core. None when
    no toolchain; callers fall back to the Python operator path."""
    global _PWEXEC, _PWEXEC_TRIED
    with _LOCK:
        if _PWEXEC_TRIED:
            return _PWEXEC
        _PWEXEC_TRIED = True
        src_dir = _REPO_NATIVE if os.path.isdir(_REPO_NATIVE) else os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "src"
        )
        src = os.path.join(src_dir, "exec.cpp")
        if not os.path.exists(src):
            return None
        os.makedirs(_BUILD_DIR, exist_ok=True)
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        out = os.path.join(_BUILD_DIR, "pwexec" + suffix)
        if not (
            os.path.exists(out)
            and os.path.getmtime(out) >= _newest_mtime(src_dir, src)
        ):
            include = sysconfig.get_paths()["include"]
            cmd = [
                "g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-pthread",
                f"-I{include}", src,
            ]
            try:
                _compile(cmd, out, 180)
            except Exception as exc:
                # a failed build silently drops the whole native executor
                # (group-by/join fall back to pure Python) — make the
                # degradation visible. g++ 10 works (exec.cpp gates its
                # C++20 library uses); g++ < 10 rejects -std=c++20
                import logging

                stderr = getattr(exc, "stderr", None) or b""
                logging.getLogger(__name__).warning(
                    "native executor build failed (%s): %s",
                    exc,
                    stderr[-500:],
                )
                return None
        import importlib.util

        spec = importlib.util.spec_from_file_location("pwexec", out)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        except Exception:
            return None
        _PWEXEC = mod
        return _PWEXEC


class NativeBm25:
    """ctypes wrapper over the C++ BM25 index. int64 handles are minted
    per key by the caller (KeyToU64IdMapper pattern, reference
    external_integration/mod.rs)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.bm25_new(k1, b)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bm25_free(self._h)
            self._h = None

    def add(self, key: int, text: str) -> None:
        self._lib.bm25_add(self._h, key, text.encode("utf-8", "replace"))

    def remove(self, key: int) -> None:
        self._lib.bm25_remove(self._h, key)

    def __len__(self) -> int:
        return self._lib.bm25_len(self._h)

    def search(self, query: str, k: int) -> list[tuple[int, float]]:
        n = max(k, 0)
        keys = (ctypes.c_int64 * n)()
        scores = (ctypes.c_double * n)()
        got = self._lib.bm25_search(
            self._h, query.encode("utf-8", "replace"), n, keys, scores
        )
        return [(keys[i], scores[i]) for i in range(got)]


_METRICS = {"cos": 0, "l2sq": 1, "ip": 2, "dot": 2}


class NativeHnsw:
    """ctypes wrapper over the C++ HNSW ANN index (usearch equivalent)."""

    def __init__(self, dim: int, metric: str = "cos", *, M: int = 16,
                 ef_build: int = 128, ef_search: int = 64):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dim = dim
        self._h = lib.hnsw_new(dim, _METRICS[metric], M, ef_build, ef_search)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None

    def add(self, key: int, vec) -> None:
        v = np.ascontiguousarray(vec, dtype=np.float32)
        self._lib.hnsw_add(
            self._h, key, v.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )

    def add_batch(self, keys, vecs) -> None:
        """Insert n rows in ONE library crossing (the
        one-doc-per-dispatch ann build was dominated by per-row call
        overhead). Falls back to per-row adds on a stale library built
        before the batch entry point existed."""
        ks = np.ascontiguousarray(keys, dtype=np.int64)
        vs = np.ascontiguousarray(vecs, dtype=np.float32)
        if vs.ndim != 2 or vs.shape[0] != ks.shape[0]:
            raise ValueError("keys/vectors shape mismatch")
        if not hasattr(self._lib, "hnsw_add_batch"):
            for k, v in zip(ks, vs):
                self.add(int(k), v)
            return
        self._lib.hnsw_add_batch(
            self._h,
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ks.shape[0],
        )

    def remove(self, key: int) -> None:
        self._lib.hnsw_remove(self._h, key)

    def __len__(self) -> int:
        return self._lib.hnsw_len(self._h)

    def search(self, vec, k: int) -> list[tuple[int, float]]:
        v = np.ascontiguousarray(vec, dtype=np.float32)
        n = max(k, 0)
        keys = (ctypes.c_int64 * n)()
        scores = (ctypes.c_double * n)()
        got = self._lib.hnsw_search(
            self._h, v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, keys, scores,
        )
        return [(keys[i], scores[i]) for i in range(got)]
