"""pw.io.pyfilesystem — PyFilesystem source (reference:
python/pathway/io/pyfilesystem — walks any `fs.base.FS` object: local,
zip, tar, ftp, s3fs, memoryfs, ...).

Redesigned transport: DUCK-TYPED against the (small) PyFilesystem
surface the scanner needs — ``walk.files(path)`` (or ``listdir`` +
``isdir`` recursion), ``getmodified``/``getinfo``, ``open``/
``readbytes``. Any object implementing those works, including the real
``fs`` library's objects when installed; the connector itself carries no
dependency on it.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.io._objstore import ObjectStoreSubject
from pathway_tpu_torch.io.python import read as python_read

__all__ = ["read"]


def _iter_files(source, path: str):
    """All file paths under `path`, recursively. Prefers the PyFilesystem
    walker; falls back to listdir/isdir recursion for minimal fakes."""
    walk = getattr(source, "walk", None)
    if walk is not None and hasattr(walk, "files"):
        yield from walk.files(path=path or "/")
        return
    base = (path or "/").rstrip("/")
    stack = [base or "/"]
    while stack:
        cur = stack.pop()
        for name in source.listdir(cur):
            full = f"{cur.rstrip('/')}/{name}"
            if source.isdir(full):
                stack.append(full)
            else:
                yield full


def _read_bytes(source, path: str) -> bytes:
    if hasattr(source, "readbytes"):
        return source.readbytes(path)
    with source.open(path, "rb") as f:
        data = f.read()
    if isinstance(data, str):
        data = data.encode("utf-8")
    return data


class _PyFsSubject(ObjectStoreSubject):
    """fmt='binary' object-store scan over a PyFilesystem-like source:
    the shared scanner owns modified-diffing, RETRACTION of previous
    rows on change, deletion detection, and snapshot bookkeeping."""

    _scheme = "pyfs"

    def __init__(self, source, path, mode, refresh_interval, with_metadata):
        super().__init__("binary", with_metadata, mode, refresh_interval)
        self.source = source
        self.path = path

    def _stat(self, path):
        """(stamp, metadata extras); files vanished between walk and
        stat are skipped (the scanner's deletion pass retracts them)."""
        try:
            info = self.source.getinfo(
                path, namespaces=["basic", "details", "access"]
            )
        except Exception:
            return None
        extras: dict[str, Any] = {}
        for field, attr in (
            ("created_at", "created"),
            ("modified_at", "modified"),
            ("accessed_at", "accessed"),
        ):
            ts = getattr(info, attr, None)
            extras[field] = int(ts.timestamp()) if ts is not None else None
        extras["owner"] = getattr(info, "user", None)
        extras["name"] = getattr(info, "name", None)
        if hasattr(self.source, "getmodified"):
            try:
                stamp = self.source.getmodified(path)
            except Exception:
                return None
        else:
            stamp = extras["modified_at"]
        return stamp, extras

    def _list(self):
        for p in _iter_files(self.source, self.path):
            stat = self._stat(p)
            if stat is None:
                continue
            stamp, extras = stat
            yield p, stamp, extras

    def _get(self, name: str) -> bytes:
        return _read_bytes(self.source, name)

    def _uri(self, name: str) -> str:
        return name


def read(
    source,
    *,
    path: str = "",
    refresh_interval: float = 30,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
):
    """Read every file under `path` of a PyFilesystem-like source as a
    binary `data` column (reference: io/pyfilesystem/__init__.py:142 —
    streaming mode re-scans every refresh_interval with upserts and
    deletion detection)."""
    if mode not in ("streaming", "static"):
        raise ValueError(f"Unrecognized connector mode: {mode}")
    cols: dict[str, Any] = {"data": dt.BYTES}
    if with_metadata:
        cols["_metadata"] = dt.JSON
    subject = _PyFsSubject(source, path, mode, refresh_interval, with_metadata)
    return python_read(
        subject,
        schema=schema_from_types(**cols),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or "pyfilesystem",
    )
