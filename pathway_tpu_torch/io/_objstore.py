"""Shared object-store polling scanner (reference:
src/connectors/scanner/s3.rs:268 + posix_like.rs:301 — object polling
with metadata diffing and deletion detection).

One scan protocol for every object store (GCS, S3, MinIO, ...): a
subclass supplies listing, download and identity; this base owns the
incremental semantics — changed objects (by stamp) retract their
previous rows before re-emitting, deleted objects retract, bookkeeping
is updated only after emission so flush snapshots never claim rows they
lack (io/_connector.py commit-boundary protocol).
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json as _json
import time
from typing import Any, Iterable

from pathway_tpu_torch.internals.api import Json, ref_scalar
from pathway_tpu_torch.io.python import ConnectorSubject


def parse_object_bytes(data: bytes, fmt: str) -> list[dict]:
    """Object payload -> rows, by connector format name."""
    rows: list[dict] = []
    if fmt in ("csv", "dsv"):
        for rec in _csv.DictReader(_io.StringIO(data.decode("utf-8", "replace"))):
            rows.append(dict(rec))
    elif fmt in ("json", "jsonlines"):
        for line in data.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if line:
                rows.append(_json.loads(line))
    elif fmt == "plaintext":
        for line in data.decode("utf-8", "replace").splitlines():
            rows.append({"data": line})
    elif fmt in ("plaintext_by_object", "plaintext_by_file"):
        rows.append({"data": data.decode("utf-8", "replace")})
    elif fmt == "binary":
        rows.append({"data": data})
    else:
        raise ValueError(f"unknown format {fmt!r}")
    return rows


class ObjectStoreSubject(ConnectorSubject):
    """Subclasses implement `_list`/`_get`/`_uri` and set `_scheme`."""

    _scheme = "obj"

    def __init__(self, fmt, with_metadata, mode, refresh_interval=5.0):
        super().__init__()
        self.fmt = fmt
        self.with_metadata = with_metadata
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._seen: dict[str, Any] = {}      # object -> stamp
        self._emitted: dict[str, list] = {}  # object -> [(key, row)]
        self._stop = False

    # -- store interface ---------------------------------------------------
    def _list(self) -> Iterable[tuple[str, Any, dict]]:
        """Yield (name, change_stamp, metadata_extras) per live object."""
        raise NotImplementedError

    def _get(self, name: str) -> bytes:
        raise NotImplementedError

    def _uri(self, name: str) -> str:
        raise NotImplementedError

    # -- scan protocol -----------------------------------------------------
    def _scan_once(self):
        current = set()
        for name, stamp, extras in self._list():
            current.add(name)
            if self._seen.get(name) == stamp:
                continue
            try:
                data = self._get(name)
            except Exception:
                # object vanished between list and download: the next
                # poll's deletion path retracts it; don't kill the pipeline
                continue
            for old_key, old_row in self._emitted.pop(name, []):
                self._remove(old_key, old_row)
            rows = parse_object_bytes(data, self.fmt)
            if self.with_metadata:
                meta = {
                    "path": self._uri(name),
                    "size": len(data),
                    "seen_at": int(time.time()),
                    **extras,
                }
                for r in rows:
                    r["_metadata"] = Json(meta)
            keyed = [
                (ref_scalar(self._scheme, self._uri(name), i), row)
                for i, row in enumerate(rows)
            ]
            for key, row in keyed:
                self._upsert(key, row)
            # bookkeeping after emission: flush snapshots stay consistent
            self._emitted[name] = keyed
            self._seen[name] = stamp
        for name in list(self._emitted):
            if name not in current:
                for old_key, old_row in self._emitted.pop(name, []):
                    self._remove(old_key, old_row)
                self._seen.pop(name, None)
        self.commit()

    def run(self):
        self._scan_once()
        if self.mode == "static":
            return
        while not self._stop:
            time.sleep(self.refresh_interval)
            self._scan_once()

    def on_stop(self):
        self._stop = True

    def snapshot_state(self):
        return {"seen": dict(self._seen), "emitted": dict(self._emitted)}

    def seek(self, state) -> None:
        self._seen = dict(state.get("seen", {}))
        self._emitted = dict(state.get("emitted", {}))
