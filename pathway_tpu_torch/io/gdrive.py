"""pw.io.gdrive — Google Drive source (reference:
python/pathway/io/gdrive — recursive directory scan over the Drive v3
API with modifiedTime diffing and deletion detection).

Redesigned transport: no google-api-python-client — the Drive v3 REST
API is driven directly over urllib (files.list with a parent query,
files/{id}?alt=media downloads), authenticated by the installed
google-auth service-account credentials (or any object with a
``token``/``refresh`` interface, or a raw bearer token for tests).
"""

from __future__ import annotations

import fnmatch
import json as _json
import urllib.parse
import urllib.request
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.io._gauth import bearer_token
from pathway_tpu_torch.io._objstore import ObjectStoreSubject
from pathway_tpu_torch.io.python import read as python_read

__all__ = ["read"]

_FIELDS = "id,name,mimeType,parents,modifiedTime,size,trashed"
_FOLDER = "application/vnd.google-apps.folder"


class _DriveClient:
    def __init__(self, credentials, endpoint=None, opener=None):
        self.credentials = credentials
        self.endpoint = (endpoint or "https://www.googleapis.com/drive/v3").rstrip("/")
        self._opener = opener or urllib.request.build_opener()

    def _token(self) -> str:
        return bearer_token(self.credentials)

    def _get(self, path: str, query: dict | None = None) -> bytes:
        qs = f"?{urllib.parse.urlencode(query)}" if query else ""
        req = urllib.request.Request(
            f"{self.endpoint}{path}{qs}",
            headers={"Authorization": f"Bearer {self._token()}"},
        )
        with self._opener.open(req, timeout=60) as resp:
            return resp.read()

    def list_children(self, folder_id: str) -> list[dict]:
        items, token = [], None
        while True:
            query = {
                "q": f"'{folder_id}' in parents and trashed = false",
                "fields": f"nextPageToken, files({_FIELDS})",
                "pageSize": "1000",
            }
            if token:
                query["pageToken"] = token
            payload = _json.loads(self._get("/files", query))
            items.extend(payload.get("files", []))
            token = payload.get("nextPageToken")
            if not token:
                return items

    def get_file(self, file_id: str) -> dict:
        return _json.loads(
            self._get(f"/files/{file_id}", {"fields": _FIELDS})
        )

    def download(self, file_id: str) -> bytes:
        return self._get(f"/files/{file_id}", {"alt": "media"})


class _GDriveSubject(ObjectStoreSubject):
    """fmt='binary' object-store scan over Drive file ids: the shared
    scanner owns modified-diffing, RETRACTION of previous rows on
    change, deletion detection, and snapshot bookkeeping."""

    _scheme = "gdrive"

    def __init__(self, client, object_id, mode, refresh_interval,
                 with_metadata, object_size_limit, patterns):
        super().__init__("binary", with_metadata, mode, refresh_interval)
        self.client = client
        self.object_id = object_id
        self.object_size_limit = object_size_limit
        self.patterns = patterns

    def _walk(self):
        """Yield file entries under object_id (dirs recursed)."""
        root = self.client.get_file(self.object_id)
        if root.get("mimeType") != _FOLDER:
            yield root
            return
        stack = [self.object_id]
        while stack:
            for entry in self.client.list_children(stack.pop()):
                if entry.get("mimeType") == _FOLDER:
                    stack.append(entry["id"])
                else:
                    yield entry

    def _accepts(self, entry: dict) -> bool:
        if self.object_size_limit is not None:
            size = int(entry.get("size", 0) or 0)
            if size > self.object_size_limit:
                return False
        if self.patterns:
            return any(
                fnmatch.fnmatch(entry.get("name", ""), p)
                for p in self.patterns
            )
        return True

    def _list(self):
        for entry in self._walk():
            if not self._accepts(entry):
                continue
            extras = {
                k: entry.get(k)
                for k in ("id", "name", "mimeType", "parents", "modifiedTime")
            }
            yield entry["id"], entry.get("modifiedTime", ""), extras

    def _get(self, name: str) -> bytes:
        return self.client.download(name)

    def _uri(self, name: str) -> str:
        return f"gdrive:{name}"


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    object_size_limit: int | None = None,
    refresh_interval: int = 30,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    file_name_pattern: list | str | None = None,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    _credentials=None,
    _endpoint=None,
    _opener=None,
):
    """Read a Google Drive file or directory (recursively) as binary
    rows (reference: io/gdrive/__init__.py:336 — streaming re-scans
    every refresh_interval with upserts and deletion detection)."""
    if mode not in ("streaming", "static"):
        raise ValueError(f"Unrecognized connector mode: {mode}")
    credentials = _credentials
    if credentials is None:
        if service_user_credentials_file is None:
            raise ValueError(
                "pw.io.gdrive.read needs service_user_credentials_file"
            )
        from google.oauth2 import service_account

        credentials = service_account.Credentials.from_service_account_file(
            service_user_credentials_file,
            scopes=["https://www.googleapis.com/auth/drive.readonly"],
        )
    patterns = (
        [file_name_pattern]
        if isinstance(file_name_pattern, str)
        else list(file_name_pattern or [])
    )
    client = _DriveClient(credentials, endpoint=_endpoint, opener=_opener)
    cols: dict[str, Any] = {"data": dt.BYTES}
    if with_metadata:
        cols["_metadata"] = dt.JSON
    subject = _GDriveSubject(
        client, object_id, mode, refresh_interval, with_metadata,
        object_size_limit, patterns,
    )
    return python_read(
        subject,
        schema=schema_from_types(**cols),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"gdrive:{object_id}",
    )
