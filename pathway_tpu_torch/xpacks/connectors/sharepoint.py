"""SharePoint source (reference:
python/pathway/xpacks/connectors/sharepoint — recursive folder scan of
a SharePoint site with modified-time diffing; certificate-based Azure
AD auth).

Redesigned transport: no office365 client — the two protocols are
implemented directly:

* auth — the Azure AD client-credentials flow with a CERTIFICATE
  assertion: an RS256 JWT whose header carries the cert's SHA-1
  thumbprint (x5t), signed with the app's private key (`cryptography`),
  posted to ``login.microsoftonline.com/{tenant}/oauth2/v2.0/token``;
* data — the SharePoint REST API:
  ``_api/web/GetFolderByServerRelativeUrl(...)?$expand=Folders,Files``
  for listing and ``GetFileByServerRelativeUrl(...)/$value`` for
  downloads.

The reference gates this behind a Scale license; entitlements here are
granted by `internals/config.py` like every other surface.
"""

from __future__ import annotations

import base64
import json as _json
import time
import urllib.parse
import urllib.request
import uuid
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.schema import schema_from_types
from pathway_tpu_torch.io._objstore import ObjectStoreSubject
from pathway_tpu_torch.io.python import read as python_read

__all__ = ["read"]


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _client_assertion(tenant: str, client_id: str, cert_path: str,
                      thumbprint: str, authority: str) -> str:
    """RS256 JWT client assertion for the certificate credential flow."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding

    with open(cert_path, "rb") as f:
        key = serialization.load_pem_private_key(f.read(), password=None)
    now = int(time.time())
    header = {
        "alg": "RS256",
        "typ": "JWT",
        "x5t": _b64url(bytes.fromhex(thumbprint.replace(":", ""))),
    }
    claims = {
        "aud": f"{authority}/{tenant}/oauth2/v2.0/token",
        "iss": client_id,
        "sub": client_id,
        "jti": str(uuid.uuid4()),
        "nbf": now - 60,
        "exp": now + 600,
    }
    signing_input = (
        _b64url(_json.dumps(header).encode())
        + "."
        + _b64url(_json.dumps(claims).encode())
    )
    signature = key.sign(
        signing_input.encode(), padding.PKCS1v15(), hashes.SHA256()
    )
    return signing_input + "." + _b64url(signature)


class _SharePointClient:
    def __init__(self, url: str, tenant: str, client_id: str,
                 cert_path: str, thumbprint: str, *,
                 authority: str | None = None, opener=None):
        self.site_url = url.rstrip("/")
        self.tenant = tenant
        self.client_id = client_id
        self.cert_path = cert_path
        self.thumbprint = thumbprint
        self.authority = (
            authority or "https://login.microsoftonline.com"
        ).rstrip("/")
        self._opener = opener or urllib.request.build_opener()
        self._token: str | None = None
        self._token_exp = 0.0

    def _host_scope(self) -> str:
        parsed = urllib.parse.urlsplit(self.site_url)
        return f"{parsed.scheme}://{parsed.netloc}/.default"

    def _get_token(self) -> str:
        if self._token is not None and time.time() < self._token_exp - 60:
            return self._token
        assertion = _client_assertion(
            self.tenant, self.client_id, self.cert_path, self.thumbprint,
            self.authority,
        )
        body = urllib.parse.urlencode(
            {
                "grant_type": "client_credentials",
                "client_id": self.client_id,
                "scope": self._host_scope(),
                "client_assertion_type": (
                    "urn:ietf:params:oauth:client-assertion-type:jwt-bearer"
                ),
                "client_assertion": assertion,
            }
        ).encode()
        req = urllib.request.Request(
            f"{self.authority}/{self.tenant}/oauth2/v2.0/token",
            data=body,
            method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"},
        )
        with self._opener.open(req, timeout=60) as resp:
            payload = _json.loads(resp.read())
        self._token = payload["access_token"]
        self._token_exp = time.time() + int(payload.get("expires_in", 3600))
        return self._token

    def _get(self, api_path: str, accept="application/json;odata=verbose"):
        req = urllib.request.Request(
            f"{self.site_url}{api_path}",
            headers={
                "Authorization": f"Bearer {self._get_token()}",
                "Accept": accept,
            },
        )
        with self._opener.open(req, timeout=60) as resp:
            return resp.read()

    def list_folder(self, server_relative_path: str) -> dict:
        quoted = urllib.parse.quote(server_relative_path, safe="/")
        raw = self._get(
            f"/_api/web/GetFolderByServerRelativeUrl('{quoted}')"
            f"?$expand=Folders,Files"
        )
        return _json.loads(raw)

    def download(self, server_relative_path: str) -> bytes:
        quoted = urllib.parse.quote(server_relative_path, safe="/")
        return self._get(
            f"/_api/web/GetFileByServerRelativeUrl('{quoted}')/$value",
            accept="application/octet-stream",
        )


def _entries(payload: dict) -> tuple[list[dict], list[str]]:
    """(files, subfolder paths) from a GetFolder response (verbose or
    minimal OData shape)."""
    d = payload.get("d", payload)

    def results(key):
        v = d.get(key) or {}
        if isinstance(v, dict):
            return v.get("results", [])
        return v

    files = results("Files")
    folders = [
        f.get("ServerRelativeUrl")
        for f in results("Folders")
        if f.get("ServerRelativeUrl")
        and not f.get("Name", "").startswith("Forms")
    ]
    return files, folders


class _SharePointSubject(ObjectStoreSubject):
    """fmt='binary' object-store scan over SharePoint server-relative
    urls: the shared scanner owns modified-diffing, RETRACTION of
    previous rows on change, deletion detection, and snapshots."""

    _scheme = "sharepoint"

    def __init__(self, client, root_path, mode, recursive, refresh_interval,
                 with_metadata, object_size_limit):
        super().__init__("binary", with_metadata, mode, refresh_interval)
        self.client = client
        self.root_path = root_path
        self.recursive = recursive
        self.object_size_limit = object_size_limit

    def _walk(self):
        stack = [self.root_path]
        while stack:
            payload = self.client.list_folder(stack.pop())
            files, folders = _entries(payload)
            yield from files
            if self.recursive:
                stack.extend(folders)

    def _list(self):
        for entry in self._walk():
            path = entry.get("ServerRelativeUrl")
            if not path:
                continue
            size = int(entry.get("Length", 0) or 0)
            if (
                self.object_size_limit is not None
                and size > self.object_size_limit
            ):
                continue
            stamp = entry.get("TimeLastModified", "")
            yield path, stamp, {
                "name": entry.get("Name"),
                "modified_at": stamp,
            }

    def _get(self, name: str) -> bytes:
        return self.client.download(name)

    def _uri(self, name: str) -> str:
        return name


def read(
    url: str,
    *,
    tenant: str,
    client_id: str,
    cert_path: str,
    thumbprint: str,
    root_path: str,
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    autocommit_duration_ms: int | None = 1500,
    name: str | None = None,
    _authority: str | None = None,
    _opener=None,
):
    """Read a SharePoint directory/file tree as binary rows (reference:
    xpacks/connectors/sharepoint/__init__.py:249 — same signature;
    streaming re-scans every refresh_interval with upserts + deletion
    detection)."""
    if mode not in ("streaming", "static"):
        raise ValueError(f"Unrecognized connector mode: {mode}")
    from pathway_tpu_torch.internals.config import _check_entitlements

    _check_entitlements("xpack-sharepoint")
    client = _SharePointClient(
        url, tenant, client_id, cert_path, thumbprint,
        authority=_authority, opener=_opener,
    )
    cols: dict[str, Any] = {"data": dt.BYTES}
    if with_metadata:
        cols["_metadata"] = dt.JSON
    subject = _SharePointSubject(
        client, root_path, mode, recursive, refresh_interval,
        with_metadata, object_size_limit,
    )
    return python_read(
        subject,
        schema=schema_from_types(**cols),
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"sharepoint:{root_path}",
    )
