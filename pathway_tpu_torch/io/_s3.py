"""Minimal S3 REST transport — dependency-free (urllib + SigV4).

The reference's S3 scanner is native Rust over the S3 REST API
(reference: src/connectors/scanner/s3.rs:268, persistence/backends/s3.rs).
This build takes the same stance: no boto3 — a small AWS Signature V4
client implementing exactly the operations the connectors need
(ListObjectsV2, GetObject, PutObject, DeleteObject). Works against AWS,
MinIO, DigitalOcean Spaces, Wasabi, or any S3-compatible endpoint
(path-style supported).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any


class AwsS3Settings:
    """S3 connection settings (reference: internals/_io_helpers.py:17
    AwsS3Settings — same constructor surface)."""

    def __init__(
        self,
        *,
        bucket_name=None,
        access_key=None,
        secret_access_key=None,
        with_path_style=False,
        region=None,
        endpoint=None,
        session_token=None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.session_token = session_token
        self.with_path_style = with_path_style
        self.region_explicit = region is not None
        self.region = region or "us-east-1"
        self.endpoint = endpoint

    def with_bucket(self, bucket: str | None) -> "AwsS3Settings":
        """Copy with the path-derived bucket resolved — callers' settings
        objects are never mutated and stay reusable across buckets."""
        out = AwsS3Settings(
            bucket_name=bucket or self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region if self.region_explicit else None,
            endpoint=self.endpoint,
            session_token=self.session_token,
        )
        return out

    @classmethod
    def new_from_path(cls, s3_path: str) -> "AwsS3Settings":
        bucket = s3_path.removeprefix("s3://").split("/", 1)[0]
        return cls(bucket_name=bucket)


_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass
class S3Object:
    key: str
    etag: str
    size: int
    last_modified: str
    owner: str | None = None


class S3Client:
    """SigV4-signed HTTP client for one bucket."""

    def __init__(self, settings: AwsS3Settings, opener=None):
        if settings.bucket_name is None:
            raise ValueError("S3 settings need bucket_name")
        self.s = settings
        # opener injection point for tests (urllib-compatible .open)
        self._opener = opener or urllib.request.build_opener()

    # -- endpoint shaping --------------------------------------------------
    def _base(self) -> tuple[str, str, str]:
        """(scheme://authority, host header value, path prefix)"""
        s = self.s
        if s.endpoint:
            ep = s.endpoint
            if "://" not in ep:
                ep = "https://" + ep
            parsed = urllib.parse.urlsplit(ep)
            if s.with_path_style:
                return (
                    f"{parsed.scheme}://{parsed.netloc}",
                    parsed.netloc,
                    f"/{s.bucket_name}",
                )
            host = f"{s.bucket_name}.{parsed.netloc}"
            return f"{parsed.scheme}://{host}", host, ""
        host = f"{s.bucket_name}.s3.{s.region}.amazonaws.com"
        return f"https://{host}", host, ""

    # -- SigV4 -------------------------------------------------------------
    def _sign(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        host: str,
        payload_hash: str,
        now: datetime.datetime | None = None,
        extra_headers: dict[str, str] | None = None,
    ) -> dict[str, str]:
        s = self.s
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        if extra_headers:
            headers.update(
                {k.lower(): v for k, v in extra_headers.items()}
            )
        if s.session_token:
            headers["x-amz-security-token"] = s.session_token
        if not s.access_key:
            # anonymous access (public buckets / unauthenticated MinIO)
            return {k: v for k, v in headers.items() if k != "host"}
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items())
        )
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in sorted(headers)
        )
        # `path` arrives already percent-encoded (see _request) — signing
        # must use it verbatim or keys needing encoding 403-mismatch
        canonical_request = "\n".join(
            [
                method,
                path,
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{s.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k_date = _hmac(("AWS4" + s.secret_access_key).encode(), datestamp)
        k_region = _hmac(k_date, s.region)
        k_service = _hmac(k_region, "s3")
        k_signing = _hmac(k_service, "aws4_request")
        signature = hmac.new(
            k_signing, string_to_sign.encode(), hashlib.sha256
        ).hexdigest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={s.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return {k: v for k, v in headers.items() if k != "host"}

    def _request(
        self,
        method: str,
        key: str = "",
        query: dict[str, str] | None = None,
        body: bytes | None = None,
        extra_headers: dict[str, str] | None = None,
    ):
        base, host, prefix = self._base()
        query = query or {}
        path = prefix + "/" + urllib.parse.quote(key, safe="/")
        payload_hash = (
            hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
        )
        headers = self._sign(
            method, path, query, host, payload_hash,
            extra_headers=extra_headers,
        )
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = base + path + (f"?{qs}" if qs else "")
        req = urllib.request.Request(
            url, data=body, method=method, headers=headers
        )
        return self._opener.open(req, timeout=60)

    # -- operations --------------------------------------------------------
    def list_objects(self, prefix: str = "") -> list[S3Object]:
        out: list[S3Object] = []
        token: str | None = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            with self._request("GET", "", query) as resp:
                tree = ET.fromstring(resp.read())
            ns = ""
            if tree.tag.startswith("{"):
                ns = tree.tag.split("}")[0] + "}"
            for item in tree.iter(f"{ns}Contents"):
                def _txt(tag, default=""):
                    el = item.find(f"{ns}{tag}")
                    return el.text if el is not None and el.text else default

                owner_el = item.find(f"{ns}Owner/{ns}ID")
                out.append(
                    S3Object(
                        key=_txt("Key"),
                        etag=_txt("ETag"),
                        size=int(_txt("Size", "0")),
                        last_modified=_txt("LastModified"),
                        owner=owner_el.text if owner_el is not None else None,
                    )
                )
            trunc = tree.find(f"{ns}IsTruncated")
            if trunc is not None and (trunc.text or "").lower() == "true":
                nxt = tree.find(f"{ns}NextContinuationToken")
                token = nxt.text if nxt is not None else None
                if not token:
                    return out
            else:
                return out

    def get_object(self, key: str) -> bytes:
        with self._request("GET", key) as resp:
            return resp.read()

    def put_object(self, key: str, data: bytes) -> None:
        with self._request("PUT", key, body=data) as resp:
            resp.read()

    def put_object_if_absent(self, key: str, data: bytes) -> None:
        """Conditional create (``If-None-Match: *``): raises
        FileExistsError when the key already exists. AWS S3 (since the
        2024 conditional-writes GA) and MinIO both honor it — the
        put-if-absent primitive Delta log commits need for
        mutually-exclusive version creation."""
        try:
            with self._request(
                "PUT", key, body=data, extra_headers={"if-none-match": "*"}
            ) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            if e.code in (409, 412):  # exists (412 AWS/MinIO, 409 GCS-compat)
                raise FileExistsError(key) from e
            raise

    def delete_object(self, key: str) -> None:
        try:
            with self._request("DELETE", key) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
