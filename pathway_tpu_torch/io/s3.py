"""pw.io.s3 — Amazon S3 / S3-compatible object-store connector
(reference: python/pathway/io/s3 over the native scanner
src/connectors/scanner/s3.rs:268).

Redesigned transport: no boto3 — a dependency-free SigV4 REST client
(`pathway_tpu_torch/io/_s3.py`) drives the same object-polling scanner the GCS
connector uses (metadata diffing by ETag, deletion detection,
retraction-correct re-reads). DigitalOcean Spaces and Wasabi are the
same protocol with preset endpoints (reference: io/s3/__init__.py:304,
:435).
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.io._objstore import ObjectStoreSubject
from pathway_tpu_torch.io._s3 import AwsS3Settings, S3Client
from pathway_tpu_torch.io.python import read as python_read

__all__ = [
    "AwsS3Settings",
    "read",
    "write",
    "read_from_digital_ocean",
    "read_from_wasabi",
]


def _split_path(path: str) -> tuple[str | None, str]:
    """s3://bucket/prefix -> (bucket, prefix); bare prefix -> (None, path)."""
    if path.startswith("s3://"):
        rest = path.removeprefix("s3://")
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    return None, path


class _S3Subject(ObjectStoreSubject):
    _scheme = "s3"

    def __init__(self, client: S3Client, bucket, prefix, fmt, with_metadata,
                 mode, refresh_interval=5.0):
        super().__init__(fmt, with_metadata, mode, refresh_interval)
        self.client = client
        self.bucket_name = bucket
        self.prefix = prefix

    def _list(self):
        # modification-time order, matching the reference scanner's
        # "smaller modification time first" contract (io/s3:112)
        objs = sorted(
            self.client.list_objects(self.prefix),
            key=lambda o: o.last_modified,
        )
        for obj in objs:
            extras = {"modified_at": obj.last_modified}
            if obj.owner:
                extras["owner"] = obj.owner
            yield obj.key, (obj.etag, obj.last_modified), extras

    def _get(self, name: str) -> bytes:
        return self.client.get_object(name)

    def _uri(self, name: str) -> str:
        return f"s3://{self.bucket_name}/{name}"


def _default_schema(format: str, with_metadata: bool):
    if format in ("plaintext", "plaintext_by_object", "plaintext_by_file"):
        cols: dict[str, Any] = {"data": dt.STR}
    elif format == "binary":
        cols = {"data": dt.BYTES}
    else:
        raise ValueError("pw.io.s3.read requires schema= for structured formats")
    if with_metadata:
        cols["_metadata"] = dt.JSON
    return schema_from_types(**cols)


def read(
    path: str,
    format: str = "jsonlines",
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 5.0,
    name: str | None = None,
    _opener=None,
    **kwargs,
):
    """Read a table from object(s) under an S3 path prefix (reference:
    io/s3/__init__.py:94 — csv/json/jsonlines/plaintext/
    plaintext_by_object/binary formats, streaming object polling)."""
    bucket, prefix = _split_path(path)
    # path-derived bucket wins; the caller's settings are copied, never
    # mutated, so one settings object is reusable across buckets
    settings = (aws_s3_settings or AwsS3Settings()).with_bucket(bucket)
    client = S3Client(settings, opener=_opener)
    if schema is None:
        schema = _default_schema(format, with_metadata)
    subject = _S3Subject(
        client, settings.bucket_name, prefix, format, with_metadata, mode,
        refresh_interval=refresh_interval,
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"s3://{settings.bucket_name}/{prefix}",
    )


def _preset_endpoint(settings: AwsS3Settings, template: str, provider: str):
    if settings.endpoint is not None:
        return settings
    if not settings.region_explicit:
        raise ValueError(
            f"{provider} settings need an explicit region= (e.g. "
            f"{'nyc3' if 'digitalocean' in template else 'us-west-1'}) "
            "to derive the endpoint"
        )
    out = settings.with_bucket(None)
    out.endpoint = template.format(region=settings.region)
    return out


def read_from_digital_ocean(
    path: str,
    do_s3_settings: AwsS3Settings,
    format: str = "jsonlines",
    **kwargs,
):
    """DigitalOcean Spaces: same REST protocol, Spaces endpoint
    (reference: io/s3/__init__.py:304)."""
    settings = _preset_endpoint(
        do_s3_settings,
        "https://{region}.digitaloceanspaces.com",
        "DigitalOcean Spaces",
    )
    return read(path, format, aws_s3_settings=settings, **kwargs)


def read_from_wasabi(
    path: str,
    wasabi_s3_settings: AwsS3Settings,
    format: str = "jsonlines",
    **kwargs,
):
    """Wasabi: same REST protocol, Wasabi endpoint (reference:
    io/s3/__init__.py:435)."""
    settings = _preset_endpoint(
        wasabi_s3_settings,
        "https://s3.{region}.wasabisys.com",
        "Wasabi",
    )
    return read(path, format, aws_s3_settings=settings, **kwargs)


def write(
    table,
    path: str,
    *,
    format: str = "jsonlines",
    aws_s3_settings: AwsS3Settings | None = None,
    name: str | None = None,
    _opener=None,
    **kwargs,
) -> None:
    """Stream output batches as sequential objects under the prefix (one
    object per non-empty commit, like the object-store writers)."""
    bucket, prefix = _split_path(path)
    settings = (aws_s3_settings or AwsS3Settings()).with_bucket(bucket)
    client = S3Client(settings, opener=_opener)
    cols = table.column_names()
    state = {"seq": 0, "buf": []}

    def on_change(key, row, time_, diff):
        payload = dict(zip(cols, row))
        payload["time"] = time_
        payload["diff"] = diff
        state["buf"].append(_json.dumps(payload, default=str))

    def on_time_end(time_):
        if not state["buf"]:
            return
        data = ("\n".join(state["buf"]) + "\n").encode()
        state["buf"] = []
        client.put_object(
            f"{prefix.rstrip('/')}/{state['seq']:08d}.jsonl", data
        )
        state["seq"] += 1

    def on_end():
        on_time_end(None)

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change,
            on_time_end=on_time_end, on_end=on_end,
        )

    G.add_operator([table], [], lower, "s3_write", is_output=True)
