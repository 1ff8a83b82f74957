"""pw.io.gcs — Google Cloud Storage connector (reference: the S3/MinIO
object-store scanners, src/connectors/scanner/s3.rs:268 + posix_like.rs:301
— object polling with metadata diffing and deletion detection; GCS is this
environment's installed object store, google-cloud-storage).

Streaming mode polls the bucket prefix; changed objects (by generation) are
re-emitted with retraction of their previous rows, deleted objects retract.
``client`` injects a fake/emulator in tests.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.io._objstore import ObjectStoreSubject, parse_object_bytes
from pathway_tpu_torch.io.python import read as python_read

# back-compat alias: s3.py historically imported the parser from here
_parse_bytes = parse_object_bytes


class _GcsSubject(ObjectStoreSubject):
    _scheme = "gcs"

    def __init__(self, bucket, prefix, fmt, with_metadata, mode,
                 refresh_interval=5.0, client=None):
        super().__init__(fmt, with_metadata, mode, refresh_interval)
        self.bucket_name = bucket
        self.prefix = prefix
        self._client = client

    def _gcs(self):
        if self._client is None:
            from google.cloud import storage

            self._client = storage.Client()
        return self._client

    def _list(self):
        for blob in self._gcs().list_blobs(
            self.bucket_name, prefix=self.prefix
        ):
            gen = getattr(blob, "generation", None) or getattr(
                blob, "updated", None
            )
            yield blob.name, gen, {}

    def _get(self, name: str) -> bytes:
        return self._gcs().bucket(self.bucket_name).blob(name).download_as_bytes()

    def _uri(self, name: str) -> str:
        return f"gs://{self.bucket_name}/{name}"


def read(
    bucket: str,
    prefix: str = "",
    *,
    format: str = "jsonlines",
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 5.0,
    client=None,
    name: str | None = None,
    **kwargs,
):
    if schema is None:
        if format in ("plaintext", "plaintext_by_object", "plaintext_by_file"):
            cols: dict[str, Any] = {"data": dt.STR}
        elif format == "binary":
            cols = {"data": dt.BYTES}
        else:
            raise ValueError(
                "pw.io.gcs.read requires schema= for structured formats"
            )
        if with_metadata:
            cols["_metadata"] = dt.JSON
        schema = schema_from_types(**cols)
    subject = _GcsSubject(
        bucket, prefix, format, with_metadata, mode,
        refresh_interval=refresh_interval, client=client,
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"gcs://{bucket}/{prefix}",
    )


def write(table, bucket: str, prefix: str, *, format: str = "jsonlines",
          client=None, name: str | None = None, **kwargs) -> None:
    """Streams output batches as sequential objects under `prefix`
    (reference: object-store writers emit one object per commit)."""
    cols = table.column_names()
    state = {"client": client, "seq": 0, "buf": []}

    def _client():
        if state["client"] is None:
            from google.cloud import storage

            state["client"] = storage.Client()
        return state["client"]

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
        blob = _client().bucket(bucket).blob(
            f"{prefix.rstrip('/')}/{state['seq']:08d}.jsonl"
        )
        state["seq"] += 1
        blob.upload_from_string(data)

    def on_end():
        on_time_end(None)

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change,
            on_time_end=on_time_end, on_end=on_end,
        )

    G.add_operator([table], [], lower, "gcs_write", is_output=True)
