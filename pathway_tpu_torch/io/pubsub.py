"""pw.io.pubsub — Google Pub/Sub sink (reference:
python/pathway/io/pubsub — one message per change of a single
binary-column table, with pathway_time/pathway_diff attributes).

Transport: accepts EITHER a pubsub_v1.PublisherClient-compatible object
(duck-typed: ``topic_path`` + ``publish`` returning a future) — the
reference's surface — or ``credentials=`` (installed google-auth) to
drive the Pub/Sub REST API directly over urllib (topics:publish with
base64 payloads), so the connector works without the pubsub client lib.
"""

from __future__ import annotations

import base64
import json as _json
import urllib.request

from pathway_tpu_torch.internals.parse_graph import G

__all__ = ["write", "RestPublisher"]


class RestPublisher:
    """PublisherClient-shaped adapter over the Pub/Sub REST API."""

    def __init__(self, credentials, endpoint=None, opener=None):
        self.credentials = credentials
        self.endpoint = (
            endpoint or "https://pubsub.googleapis.com/v1"
        ).rstrip("/")
        self._opener = opener or urllib.request.build_opener()

    def topic_path(self, project_id: str, topic_id: str) -> str:
        return f"projects/{project_id}/topics/{topic_id}"

    def _token(self) -> str:
        from pathway_tpu_torch.io._gauth import bearer_token

        return bearer_token(self.credentials)

    def publish(self, topic_path: str, data: bytes, **attributes):
        """Future-shaped like PublisherClient.publish: transport errors
        are captured and re-raised from result(), so the sink's
        log-and-continue handling in on_time_end applies to the REST
        adapter too (a raise here would kill the run from on_change)."""
        error: Exception | None = None
        payload: dict = {}
        try:
            body = _json.dumps(
                {
                    "messages": [
                        {
                            "data": base64.b64encode(data).decode(),
                            "attributes": {
                                k: str(v) for k, v in attributes.items()
                            },
                        }
                    ]
                }
            ).encode()
            req = urllib.request.Request(
                f"{self.endpoint}/{topic_path}:publish",
                data=body,
                method="POST",
                headers={
                    "Content-Type": "application/json",
                    "Authorization": f"Bearer {self._token()}",
                },
            )
            with self._opener.open(req, timeout=60) as resp:
                payload = _json.loads(resp.read() or b"{}")
        except Exception as exc:
            error = exc

        class _Done:
            def result(self_inner, timeout=None):
                if error is not None:
                    raise error
                return (payload.get("messageIds") or [None])[0]

        return _Done()


def write(table, publisher, project_id: str, topic_id: str) -> None:
    """Publish the table's change stream to a Pub/Sub topic (reference:
    io/pubsub/__init__.py:49 — the table must have exactly ONE binary
    column; messages carry pathway_time/pathway_diff attributes)."""
    cols = table.column_names()
    if len(cols) != 1:
        raise ValueError(f"Unexpected number of columns: {len(cols)}")
    topic_path = publisher.topic_path(project_id, topic_id)
    futures: list = []

    def on_change(key, row, time_, diff):
        data = row[0]
        if not isinstance(data, bytes):
            raise ValueError(
                f"Unexpected value type. Expected bytes, got {type(data)}"
            )
        futures.append(
            publisher.publish(
                topic_path,
                data,
                pathway_time=str(time_),
                pathway_diff=str(1 if diff > 0 else -1),
            )
        )

    def on_time_end(time_):
        import logging

        for f in futures:
            try:
                f.result()
            except Exception:
                logging.exception("Failed to publish message")
        futures.clear()

    def on_end():
        on_time_end(None)

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change,
            on_time_end=on_time_end, on_end=on_end,
        )

    G.add_operator([table], [], lower, "pubsub_write", is_output=True)
