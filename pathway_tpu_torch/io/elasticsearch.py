"""pw.io.elasticsearch — Elasticsearch sink (reference:
python/pathway/io/elasticsearch over the native ElasticSearchWriter,
src/connectors/data_storage.rs:1328).

Redesigned transport: no elasticsearch client package — the writer
speaks the bulk REST API directly (``POST {host}/{index}/_bulk`` with
ndjson ``{"index": {}}`` action lines, exactly the body the reference
builds at data_storage.rs:1345), authenticated via basic/apikey/bearer
headers. One bulk request per non-empty commit, plus max_batch_size
early flushes like the reference.
"""

from __future__ import annotations

import base64
import json as _json
import urllib.request

from pathway_tpu_torch.internals.parse_graph import G

__all__ = ["ElasticSearchAuth", "write"]


class ElasticSearchAuth:
    """Credential holder (reference: io/elasticsearch/__init__.py:12 —
    same three constructors)."""

    def __init__(self, kind: str, **params):
        self.kind = kind
        self.params = params

    @classmethod
    def apikey(cls, apikey_id, apikey):
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)

    @classmethod
    def basic(cls, username, password):
        return cls("basic", username=username, password=password)

    @classmethod
    def bearer(cls, bearer):
        return cls("bearer", bearer=bearer)

    def header(self) -> str:
        if self.kind == "basic":
            raw = f"{self.params['username']}:{self.params['password']}"
            return "Basic " + base64.b64encode(raw.encode()).decode()
        if self.kind == "apikey":
            raw = f"{self.params['apikey_id']}:{self.params['apikey']}"
            return "ApiKey " + base64.b64encode(raw.encode()).decode()
        return "Bearer " + self.params["bearer"]


def write(
    table,
    host: str,
    auth: ElasticSearchAuth,
    index_name: str,
    *,
    max_batch_size: int | None = None,
    name: str | None = None,
    _opener=None,
) -> None:
    """Write a table to an Elasticsearch index (reference:
    io/elasticsearch/__init__.py:52). Each output row becomes one
    document carrying the columns plus ``time`` and ``diff``."""
    cols = table.column_names()
    opener = _opener or urllib.request.build_opener()
    state = {"buf": []}

    def _flush():
        if not state["buf"]:
            return
        body = ("\n".join(state["buf"]) + "\n").encode()
        state["buf"] = []
        url = f"{host.rstrip('/')}/{index_name}/_bulk"
        req = urllib.request.Request(
            url,
            data=body,
            method="POST",
            headers={
                "Content-Type": "application/x-ndjson",
                "Authorization": auth.header(),
            },
        )
        with opener.open(req, timeout=60) as resp:
            payload = _json.loads(resp.read() or b"{}")
        if payload.get("errors"):
            raise RuntimeError(
                f"elasticsearch bulk errors on index {index_name!r}: "
                f"{str(payload)[:500]}"
            )

    def on_change(key, row, time_, diff):
        doc = dict(zip(cols, row))
        doc["time"] = time_
        doc["diff"] = diff
        state["buf"].append('{"index": {}}')
        state["buf"].append(_json.dumps(doc, default=str))
        if max_batch_size is not None and len(state["buf"]) // 2 >= max_batch_size:
            _flush()

    def on_time_end(time_):
        _flush()

    def on_end():
        _flush()

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change,
            on_time_end=on_time_end, on_end=on_end,
        )

    G.add_operator([table], [], lower, "elasticsearch_write", is_output=True)
