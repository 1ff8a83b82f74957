"""pw.io.debezium — CDC message parsing (reference: python/pathway/io/
debezium + native DebeziumMessageParser, data_format.rs:1056 with
MongoDB and Postgres dialects :1051).

The parser logic is real and pure: Debezium envelopes ({'payload':
{'before', 'after', 'op'}}) become upserts/deletions. Transport is Kafka
(gated on a client lib) or any jsonlines stream of envelopes for testing.
"""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def parse_debezium_message(message: str | bytes | dict, cols, pkeys):
    """-> list of ('upsert'|'remove', values_dict, key). Handles both the
    Postgres dialect (before/after/op) and the MongoDB dialect (stringified
    'after' payload) — reference data_format.rs:1051-1200."""
    if isinstance(message, (str, bytes)):
        message = _json.loads(message)
    payload = message.get("payload", message)
    op = payload.get("op", "r")
    after = payload.get("after")
    before = payload.get("before")
    if isinstance(after, str):  # MongoDB dialect stringifies the document
        after = _json.loads(after)
    if isinstance(before, str):
        before = _json.loads(before)

    def key_of(values):
        if pkeys:
            return ref_scalar(*(values.get(c) for c in pkeys))
        return ref_scalar(*(values.get(c) for c in cols))

    out = []
    if op in ("c", "r", "u") and after is not None:
        values = {c: after.get(c) for c in cols}
        if op == "u" and before is not None:
            old = {c: before.get(c) for c in cols}
            out.append(("remove", old, key_of(old)))
        out.append(("upsert", values, key_of(values)))
    elif op == "d" and before is not None:
        old = {c: before.get(c) for c in cols}
        out.append(("remove", old, key_of(old)))
    return out


class _DebeziumFileSubject(ConnectorSubject):
    """Replay a jsonlines file of Debezium envelopes (testing transport)."""

    def __init__(self, path, schema):
        super().__init__()
        self.path = path
        self.schema = schema

    def run(self):
        cols = self.schema.column_names()
        pkeys = self.schema.primary_key_columns()
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                for kind, values, key in parse_debezium_message(
                    line, cols, pkeys
                ):
                    if kind == "upsert":
                        self._upsert(key, values)
                    else:
                        self._remove(key, values)
        self.commit()


def read(
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    *,
    schema: type[Schema],
    db_type: str = "postgres",
    autocommit_duration_ms: int | None = 1500,
    input_file: str | None = None,
    name: str | None = None,
    **kwargs,
):
    """Kafka transport requires `confluent_kafka`; `input_file` replays a
    jsonlines capture instead (test/dev path)."""
    if input_file is not None:
        subject = _DebeziumFileSubject(input_file, schema)
        return python_read(
            subject,
            schema=schema,
            autocommit_duration_ms=autocommit_duration_ms,
            name=name or f"debezium:{input_file}",
        )
    try:
        import confluent_kafka  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "pw.io.debezium.read over Kafka requires `confluent-kafka`; "
            "for files pass input_file="
        ) from e
    from pathway_tpu_torch.io.kafka import _KafkaSubject

    subject = _KafkaSubject(
        rdkafka_settings, [topic_name], message_parser=(
            lambda subj, raw: [
                (subj._upsert(key, values) if kind == "upsert" else subj._remove(key, values))
                for kind, values, key in parse_debezium_message(
                    raw, schema.column_names(), schema.primary_key_columns()
                )
            ]
        ),
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"debezium:{topic_name}",
    )
