"""pw.io.kafka — Kafka connector (reference: python/pathway/io/kafka +
native KafkaReader/KafkaWriter, data_storage.rs:692/:1250). Full parameter
surface; transport gated on `confluent_kafka` (partitioned reads map to
per-worker consumers in the reference — here one consumer drives the
engine's commit cadence)."""

from __future__ import annotations

import json as _json
from typing import Any

from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def _require_kafka():
    try:
        import confluent_kafka

        return confluent_kafka
    except ImportError as e:
        raise ImportError(
            "pw.io.kafka requires the `confluent-kafka` package"
        ) from e


class _KafkaSubject(ConnectorSubject):
    # multi-process runs: every rank consumes, each owning the topic
    # partitions that hash to it (reference: per-worker partitioned
    # consumption, data_storage.rs:692)
    _distributed_partitioned = True

    def __init__(self, rdkafka_settings, topics, *, format="json",
                 schema=None, message_parser=None):
        super().__init__()
        self.settings = dict(rdkafka_settings or {})
        self.topics = list(topics)
        self.format = format
        self.schema = schema
        self.message_parser = message_parser
        self._stop = False
        self._offsets: dict = {}

    # commit cadence: the connector protocol journals a stateful subject's
    # rows only at its commit() boundaries (io/_connector.py), so offsets
    # must be committed regularly — on idle polls and every N messages
    _COMMIT_EVERY = 1000

    def _owned_partitions(self, ck, consumer):
        """Partition p of topic t belongs to rank p % processes —
        deterministic, no rebalance coordination. Topics that do not
        exist yet (metadata error / empty partition set) resolve on a
        later refresh, matching subscribe()'s metadata-refresh pickup."""
        from pathway_tpu_torch.internals.config import get_pathway_config

        c = get_pathway_config()
        owned = []
        for topic in self.topics:
            meta = consumer.list_topics(topic, timeout=10)
            entry = meta.topics.get(topic)
            if entry is None or entry.error is not None:
                continue
            for p in entry.partitions:
                if p % c.processes == c.process_id:
                    owned.append(ck.TopicPartition(topic, p))
        return owned

    def _subscribe(self, ck, consumer) -> None:
        from pathway_tpu_torch.internals.config import get_pathway_config

        if get_pathway_config().processes <= 1:
            consumer.subscribe(self.topics)
            self._manual_assign = False
            return
        self._manual_assign = True
        self._assigned = self._owned_partitions(ck, consumer)
        consumer.assign(self._assigned)

    def _maybe_reassign(self, ck, consumer) -> None:
        """Pick up late-created topics and added partitions (refreshed on
        idle polls; subscribe() consumers get this from rebalances)."""
        if not self._manual_assign:
            return
        owned = self._owned_partitions(ck, consumer)
        current = {(tp.topic, tp.partition) for tp in self._assigned}
        fresh = {(tp.topic, tp.partition) for tp in owned}
        if fresh != current:
            self._assigned = owned
            consumer.assign(owned)

    _REASSIGN_EVERY_IDLE = 60  # idle polls (~30 s) between metadata checks

    def run(self):
        ck = _require_kafka()
        consumer = ck.Consumer(self.settings)
        self._subscribe(ck, consumer)
        idle = 0
        since_commit = 0
        try:
            while not self._stop:
                msg = consumer.poll(0.5)
                if msg is None or msg.error():
                    if since_commit:
                        self.commit()
                        since_commit = 0
                    idle += 1
                    if idle >= self._REASSIGN_EVERY_IDLE:
                        idle = 0
                        self._maybe_reassign(ck, consumer)
                    continue
                idle = 0
                raw = msg.value()
                self._offsets[(msg.topic(), msg.partition())] = msg.offset()
                if self.message_parser is not None:
                    self.message_parser(self, raw)
                elif self.format == "json":
                    self.next_json(_json.loads(raw))
                elif self.format == "raw":
                    self.next_bytes(raw)
                else:
                    self.next_str(
                        raw.decode() if isinstance(raw, bytes) else raw
                    )
                since_commit += 1
                if since_commit >= self._COMMIT_EVERY:
                    self.commit()
                    since_commit = 0
        finally:
            if since_commit:
                self.commit()
            consumer.close()

    def on_stop(self):
        self._stop = True

    def snapshot_state(self):
        return {"offsets": dict(self._offsets)}

    def seek(self, state):
        self._offsets = dict(state.get("offsets", {}))


def read(
    rdkafka_settings: dict,
    topic: str | list[str] | None = None,
    *,
    schema: type[Schema] | None = None,
    format: str = "json",
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict | None = None,
    parallel_readers: int | None = None,
    topic_names: list[str] | None = None,
    name: str | None = None,
    **kwargs,
):
    _require_kafka()
    topics = topic_names or ([topic] if isinstance(topic, str) else list(topic or []))
    subject = _KafkaSubject(
        rdkafka_settings, topics, format=format, schema=schema
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"kafka:{','.join(topics)}",
    )


def write(
    table,
    rdkafka_settings: dict,
    topic_name: str,
    *,
    format: str = "json",
    name: str | None = None,
    **kwargs,
) -> None:
    ck = _require_kafka()
    producer = ck.Producer(rdkafka_settings)
    cols = table.column_names()

    def on_change(key, row, time_, diff):
        payload = dict(zip(cols, row))
        payload["time"] = time_
        payload["diff"] = diff
        producer.produce(
            topic_name, _json.dumps(payload, default=str).encode()
        )
        producer.poll(0)

    def on_end():
        producer.flush()

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change, on_end=on_end
        )

    G.add_operator([table], [], lower, "kafka_write", is_output=True)
