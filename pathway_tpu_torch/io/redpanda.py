"""pw.io.redpanda — Kafka-protocol alias (reference:
python/pathway/io/redpanda re-exports the kafka connector)."""

from pathway_tpu_torch.io.kafka import read, write

__all__ = ["read", "write"]
