"""pw.io — IO connector surface (reference: python/pathway/io/, §2.3 of
SURVEY: one module per system, each constructing engine data storage).

Connectors with external service dependencies (kafka, postgres, s3, ...)
are stubbed with informative errors until their native backends land.
"""

from __future__ import annotations

from pathway_tpu_torch.io import csv, fs, http, jsonlines, plaintext, python
from pathway_tpu_torch.io._connector import SupervisorPolicy
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = [
    "SupervisorPolicy",
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gcs",
    "gdrive",
    "http",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
]

_LAZY_CONNECTORS = {
    "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch",
    "gcs", "gdrive", "kafka", "logstash", "minio", "mongodb", "nats", "null",
    "postgres", "pubsub", "pyfilesystem", "redpanda", "s3", "s3_csv",
    "slack", "sqlite",
}


def __getattr__(name):
    if name in _LAZY_CONNECTORS:
        import importlib

        mod = importlib.import_module(f"pathway_tpu_torch.io.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(name)


class OnChangeCallback:  # typing alias used in reference signatures
    pass
