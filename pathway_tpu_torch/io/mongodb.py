"""pw.io.mongodb — MongoDB sink (reference: python/pathway/io/mongodb
over the native MongoWriter, src/connectors/data_storage.rs:2187, BSON
payloads data_format.rs:1982).

Redesigned transport: no pymongo — a dependency-free OP_MSG client
(`pathway_tpu_torch/io/_mongo.py`) inserts the documents the existing Bson
formatter shape defines (row fields + ``time`` + ``diff``).
"""

from __future__ import annotations

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._formats import _plain
from pathway_tpu_torch.io._mongo import MongoConnection

__all__ = ["write"]


def write(
    table,
    *,
    connection_string: str,
    database: str,
    collection: str,
    max_batch_size: int | None = None,
    _connection=None,
) -> None:
    """Write the table's update stream into a MongoDB collection
    (reference: io/mongodb/__init__.py:14 — docs carry ``time`` and
    ``diff`` fields; batches bounded by max_batch_size)."""
    cols = table.column_names()
    state = {"conn": _connection, "buf": []}

    def _conn():
        if state["conn"] is None:
            state["conn"] = MongoConnection(connection_string)
        return state["conn"]

    def _flush():
        if not state["buf"]:
            return
        docs = state["buf"]
        state["buf"] = []
        _conn().insert_many(database, collection, docs)

    def on_change(key, row, time_, diff):
        doc = {c: _plain(v) for c, v in zip(cols, row)}
        doc["time"] = time_
        doc["diff"] = diff
        state["buf"].append(doc)
        if max_batch_size is not None and len(state["buf"]) >= max_batch_size:
            _flush()

    def on_time_end(time_):
        _flush()

    def on_end():
        _flush()
        if state["conn"] is not None:
            state["conn"].close()
            state["conn"] = None

    def lower(ctx):
        ctx.scope.output(
            ctx.engine_table(table), on_change=on_change,
            on_time_end=on_time_end, on_end=on_end,
        )

    G.add_operator([table], [], lower, "mongodb_write", is_output=True)
