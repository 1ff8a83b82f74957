"""pw.io.postgres — PostgreSQL sink (reference: python/pathway/io/postgres
over the native PsqlWriter, src/connectors/data_storage.rs:1072, with the
updates/snapshot formatters data_format.rs:1632/1691).

Redesigned transport: no psycopg2 — a dependency-free wire-protocol (v3)
client (`pathway_tpu_torch/io/_pg.py`) executes the statements produced by the
existing Psql formatters (io/_formats.py). ``write`` streams the update
log (INSERT rows carrying time/diff); ``write_snapshot`` maintains the
current state via upsert-on-primary-key / DELETE.
"""

from __future__ import annotations

from typing import Sequence

from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.io._formats import PsqlSnapshotFormatter, PsqlUpdatesFormatter
from pathway_tpu_torch.io._pg import PgConnection

__all__ = ["write", "write_snapshot"]


def _writer(table, postgres_settings, formatter, op_name, max_batch_size,
            _connection):
    cols = table.column_names()
    state = {"conn": _connection, "buf": []}

    def _conn():
        if state["conn"] is None:
            state["conn"] = PgConnection(**postgres_settings)
        return state["conn"]

    def _flush():
        if not state["buf"]:
            return
        stmts = "".join(state["buf"])
        state["buf"] = []
        _conn().execute("BEGIN;\n" + stmts + "COMMIT;")

    def on_change(key, row, time_, diff):
        ctx = formatter.format(key, list(row), time_, diff)
        for payload in ctx.payloads:
            state["buf"].append(payload.decode())
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

    G.add_operator([table], [], lower, op_name, is_output=True)


def write(
    table,
    postgres_settings: dict,
    table_name: str,
    max_batch_size: int | None = None,
    *,
    _connection=None,
) -> None:
    """Stream the table's update log into a Postgres table (reference:
    io/postgres/__init__.py:18 — target table needs integer ``time`` and
    ``diff`` columns)."""
    _writer(
        table,
        postgres_settings,
        PsqlUpdatesFormatter(table_name, table.column_names()),
        "postgres_write",
        max_batch_size,
        _connection,
    )


def write_snapshot(
    table,
    postgres_settings: dict,
    table_name: str,
    primary_key: Sequence[str],
    max_batch_size: int | None = None,
    *,
    _connection=None,
) -> None:
    """Maintain the CURRENT snapshot of the table in Postgres (reference:
    io/postgres/__init__.py:113 — upsert on the primary key, DELETE on
    retraction)."""
    _writer(
        table,
        postgres_settings,
        PsqlSnapshotFormatter(
            table_name, list(primary_key), table.column_names()
        ),
        "postgres_write_snapshot",
        max_batch_size,
        _connection,
    )
